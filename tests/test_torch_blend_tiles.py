"""The id-matrix blend ``raster/blend.py::blend_tiles``: the port's CPU path
(a twin of the JAX ``lax.scan``) against the JAX function on the same
preprocessed splats and the same JAX ``bin_gaussians`` id matrix, the whole
grid and a run of tiles given by ``pix`` (the tile-sharded path's slice).
Images at atol/rtol 3e-5; the gradients of a seeded loss in every blend
input at the JAX suite's Gaussian-gradient tolerances (atol 5e-3, rtol
1e-2; the atol scaled by the field's largest |gradient| when that is
below 1). The card path (K3/K4 with a first-tile offset) is held against its
plain version in test_torch_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gs_localization_tpu.raster import binning as jbinning
from gs_localization_tpu.raster import blend as jblend
from gs_localization_tpu.raster.preprocess import preprocess as j_preprocess
from gs_localization_torch.raster import blend as tblend
from helpers import make_camera, random_scene
from torch_bridge import np_of

W, H, TS, CHUNK, MPT = 64, 48, 16, 32, 160
GRID_X, GRID_Y = W // TS, H // TS
FIELDS = ("means2d", "conic", "rgb", "opacity", "depths")


@pytest.fixture(scope="module")
def splats():
    g = random_scene(np.random.default_rng(3), 300, sh_degree=1)
    cam = make_camera(W, H)
    # jitted: eager JAX compiles every op on its first call
    prep = jax.jit(lambda g_, c: j_preprocess(g_, c, tile_size=TS))(g, cam)
    bins = jax.jit(lambda p_: jbinning.bin_gaussians(
        p_, GRID_X, GRID_Y, 1 << 13, MPT, tile_size=TS))(prep)
    assert not bool(bins.tile_overflow) and not bool(bins.overflow)
    counts = np.asarray(bins.tile_mask).sum(1)
    assert counts.max() > CHUNK and (counts == 0).sum() < counts.size
    arrays = {f: np.asarray(getattr(prep, f)) for f in FIELDS}
    rng = np.random.default_rng(4)
    w = dict(color=rng.standard_normal((GRID_X * GRID_Y, TS * TS, 3)),
             depth=rng.standard_normal((GRID_X * GRID_Y, TS * TS)),
             t=rng.standard_normal((GRID_X * GRID_Y, TS * TS)))
    return dict(gid=np.asarray(bins.tile_gid), mask=np.asarray(bins.tile_mask),
                arrays=arrays, w={k: v.astype(np.float32) for k, v in w.items()})


def _loss(out, w, lib):
    exp = jnp.exp if lib is jnp else torch.exp
    return ((out.color * w["color"]).sum() + (out.depth * w["depth"]).sum()
            + (exp(out.log_t) * w["t"]).sum())


def _jax(s, lo, hi):
    pix = None if (lo, hi) == (0, GRID_X * GRID_Y) else \
        jblend.tile_pixel_coords(GRID_X, GRID_Y, TS)[lo:hi]
    w = {k: jnp.asarray(v[lo:hi]) for k, v in s["w"].items()}

    def f(arrays):
        out = jblend.blend_tiles(jnp.asarray(s["gid"][lo:hi]),
                                 jnp.asarray(s["mask"][lo:hi]),
                                 *(arrays[k] for k in FIELDS), GRID_X, GRID_Y,
                                 TS, chunk=CHUNK, pix=pix)
        return _loss(out, w, jnp), out

    arrays = {k: jnp.asarray(v) for k, v in s["arrays"].items()}
    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(arrays)
    return out, grads


def _port(s, lo, hi):
    pix = None if (lo, hi) == (0, GRID_X * GRID_Y) else \
        tblend.tile_pixel_coords(GRID_X, GRID_Y, TS, "cpu")[lo:hi]
    arrays = {k: torch.tensor(v, requires_grad=True)
              for k, v in s["arrays"].items()}
    out = tblend.blend_tiles(torch.tensor(s["gid"][lo:hi]),
                             torch.tensor(s["mask"][lo:hi]),
                             *(arrays[k] for k in FIELDS), GRID_X, GRID_Y, TS,
                             chunk=CHUNK, pix=pix)
    w = {k: torch.tensor(v[lo:hi]) for k, v in s["w"].items()}
    _loss(out, w, torch).backward()
    return out, {k: arrays[k].grad for k in FIELDS}


@pytest.mark.parametrize("run", [(0, GRID_X * GRID_Y), (4, 9)],
                         ids=["whole_grid", "pix_run"])
def test_blend_tiles_matches_jax(splats, run):
    out_j, grads_j = _jax(splats, *run)
    out_t, grads_t = _port(splats, *run)
    for f in ("color", "depth", "log_t"):
        np.testing.assert_allclose(np_of(getattr(out_t, f)),
                                   np.asarray(getattr(out_j, f)), atol=3e-5,
                                   rtol=3e-5, err_msg=f)
    for f in FIELDS:
        gt, gj = np_of(grads_t[f]), np.asarray(grads_j[f])
        assert np.abs(gt).max() > 0, f
        # atol relative to the field's largest |gradient| where that is
        # below 1: never looser than 5e-3, as tight for a small field
        scale = float(np.abs(gj).max())
        np.testing.assert_allclose(gt, gj, atol=5e-3 * min(1.0, scale),
                                   rtol=1e-2, err_msg=f)


def test_pix_run_equals_whole_grid_rows(splats):
    """A run's blend is the whole grid's blend at those tiles."""
    whole, _ = _port(splats, 0, GRID_X * GRID_Y)
    part, _ = _port(splats, 4, 9)
    for f in ("color", "depth", "log_t"):
        torch.testing.assert_close(getattr(part, f),
                                   getattr(whole, f)[4:9], atol=0, rtol=0)


def test_blend_tiles_rejects_bad_mask_and_pix(splats):
    s = splats
    args = [torch.tensor(s["arrays"][k]) for k in FIELDS]
    gid, mask = torch.tensor(s["gid"]), torch.tensor(s["mask"])
    holed = mask.clone()
    row = int(torch.nonzero(mask.sum(1) > 2)[0])
    holed[row, 1] = False                       # a hole: not a prefix
    with pytest.raises(ValueError, match="prefix"):
        tblend.blend_tiles(gid, holed, *args, GRID_X, GRID_Y, TS, chunk=CHUNK)
    pix = tblend.tile_pixel_coords(GRID_X, GRID_Y, TS, "cpu")
    for bad in (pix[[1, 3, 5]], pix[2:5].flip(0), pix[2:5] + 1.0):
        with pytest.raises(ValueError, match="run of consecutive tiles"):
            tblend.blend_tiles(gid[:3], mask[:3], *args, GRID_X, GRID_Y, TS,
                               chunk=CHUNK, pix=bad)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tblend.blend_tiles(gid, mask, *args, GRID_X, GRID_Y, TS, chunk=48)
