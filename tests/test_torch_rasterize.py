"""Port rasterize (stream layout) against the JAX package's rasterize with
its Pallas stream kernels in interpret mode: images, flags and the
Gaussian-parameter gradients; the stream blend's pack gradient against
``_make_stream_core``; ``return_n_touched`` and the sequential oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import rasterize as j_rasterize
from gs_localization_tpu.raster import stream_blend as jsb
from gs_localization_tpu.raster.oracle import render_oracle as j_oracle
from gs_localization_tpu.raster.preprocess import preprocess as j_preprocess
from gs_localization_tpu.raster.rasterize import compute_bins as j_bins
from gs_localization_torch.raster import RasterizerConfig, rasterize, render
from gs_localization_torch.raster import blend as tblend
from gs_localization_torch.raster import stream_blend as tsb
from gs_localization_torch.raster.oracle import render_oracle
from gs_localization_torch.raster.rasterize import compute_bins
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch, np_of

J_CFG = JConfig(max_pairs=1 << 14, max_render=1 << 14, fast_k=1,
                backend="pallas_interpret", pallas_chunk=64)
CFG = RasterizerConfig(max_pairs=1 << 14, max_render=1 << 14, fast_k=1,
                       pallas_chunk=64)
PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
BG = np.array([0.2, 0.1, 0.3], np.float32)


@pytest.fixture(scope="module")
def scene():
    g = random_scene(np.random.default_rng(6), 300, sh_degree=2,
                     capacity=320)
    cam = make_camera(64, 48, fov=1.0).with_delta(
        jnp.asarray([0.02, -0.01, 0.01, 0.05, 0.02, -0.1]))
    return g, cam, gaussians_to_torch(g), camera_to_torch(cam)


def test_images_and_flags_match_jax(scene):
    g, cam, tg, tcam = scene
    oj = j_rasterize(g, cam, J_CFG, bg=jnp.asarray(BG))
    with torch.no_grad():
        ot = rasterize(tg, tcam, CFG, bg=torch.tensor(BG))
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(np_of(getattr(ot, name)),
                                   np_of(getattr(oj, name)), atol=3e-5,
                                   rtol=3e-5, err_msg=name)
    for name in ("radii", "visibility", "num_rendered", "overflow",
                 "tile_overflow", "max_tile_count"):
        np.testing.assert_array_equal(np_of(getattr(ot, name)),
                                      np_of(getattr(oj, name)),
                                      err_msg=name)
    assert float(ot.alpha.max()) > 0.9


def test_gaussian_grads_match_jax(scene):
    g, cam, tg, tcam = scene
    rng = np.random.default_rng(3)
    wc = rng.standard_normal((48, 64, 3)).astype(np.float32)
    wd = rng.standard_normal((48, 64)).astype(np.float32)

    def jloss(params):
        out = j_rasterize(g.replace(**params), cam, J_CFG)
        return (jnp.sum(out.color * wc) + 0.1 * jnp.sum(out.depth * wd)
                + jnp.sum(out.alpha))

    gj = jax.grad(jloss)({f: getattr(g, f) for f in PARAMS})
    params = {f: getattr(tg, f).clone().requires_grad_() for f in PARAMS}
    out = rasterize(tg.replace(**params), tcam, CFG)
    loss = ((out.color * torch.tensor(wc)).sum()
            + 0.1 * (out.depth * torch.tensor(wd)).sum() + out.alpha.sum())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(
        {f: getattr(g, f) for f in PARAMS})), rtol=1e-5)
    for f in PARAMS:
        got = np_of(params[f].grad)
        assert np.isfinite(got).all() and np.abs(got).max() > 0, f
        # the JAX suite's Gaussian-parameter gradient tolerance
        np.testing.assert_allclose(got, np.asarray(gj[f]), atol=5e-3,
                                   rtol=1e-2, err_msg=f)


def test_offsets_precomputed_colors_and_bin_reuse(scene):
    g, cam, tg, tcam = scene
    rng = np.random.default_rng(4)
    off = (0.3 * rng.standard_normal((320, 2))).astype(np.float32)
    cols = rng.uniform(0, 1, (320, 3)).astype(np.float32)
    oj = j_rasterize(g, cam, J_CFG, means2d_offset=jnp.asarray(off),
                     colors_precomp=jnp.asarray(cols))
    bins = compute_bins(tg, tcam, CFG)
    with torch.no_grad():
        ot = rasterize(tg, tcam, CFG, means2d_offset=torch.tensor(off),
                       colors_precomp=torch.tensor(cols), bins=bins)
    np.testing.assert_allclose(np_of(ot.color), np_of(oj.color), atol=3e-5,
                               rtol=3e-5)
    d = render(tg, tcam, CFG)
    assert set(d) >= {"render", "depth", "alpha", "radii",
                      "visibility_filter", "num_rendered", "overflow"}
    with torch.no_grad():
        np.testing.assert_array_equal(np_of(d["render"]),
                                      np_of(rasterize(tg, tcam, CFG).color))


def test_refuses_what_is_not_ported(scene):
    """``return_n_touched`` is ported (it takes the id matrix, whatever
    the config's layout); ``count_touched`` refuses an id matrix it cannot
    walk in whole chunks."""
    _, _, tg, tcam = scene
    with torch.no_grad():
        out = rasterize(tg, tcam, CFG.replace(max_per_tile=128),
                        return_n_touched=True)
    assert out.n_touched.shape == (320,) and out.n_touched.dtype == \
        torch.int32
    bins = compute_bins(tg, tcam, CFG.replace(use_stream=False,
                                              max_per_tile=96))
    with pytest.raises(ValueError, match="multiple of chunk"):
        tblend.count_touched(bins.tile_gid, bins.tile_mask,
                             torch.zeros((320, 2)), torch.zeros((320, 3)),
                             torch.zeros((320,)), 320, 4, 3, 16, chunk=64)


def _pack_of(prep):
    """The (P, 12) stream pack rasterize builds from a preprocess."""
    return jnp.stack(
        [prep.means2d[:, 0], prep.means2d[:, 1], prep.conic[:, 0],
         prep.conic[:, 1], prep.conic[:, 2], prep.opacity,
         prep.valid.astype(jnp.float32), jnp.zeros_like(prep.opacity),
         prep.rgb[:, 0], prep.rgb[:, 1], prep.rgb[:, 2], prep.depths],
        axis=1)


def test_stream_pack_grad_matches_make_stream_core(scene):
    """The pack cotangent of the stream blend: the port's slot-order
    reduction of the grad stream (``blend_stream``'s backward) against the
    JAX ``_make_stream_core``, whose backward reduces it in slot order too,
    with the Pallas kernels in interpret mode."""
    g, cam, tg, tcam = scene
    pack = np.asarray(_pack_of(j_preprocess(g, cam)))
    jb = j_bins(g, cam, J_CFG)
    tb = compute_bins(tg, tcam, CFG)
    for f in ("gid_of_pos", "tstart", "walk_counts", "kept_al"):
        np.testing.assert_array_equal(np_of(getattr(tb, f)),
                                      np_of(getattr(jb, f)), err_msg=f)
    rng = np.random.default_rng(8)
    num_tiles = int(jb.tstart.shape[0])
    wc = rng.standard_normal((num_tiles, 256, 3)).astype(np.float32)
    wd = rng.standard_normal((num_tiles, 256)).astype(np.float32)
    wt = rng.standard_normal((num_tiles, 256)).astype(np.float32)

    def jloss(pk):
        out = jsb.blend_stream_pallas(pk, jb, 4, 16, 1, chunk=64,
                                      interpret=True)
        return (jnp.sum(out.color * wc) + jnp.sum(out.depth * wd)
                + jnp.sum(jnp.exp(out.log_t) * wt))

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(pack)))
    pk = torch.tensor(pack, requires_grad=True)
    out = tsb.blend_stream(pk, tb, 4, 16, chunk=64)
    loss = ((out.color * torch.tensor(wc)).sum()
            + (out.depth * torch.tensor(wd)).sum()
            + (torch.exp(out.log_t) * torch.tensor(wt)).sum())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(jloss(jnp.asarray(pack))), rtol=1e-5)
    gt = np_of(pk.grad)
    assert (gt[:, 6:8] == 0).all() and np.abs(gt).max() > 0
    # the JAX suite's Gaussian-parameter gradient tolerance
    np.testing.assert_allclose(gt, gj, atol=5e-3, rtol=1e-2)


J_NT = JConfig(max_pairs=1 << 14, max_per_tile=256, fast_k=8, chunk=32,
               backend="jnp", use_stream=False)
NT = RasterizerConfig(max_pairs=1 << 14, max_per_tile=256, fast_k=8,
                      chunk=32, pallas_chunk=32)


@pytest.mark.parametrize("which", ["scene", "small"])
def test_n_touched_matches_jax(request, which):
    """``return_n_touched``: the per-Gaussian touched-pixel counts equal
    JAX's exactly; the port's stream config is taken to the id matrix, as
    in JAX, and its images match."""
    g, cam, tg, tcam = request.getfixturevalue(which)
    oj = jax.jit(lambda g, c: j_rasterize(g, c, J_NT,
                                          return_n_touched=True))(g, cam)
    with torch.no_grad():
        ot = rasterize(tg, tcam, NT, return_n_touched=True)
        d = render(tg, tcam, NT, return_n_touched=True)
    n_t, n_j = np_of(ot.n_touched), np_of(oj.n_touched)
    assert n_t.dtype == np.int32 and n_t.shape == n_j.shape
    np.testing.assert_array_equal(n_t, n_j)
    np.testing.assert_array_equal(np_of(d["n_touched"]), n_j)
    assert n_t.max() > 0 and (n_t[~np_of(tg.live)] == 0).all()
    assert not bool(ot.tile_overflow)
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(np_of(getattr(ot, name)),
                                   np_of(getattr(oj, name)), atol=3e-5,
                                   rtol=3e-5, err_msg=name)


@pytest.mark.parametrize("respect_tile_rect", [True, False])
def test_render_oracle_matches_jax(small, respect_tile_rect):
    """The sequential oracle (a loop over depth-sorted Gaussians) against
    JAX's ``lax.scan``; and, respecting the tile rects, the tiled
    rasterizer against the oracle."""
    g, cam, tg, tcam = small
    oj = jax.jit(lambda g, c: j_oracle(
        g, c, bg=jnp.asarray(BG), respect_tile_rect=respect_tile_rect))(
            g, cam)
    with torch.no_grad():
        ot = render_oracle(tg, tcam, bg=torch.tensor(BG),
                           respect_tile_rect=respect_tile_rect)
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(np_of(getattr(ot, name)),
                                   np_of(getattr(oj, name)), atol=3e-5,
                                   rtol=3e-5, err_msg=name)
    assert float(ot.alpha.max()) > 0.9
    if respect_tile_rect:
        with torch.no_grad():
            tiled = rasterize(tg, tcam, PRE, bg=torch.tensor(BG))
        np.testing.assert_allclose(np_of(tiled.color), np_of(ot.color),
                                   atol=3e-5, rtol=3e-5)


# ---- the pregathered layout (use_stream=False: bin_gaussians + K3/K4) ------
# The JAX side takes its plain jnp blend over the same bin_gaussians lists
# (the port's K3/K4 against the Pallas kernels themselves is
# test_torch_pallas_blend.py).

J_PRE = JConfig(max_pairs=1 << 12, max_per_tile=128, fast_k=8, chunk=32,
                backend="jnp", use_stream=False)
PRE = RasterizerConfig(max_pairs=1 << 12, max_per_tile=128, fast_k=8,
                       pallas_chunk=32, use_stream=False)


@pytest.fixture(scope="module")
def small():
    # 48x32 image (6 tiles), 100 Gaussians at SH degree 1, 4 dead slots
    g = random_scene(np.random.default_rng(9), 100, sh_degree=1,
                     capacity=104)
    cam = make_camera(48, 32, fov=1.0).with_delta(
        jnp.asarray([0.01, 0.02, -0.01, 0.03, -0.02, 0.05]))
    return g, cam, gaussians_to_torch(g), camera_to_torch(cam)


def test_pregathered_images_and_flags_match_jax(small):
    g, cam, tg, tcam = small
    oj = jax.jit(lambda g, c: j_rasterize(g, c, J_PRE, bg=jnp.asarray(BG)))(
        g, cam)
    bins = compute_bins(tg, tcam, PRE)
    assert bins.tile_gid.shape == (6, 128)
    with torch.no_grad():
        ot = rasterize(tg, tcam, PRE, bg=torch.tensor(BG))
        # stream bins handed to the pregathered config are binned again
        ob = rasterize(tg, tcam, PRE, bg=torch.tensor(BG),
                       bins=compute_bins(tg, tcam, PRE.replace(
                           use_stream=True)))
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(np_of(getattr(ot, name)),
                                   np_of(getattr(oj, name)), atol=3e-5,
                                   rtol=3e-5, err_msg=name)
        np.testing.assert_array_equal(np_of(getattr(ob, name)),
                                      np_of(getattr(ot, name)))
    for name in ("radii", "visibility", "num_rendered", "overflow",
                 "tile_overflow", "max_tile_count"):
        np.testing.assert_array_equal(np_of(getattr(ot, name)),
                                      np_of(getattr(oj, name)),
                                      err_msg=name)
    assert int(ot.max_tile_count) > 32      # some tile walks 2+ chunks
    assert float(ot.alpha.max()) > 0.9


def test_pregathered_grads_match_jax(small):
    """Gaussian-parameter and means2d_offset gradients (the latter feed
    densification) through bin_gaussians, the pack[tile_gid] gather and
    K3/K4."""
    g, cam, tg, tcam = small
    rng = np.random.default_rng(3)
    wc = rng.standard_normal((32, 48, 3)).astype(np.float32)
    wd = rng.standard_normal((32, 48)).astype(np.float32)
    off0 = np.zeros((104, 2), np.float32)

    def jloss(params, off):
        out = j_rasterize(g.replace(**params), cam, J_PRE,
                          means2d_offset=off)
        return (jnp.sum(out.color * wc) + 0.1 * jnp.sum(out.depth * wd)
                + jnp.sum(out.alpha))

    gj, goff_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {f: getattr(g, f) for f in PARAMS}, jnp.asarray(off0))
    params = {f: getattr(tg, f).clone().requires_grad_() for f in PARAMS}
    off = torch.tensor(off0, requires_grad=True)
    out = rasterize(tg.replace(**params), tcam, PRE, means2d_offset=off)
    loss = ((out.color * torch.tensor(wc)).sum()
            + 0.1 * (out.depth * torch.tensor(wd)).sum() + out.alpha.sum())
    loss.backward()
    for f in PARAMS:
        got = np_of(params[f].grad)
        assert np.isfinite(got).all() and np.abs(got).max() > 0, f
        # the JAX suite's Gaussian-parameter gradient tolerance
        np.testing.assert_allclose(got, np.asarray(gj[f]), atol=5e-3,
                                   rtol=1e-2, err_msg=f)
    goff = np_of(off.grad)
    assert np.abs(goff).max() > 0 and (goff[100:] == 0).all()
    np.testing.assert_allclose(goff, np.asarray(goff_j), atol=5e-3,
                               rtol=1e-2)
