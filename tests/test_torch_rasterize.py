"""Port rasterize (stream layout) against the JAX package's rasterize with
its Pallas stream kernels in interpret mode: images, flags and the
Gaussian-parameter gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import rasterize as j_rasterize
from gs_localization_torch.raster import RasterizerConfig, rasterize, render
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
    _, _, tg, tcam = scene
    with pytest.raises(NotImplementedError, match="return_n_touched"):
        rasterize(tg, tcam, CFG, return_n_touched=True)
    with pytest.raises(NotImplementedError, match="return_n_touched"):
        rasterize(tg, tcam, CFG.replace(use_stream=False),
                  return_n_touched=True)


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
