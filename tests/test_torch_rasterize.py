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
    with pytest.raises(NotImplementedError, match="pregathered"):
        rasterize(tg, tcam, CFG.replace(use_stream=False))
