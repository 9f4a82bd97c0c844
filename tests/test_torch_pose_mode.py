"""Port pose mode against the JAX package's stream pose mode (Pallas in
interpret mode) on the same seeded scene: the pair pack, the renders and the
camera-tangent gradient."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gs_localization_torch as gsl
from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster.pose_mode import (
    build_pair_pack as j_build_pair_pack,
    build_stream_pair_pack as j_build_pack,
    render_pose_mode as j_render_pose_mode)
from gs_localization_torch.loc import TrackingConfig, refine_pose
from gs_localization_torch.raster import RasterizerConfig, rasterize
from gs_localization_torch.raster.pose_mode import (
    PairPack, StreamPairPack, build_pair_pack, build_stream_pair_pack,
    render_pose_mode)
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch, np_of

J_CFG = JConfig(max_pairs=1 << 14, max_per_tile=256, max_render=1 << 14,
                backend="pallas_interpret", pallas_chunk=128)
CFG = RasterizerConfig(max_pairs=1 << 14, max_per_tile=256,
                       max_render=1 << 14, pallas_chunk=128)
PACK_INTS = ("tstart", "walk_counts", "kept_al", "overflow")


@pytest.fixture(scope="module")
def scene():
    g = random_scene(np.random.default_rng(0), 500)
    cam = make_camera(96, 64, fov=1.0)
    return g, cam, gaussians_to_torch(g), camera_to_torch(cam)


@pytest.fixture(scope="module")
def packs(scene):
    g, cam, tg, tcam = scene
    return j_build_pack(g, cam, J_CFG), build_stream_pair_pack(tg, tcam, CFG)


def test_stream_pair_pack_matches_jax(packs):
    jp, tp = packs
    assert isinstance(tp, StreamPairPack) and tp.align == CFG.pallas_chunk
    assert not bool(tp.overflow)
    for name in PACK_INTS:
        np.testing.assert_array_equal(np_of(getattr(tp, name)),
                                      np_of(getattr(jp, name)), err_msg=name)
    # xyz, cov3d, opacity, valid, rgb per pair; rgb goes through the SH
    # evaluation of preprocess, where the two frameworks round differently
    np.testing.assert_allclose(np_of(tp.params), np_of(jp.params),
                               atol=1e-6, rtol=1e-5)


def test_render_matches_jax(scene, packs):
    _, cam, _, tcam = scene
    jp, tp = packs
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jc, jd, ja = j_render_pose_mode(jp, cam, J_CFG, bg=jnp.asarray(bg))
    before = dict(gsl.LAUNCHES)
    with torch.no_grad():
        c, d, a = render_pose_mode(tp, tcam, CFG, bg=torch.tensor(bg))
    assert gsl.LAUNCHES == before      # CPU tensors take the plain versions
    assert c.shape == (64, 96, 3) and d.shape == a.shape == (64, 96)
    assert float(a.max()) > 0.99       # the scene saturates some pixels
    np.testing.assert_allclose(np_of(c), np_of(jc), atol=1e-5)
    np.testing.assert_allclose(np_of(d), np_of(jd), atol=1e-5)
    np.testing.assert_allclose(np_of(a), np_of(ja), atol=1e-5)


def test_render_matches_rasterize(scene, packs):
    """Pose mode at the pack's own pose is the full rasterizer's image."""
    _, _, tg, tcam = scene
    _, tp = packs
    with torch.no_grad():
        c, d, a = render_pose_mode(tp, tcam, CFG)
        out = rasterize(tg, tcam, CFG)
    np.testing.assert_allclose(np_of(c), np_of(out.color), atol=1e-5)
    np.testing.assert_allclose(np_of(d), np_of(out.depth), atol=1e-5)
    np.testing.assert_allclose(np_of(a), np_of(out.alpha), atol=1e-5)


def test_camera_tangent_grad_matches_jax(scene, packs):
    _, cam, _, tcam = scene
    jp, tp = packs
    # evaluated away from the pack's pose, as inside a rebin window
    tau0 = np.array([0.004, -0.003, 0.002, 0.01, -0.006, 0.008], np.float32)

    def jloss(tau):
        c, d, a = j_render_pose_mode(jp, cam.with_delta(tau), J_CFG)
        return jnp.sum(c) + 0.1 * jnp.sum(d) + 0.01 * jnp.sum(a)

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(tau0)))
    tau = torch.tensor(tau0, requires_grad=True)
    c, d, a = render_pose_mode(tp, tcam.with_delta(tau), CFG)
    (c.sum() + 0.1 * d.sum() + 0.01 * a.sum()).backward()
    assert torch.isfinite(tau.grad).all() and float(tau.grad.abs().max()) > 0
    np.testing.assert_allclose(np_of(tau.grad), g_j, rtol=1e-3, atol=1e-3)


def test_stream_truncation_sets_overflow(scene):
    _, _, tg, tcam = scene
    pack = build_stream_pair_pack(tg, tcam, CFG.replace(max_render=512))
    assert bool(pack.overflow)


def test_render_refuses_what_is_not_ported(scene, packs):
    _, _, _, tcam = scene
    _, tp = packs
    with pytest.raises(TypeError, match="StreamPairPack or a PairPack"):
        render_pose_mode(object(), tcam, CFG)
    with pytest.raises(ValueError, match="align == chunk"):
        render_pose_mode(tp, tcam, CFG.replace(pallas_chunk=64))


# ---- the capped PairPack layout (use_stream=False: K3/K4) ------------------
# The JAX side blends the same capped pack with its plain jnp twin (the
# port's K3/K4 against the Pallas kernels themselves is
# test_torch_pallas_blend.py).

J_PRE = JConfig(max_pairs=1 << 12, max_per_tile=128, fast_k=8, chunk=32,
                backend="jnp", pallas_chunk=32, use_stream=False)
PRE = RasterizerConfig(max_pairs=1 << 12, max_per_tile=128, fast_k=8,
                       pallas_chunk=32, use_stream=False)


@pytest.fixture(scope="module")
def small():
    # 48x32 image (6 tiles), 100 Gaussians at SH degree 1
    g = random_scene(np.random.default_rng(2), 100, sh_degree=1)
    cam = make_camera(48, 32, fov=1.0)
    tg, tcam = gaussians_to_torch(g), camera_to_torch(cam)
    jp = jax.jit(lambda g, c: j_build_pair_pack(g, c, J_PRE))(g, cam)
    return g, cam, tg, tcam, jp, build_pair_pack(tg, tcam, PRE)


def test_pair_pack_matches_jax(small):
    _, _, _, _, jp, tp = small
    assert isinstance(tp, PairPack) and tp.params.shape == (6, 16, 128)
    np.testing.assert_array_equal(np_of(tp.counts), np_of(jp.counts))
    np.testing.assert_array_equal(np_of(tp.overflow), np_of(jp.overflow))
    assert not bool(tp.overflow) and int(tp.counts.max()) > 32
    # every lane, masked ones included (they hold real Gaussians' params)
    np.testing.assert_allclose(np_of(tp.params), np_of(jp.params),
                               atol=1e-6, rtol=1e-5)


def test_pair_pack_render_and_grad_match_jax(small):
    g, cam, tg, tcam, jp, tp = small
    with torch.no_grad():
        c, d, a = render_pose_mode(tp, tcam, PRE)
        full = rasterize(tg, tcam, PRE)
    # at the pack's own pose, pose mode is the full rasterizer's image
    np.testing.assert_allclose(np_of(c), np_of(full.color), atol=1e-5)
    np.testing.assert_allclose(np_of(a), np_of(full.alpha), atol=1e-5)
    tau0 = np.array([0.004, -0.003, 0.002, 0.01, -0.006, 0.008], np.float32)

    def jloss(tau):
        c, d, a = j_render_pose_mode(jp, cam.with_delta(tau), J_PRE)
        return jnp.sum(c) + 0.1 * jnp.sum(d) + 0.01 * jnp.sum(a)

    l_j, g_j = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(tau0))
    tau = torch.tensor(tau0, requires_grad=True)
    c, d, a = render_pose_mode(tp, tcam.with_delta(tau), PRE)
    loss = c.sum() + 0.1 * d.sum() + 0.01 * a.sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    assert torch.isfinite(tau.grad).all() and float(tau.grad.abs().max()) > 0
    np.testing.assert_allclose(np_of(tau.grad), g_j, rtol=1e-3, atol=1e-3)


def test_pair_pack_refinement_matches_stream(small):
    """refine_pose with pose_mode on use_stream=False takes the PairPack
    (K3/K4) and lands where the stream pack (K1/K2) does: both render the
    same pairs exactly, in another summation order."""
    _, _, tg, tcam, _, _ = small
    with torch.no_grad():
        gt = rasterize(tg, tcam, PRE)
    cam_bad = tcam.with_delta(torch.tensor(
        [0.01, -0.008, 0.012, 0.02, -0.015, 0.01]))
    mask = torch.ones((32, 48), dtype=torch.bool)
    tcfg = TrackingConfig(num_iters=5, lr=1e-3, convergence=0.0,
                          rebin_every=10, pose_mode=True)
    before = dict(gsl.LAUNCHES)
    res = [refine_pose(tg, cam_bad, gt.color, mask, tcfg, cfg,
                       gt_depth=gt.depth)
           for cfg in (PRE, PRE.replace(use_stream=True))]
    assert gsl.LAUNCHES == before      # CPU tensors take the plain versions
    assert res[0].num_iters == res[1].num_iters == 5
    assert not bool(res[0].overflow)
    np.testing.assert_allclose(np_of(res[0].w2c), np_of(res[1].w2c),
                               atol=1e-5)
    err0 = float(torch.linalg.norm(cam_bad.w2c - tcam.w2c))
    assert float(torch.linalg.norm(res[0].w2c - tcam.w2c)) < err0
