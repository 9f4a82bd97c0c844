"""Port tracking loss, tracking masks, pose refinement and the localization
pipeline against the JAX package on the same seeded inputs (the JAX side
runs its Pallas stream kernels in interpret mode)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gs_localization_tpu.loc.refine import (
    TrackingConfig as JTrackingConfig, refine_pose as j_refine_pose,
    tracking_loss as j_tracking_loss)
from gs_localization_tpu.ops.image import (
    compute_grad_mask as j_compute_grad_mask,
    keypoint_box_mask as j_keypoint_box_mask)
from gs_localization_tpu.pipelines.localize import (
    LocalizePipelineConfig as JPipelineConfig, QuerySpec as JQuerySpec,
    localize_queries as j_localize_queries)
from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import rasterize as j_rasterize
from gs_localization_torch.loc import (
    TrackingConfig, refine_pose, refine_poses_batch, tracking_loss)
from gs_localization_torch.ops.image import (
    compute_grad_mask, keypoint_box_mask)
from gs_localization_torch.pipelines.localize import (
    LocalizePipelineConfig, QuerySpec, localize_queries)
from gs_localization_torch.raster import RasterizerConfig
from gs_localization_torch.sfm.evaluate import THRESHOLDS
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch, np_of

J_CFG = JConfig(max_pairs=1 << 14, max_per_tile=256, max_render=1 << 14,
                backend="pallas_interpret", pallas_chunk=128)
CFG = RasterizerConfig(max_pairs=1 << 14, max_per_tile=256,
                       max_render=1 << 14, pallas_chunk=128)
TAU = np.array([0.01, -0.008, 0.012, 0.02, -0.015, 0.01], np.float32)


@pytest.fixture(scope="module")
def scene():
    g = random_scene(np.random.default_rng(0), 500)
    cam = make_camera(96, 64, fov=1.0)
    out = j_rasterize(g, cam, J_CFG)
    return dict(g=g, cam=cam, tg=gaussians_to_torch(g),
                tcam=camera_to_torch(cam), color=np.asarray(out.color),
                depth=np.asarray(out.depth))


# ---- tracking loss ---------------------------------------------------------

@pytest.mark.parametrize("monocular,normalize_depth", [
    (True, False), (False, False), (False, True)])
def test_tracking_loss_matches_jax(monocular, normalize_depth):
    rng = np.random.default_rng(5)
    h, w = 48, 64
    color = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 4, (h, w)).astype(np.float32)
    alpha = rng.uniform(0.97, 1.0, (h, w)).astype(np.float32)  # both sides
    #   of the 0.99 opacity threshold
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    gt_depth = rng.uniform(-0.5, 4, (h, w)).astype(np.float32)  # some <= 0.01
    mask = rng.random((h, w)) < 0.6
    ab = np.array([0.05, -0.02], np.float32)
    jcfg = JTrackingConfig(monocular=monocular,
                           normalize_depth=normalize_depth)
    tcfg = TrackingConfig(monocular=monocular,
                          normalize_depth=normalize_depth)
    lj = j_tracking_loss(*map(jnp.asarray, (color, depth, alpha, ab, gt,
                                            mask)), jcfg,
                         gt_depth=jnp.asarray(gt_depth))
    lt = tracking_loss(*map(torch.tensor, (color, depth, alpha, ab, gt,
                                           mask)), tcfg,
                       gt_depth=torch.tensor(gt_depth))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


def test_rgbd_loss_needs_depth():
    z = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="gt_depth"):
        tracking_loss(torch.zeros((4, 4, 3)), z, z, torch.zeros(2),
                      torch.zeros((4, 4, 3)), z > 0, TrackingConfig())


# ---- masks -----------------------------------------------------------------

def _images(scene):
    rng = np.random.default_rng(2)
    return {
        # 96 x 64: an even pixel count, where the median averages the two
        # middle values (torch.median would take the lower one)
        "render": scene["color"],
        # 63 x 47: an odd pixel count; noise over a ramp
        "noise": (np.linspace(0, 1, 63)[None, :, None]
                  + 0.2 * rng.standard_normal((47, 63, 3))).astype(np.float32),
    }


@pytest.mark.parametrize("name", ["render", "noise"])
def test_grad_mask_matches_jax_exactly(scene, name):
    img = _images(scene)[name]
    mj = np.asarray(j_compute_grad_mask(jnp.asarray(img), 1.1))
    mt = np_of(compute_grad_mask(torch.tensor(img), 1.1))
    assert mt.dtype == bool and 0 < mt.sum() < mt.size
    np.testing.assert_array_equal(mt, mj)


def test_keypoint_box_mask_matches_jax_exactly():
    rng = np.random.default_rng(3)
    kp = np.concatenate([rng.uniform(-5, 70, (30, 2)),
                         [[0, 0], [63.4, 47.6], [-0.4, 10], [64.0, 3]]]
                        ).astype(np.float32)
    valid = rng.random(len(kp)) < 0.8
    for k, v in ((10, None), (7, valid)):
        mj = np.asarray(j_keypoint_box_mask(
            jnp.asarray(kp), 64, 48, k, None if v is None else jnp.asarray(v)))
        mt = np_of(keypoint_box_mask(
            torch.tensor(kp), 64, 48, k, None if v is None else torch.tensor(v)))
        assert mt.any()
        np.testing.assert_array_equal(mt, mj)


# ---- pose refinement -------------------------------------------------------

def test_refine_pose_five_iters_matches_jax(scene):
    cam_bad = scene["cam"].with_delta(jnp.asarray(TAU))
    mask = np.ones(scene["color"].shape[:2], bool)
    kw = dict(num_iters=5, lr=1e-3, convergence=0.0, rebin_every=10,
              pose_mode=True)
    rj = j_refine_pose(scene["g"], cam_bad, jnp.asarray(scene["color"]),
                       jnp.asarray(mask), JTrackingConfig(**kw), J_CFG,
                       gt_depth=jnp.asarray(scene["depth"]))
    rt = refine_pose(scene["tg"], camera_to_torch(cam_bad),
                     torch.tensor(scene["color"]), torch.tensor(mask),
                     TrackingConfig(**kw), CFG,
                     gt_depth=torch.tensor(scene["depth"]))
    assert rt.num_iters == int(rj.num_iters) == 5
    assert not bool(rt.overflow)
    np.testing.assert_allclose(np_of(rt.w2c), np.asarray(rj.w2c), atol=1e-4)
    np.testing.assert_allclose(np_of(rt.exposure_ab),
                               np.asarray(rj.exposure_ab), atol=1e-4)
    np.testing.assert_allclose(float(rt.final_loss), float(rj.final_loss),
                               rtol=1e-3)


def test_refine_recovers_pose_and_batches(scene):
    """Mirrors the JAX package's stream pose-mode recovery test."""
    tcam = scene["tcam"]
    color = torch.tensor(scene["color"])
    depth = torch.tensor(scene["depth"])
    mask = torch.ones(color.shape[:2], dtype=torch.bool)
    cam_bad = tcam.with_delta(torch.tensor(TAU))
    tcfg = TrackingConfig(num_iters=40, lr=5e-3, convergence=0.0,
                          rebin_every=10, pose_mode=True)
    res = refine_pose(scene["tg"], cam_bad, color, mask, tcfg, CFG,
                      gt_depth=depth)
    err0 = float(torch.linalg.norm(cam_bad.w2c - tcam.w2c))
    err1 = float(torch.linalg.norm(res.w2c - tcam.w2c))
    assert err1 < 0.3 * err0, (err0, err1)
    assert res.num_iters == 40 and not bool(res.overflow)

    short = tcfg.replace(num_iters=6)
    one = refine_pose(scene["tg"], cam_bad, color, mask, short, CFG,
                      gt_depth=depth)
    res_b = refine_poses_batch(scene["tg"], [cam_bad, cam_bad],
                               torch.stack([color] * 2),
                               torch.stack([mask] * 2), short, CFG,
                               gt_depths=torch.stack([depth] * 2))
    assert res_b.w2c.shape == (2, 4, 4) and res_b.num_iters == [6, 6]
    np.testing.assert_allclose(np_of(res_b.w2c[0]), np_of(one.w2c),
                               atol=1e-6)


def test_convergence_stops_early(scene):
    tcam = scene["tcam"]
    color = torch.tensor(scene["color"])
    res = refine_pose(scene["tg"], tcam, color,
                      torch.ones(color.shape[:2], dtype=torch.bool),
                      TrackingConfig(num_iters=20, convergence=1.0,
                                     monocular=True, pose_mode=True), CFG)
    assert res.num_iters == 1


# ---- localization pipeline -------------------------------------------------

def test_localize_queries_matches_jax(scene):
    gt_w2c = np.asarray(scene["cam"].w2c)
    rng = np.random.default_rng(8)
    kps = rng.uniform(0, 96, (20, 2)).astype(np.float32) * [1, 64 / 96]
    jqs, tqs = [], []
    for i in range(2):
        tau = (rng.uniform(0.005, 0.015, 6)
               * rng.choice([-1.0, 1.0], 6)).astype(np.float32)
        cam_q = scene["cam"].with_delta(jnp.asarray(tau))
        common = dict(name=f"q{i}", image=scene["color"],
                      depth=scene["depth"], gt_w2c=gt_w2c,
                      keypoints=kps if i == 0 else None)
        jqs.append(JQuerySpec(camera=cam_q, **common))
        tqs.append(QuerySpec(camera=camera_to_torch(cam_q), **common))
    kw = dict(num_iters=5, lr=1e-3, convergence=0.0, rebin_every=10,
              pose_mode=True)
    res_j, met_j = j_localize_queries(
        scene["g"], jqs, JPipelineConfig(batch_size=2,
                                         tracking=JTrackingConfig(**kw)),
        J_CFG, log_fn=lambda s: None)
    logs = []
    res_t, met_t = localize_queries(
        scene["tg"], tqs, LocalizePipelineConfig(
            batch_size=1, tracking=TrackingConfig(**kw)), CFG,
        log_fn=logs.append)
    assert logs[-1].startswith("median err")
    assert sorted(res_t) == sorted(res_j) == ["q0", "q1"]
    for name in res_j:
        np.testing.assert_allclose(res_t[name], np.asarray(res_j[name]),
                                   atol=1e-4)
    assert sorted(met_t) == sorted(met_j)
    assert len(met_t) == 2 + len(THRESHOLDS)
    for key, val in met_j.items():
        np.testing.assert_allclose(met_t[key], val, rtol=1e-3, atol=1e-6,
                                   err_msg=key)
