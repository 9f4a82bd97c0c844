"""RGB-D map initialisation in the port against the JAX package: the
cases of the JAX suite's ``tests/test_data2.py::TestRGBD``, held against
JAX's outputs on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.data import rgbd as jrgbd
from gs_localization_torch.core.gaussians import FIELDS
from gs_localization_torch.data import rgbd as trgbd
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch, np_of


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file (see ``test_torch_loc.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(rng, w, h, depth):
    cam = make_camera(w, h, fov=1.0).with_delta(jnp.asarray(
        [0.1, -0.05, 0.2, 0.03, -0.02, 0.05], jnp.float32))
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    dep = (depth + 0.5 * rng.uniform(0, 1, (h, w))).astype(np.float32)
    return cam, rgb, dep


def test_backprojection_matches_jax():
    rng = np.random.default_rng(0)
    cam, rgb, dep = _frame(rng, 64, 48, 3.0)
    dep[::7, ::5] = 0.0                     # invalid pixels
    dep[3, :] = 12.0                        # beyond depth_max
    pj = jrgbd.backproject_rgbd(cam, jnp.asarray(rgb), jnp.asarray(dep),
                                stride=4)
    pt = trgbd.backproject_rgbd(camera_to_torch(cam), rgb, dep, stride=4)
    assert len(pt[0]) == len(pj[0]) < (48 // 4) * (64 // 4)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    # the JAX suite's check: a fronto-parallel plane at z = 3
    cam0 = make_camera(64, 48, fov=1.0)
    flat = np.full((48, 64), 3.0, np.float32)
    pts, _, sp = trgbd.backproject_rgbd(camera_to_torch(cam0), rgb, flat)
    assert len(pts) == (48 // 4) * (64 // 4)
    np.testing.assert_allclose(pts[:, 2], 3.0, atol=1e-5)
    np.testing.assert_allclose(sp, 3.0 * 4 / float(cam0.fx), atol=1e-5)


def test_gaussians_from_rgbd_matches_jax():
    rng = np.random.default_rng(1)
    cam, rgb, dep = _frame(rng, 32, 24, 2.0)
    dep[:4] = 0.0                            # invalid band
    gj = jrgbd.gaussians_from_rgbd(cam, rgb, dep, stride=4, sh_degree=1,
                                   capacity=64)
    gt = trgbd.gaussians_from_rgbd(camera_to_torch(cam), rgb, dep, stride=4,
                                   sh_degree=1, capacity=64)
    assert int(gt.num_live) == int(gj.num_live) == (24 // 4 - 1) * (32 // 4)
    assert gt.capacity == gj.capacity and gt.sh_degree == gj.sh_degree
    for f in FIELDS:
        np.testing.assert_allclose(np_of(getattr(gt, f)),
                                   np.asarray(getattr(gj, f)), atol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("n_live,stride", [(30, 8), (110, 8), (128, 8)])
def test_extend_gaussians_matches_jax(n_live, stride):
    """Free slots scattered among live ones; at 110 live more points than
    free slots (the rest dropped), at 128 none free."""
    rng = np.random.default_rng(2)
    g = random_scene(rng, n=128, capacity=128)
    live = np.zeros(128, bool)
    live[rng.permutation(128)[:n_live]] = True
    g = g.replace(live=jnp.asarray(live))
    cam, rgb, dep = _frame(rng, 32, 24, 2.5)
    gj, added_j = jrgbd.extend_gaussians_from_rgbd(g, cam, rgb, dep,
                                                   stride=stride)
    gt, added_t = trgbd.extend_gaussians_from_rgbd(
        gaussians_to_torch(g), camera_to_torch(cam), rgb, dep, stride=stride)
    n_pts = (24 // stride) * (32 // stride)
    assert int(added_t) == int(added_j) == min(n_pts, 128 - n_live)
    assert int(gt.num_live) == int(gj.num_live) == n_live + int(added_j)
    for f in FIELDS:
        np.testing.assert_allclose(np_of(getattr(gt, f)),
                                   np.asarray(getattr(gj, f)), atol=1e-5,
                                   err_msg=f)
    # the live Gaussians are untouched
    np.testing.assert_array_equal(np_of(gt.xyz)[live], np.asarray(g.xyz)[live])
