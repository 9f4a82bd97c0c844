"""The gates of the JAX suite's ``tests/test_loc.py::
TestConvergenceEquivalence``, held by the port alone: the same scene (made
through numpy from the same seed), the same perturbation, iterations and
bounds, with no JAX run. The exact path (pose mode off, a rebin every
iteration) must recover the pose to 1 cm / 0.5 deg, and the product's
approximations (a rebin every 10 iterations, and pose mode with it) must
converge to the exact path's error within 1 mm / 0.1 deg."""

import numpy as np
import pytest
import torch

from gs_localization_torch.core import se3
from gs_localization_torch.loc import TrackingConfig, refine_pose
from gs_localization_torch.raster import RasterizerConfig, rasterize
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch

# the JAX test's capacities and layout (the per-tile id matrix, chunk 32)
CFG = RasterizerConfig(max_pairs=1 << 15, max_per_tile=256, pallas_chunk=32,
                       use_stream=False)
TAU = [0.02, -0.015, 0.01, 0.015, -0.02, 0.01]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file: its loops run many small CPU
    ops, and when each spreads over a thread pool, the suite's parallel
    workers (more threads than cores) make every op wait on a barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    g = gaussians_to_torch(random_scene(
        rng, n=300, sh_degree=2, spread=1.5, z_range=(2.5, 6.0),
        scale_range=(-3.0, -1.8)))
    cam_gt = camera_to_torch(make_camera(80, 60, fov=1.1))
    with torch.no_grad():
        target = rasterize(g, cam_gt, CFG)
    cam0 = cam_gt.with_delta(torch.tensor(TAU))
    mask = torch.ones((60, 80), dtype=torch.bool)
    return g, cam_gt, cam0, target, mask


def _errors(res, cam_gt):
    R_est = res.w2c[:3, :3]
    t_err = float(torch.linalg.norm(-R_est.T @ res.w2c[:3, 3]
                                    - cam_gt.campos))
    r_err = float(se3.rotation_geodesic_error_deg(R_est, cam_gt.R_w2c))
    return t_err, r_err


def test_rebin10_and_pose_mode_converge_like_exact(setup):
    g, cam_gt, cam0, target, mask = setup
    # convergence=0: the full budget, so every path reaches its fixed point
    base = TrackingConfig(num_iters=120, lr=2e-3, convergence=0.0)
    exact = refine_pose(g, cam0, target.color, mask, base, CFG,
                        gt_depth=target.depth)
    t_exact, r_exact = _errors(exact, cam_gt)
    assert t_exact < 0.01 and r_exact < 0.5, (t_exact, r_exact)
    for variant in (base.replace(rebin_every=10),
                    base.replace(rebin_every=10, pose_mode=True)):
        res = refine_pose(g, cam0, target.color, mask, variant, CFG,
                          gt_depth=target.depth)
        t_err, r_err = _errors(res, cam_gt)
        assert abs(t_err - t_exact) < 1e-3, (t_err, t_exact)
        assert abs(r_err - r_exact) < 0.1, (r_err, r_exact)
