"""The gates of the JAX suite's ``tests/test_loc.py::
TestConvergenceEquivalence`` on the port, and the same scene through both
packages. The scene is made through numpy from the same seed, with the same
perturbation, iterations and bounds. The exact path (pose mode off, a rebin
every iteration) must recover the pose to 1 cm / 0.5 deg, and the product's
approximations (a rebin every 10 iterations, and pose mode with it) must
converge to the exact path's error within 1 mm / 0.1 deg; then each path's
final errors must lie within 1 mm / 0.1 deg of the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.core import se3 as jse3
from gs_localization_tpu.loc import TrackingConfig as JTrackingConfig
from gs_localization_tpu.loc import refine_pose as j_refine_pose
from gs_localization_tpu.raster import RasterizerConfig as JRasterizerConfig
from gs_localization_tpu.raster import rasterize as j_rasterize
from gs_localization_torch.core import se3
from gs_localization_torch.loc import TrackingConfig, refine_pose
from gs_localization_torch.raster import RasterizerConfig, rasterize
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch

# the JAX test's capacities and layout (the per-tile id matrix, chunk 32)
CFG = RasterizerConfig(max_pairs=1 << 15, max_per_tile=256, pallas_chunk=32,
                       use_stream=False)
JCFG = JRasterizerConfig(tile_size=16, max_pairs=1 << 15, max_per_tile=256,
                        chunk=32, backend="jnp")
TAU = [0.02, -0.015, 0.01, 0.015, -0.02, 0.01]
# the exact path, then a rebin every 10 iterations, then pose mode with it
VARIANTS = (dict(), dict(rebin_every=10),
            dict(rebin_every=10, pose_mode=True))


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
def scene():
    rng = np.random.default_rng(7)
    return random_scene(rng, n=300, sh_degree=2, spread=1.5,
                        z_range=(2.5, 6.0), scale_range=(-3.0, -1.8))


@pytest.fixture(scope="module")
def setup(scene):
    g = gaussians_to_torch(scene)
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


@pytest.fixture(scope="module")
def port_errors(setup):
    """(trans m, rot deg) of the port's three paths, 120 iterations each
    (convergence=0: the full budget, so every path reaches its fixed
    point)."""
    g, cam_gt, cam0, target, mask = setup
    base = TrackingConfig(num_iters=120, lr=2e-3, convergence=0.0)
    return [_errors(refine_pose(g, cam0, target.color, mask,
                                base.replace(**kw), CFG,
                                gt_depth=target.depth), cam_gt)
            for kw in VARIANTS]


def test_rebin10_and_pose_mode_converge_like_exact(port_errors):
    (t_exact, r_exact), *variants = port_errors
    assert t_exact < 0.01 and r_exact < 0.5, (t_exact, r_exact)
    for t_err, r_err in variants:
        assert abs(t_err - t_exact) < 1e-3, (t_err, t_exact)
        assert abs(r_err - r_exact) < 0.1, (r_err, r_exact)


def test_converged_errors_match_jax(scene, port_errors):
    """JAX's TestConvergenceEquivalence run itself (its config, the jnp
    rasterizer, the target rendered jitted): each path's final errors on
    the port within 1 mm / 0.1 deg of JAX's."""
    cam_gt = make_camera(80, 60, fov=1.1)
    target = jax.jit(lambda g: j_rasterize(g, cam_gt, JCFG))(scene)
    cam0 = cam_gt.with_delta(jnp.asarray(TAU))
    mask = jnp.ones((60, 80), bool)
    base = JTrackingConfig(num_iters=120, lr=2e-3, convergence=0.0)
    for kw, (t_port, r_port) in zip(VARIANTS, port_errors):
        res = j_refine_pose(scene, cam0, target.color, mask,
                            base.replace(**kw), JCFG,
                            gt_depth=target.depth)
        R_est = res.w2c[:3, :3]
        t_jax = float(jnp.linalg.norm(-R_est.T @ res.w2c[:3, 3]
                                      - cam_gt.campos))
        r_jax = float(jse3.rotation_geodesic_error_deg(R_est,
                                                       cam_gt.R_w2c))
        print(f"{kw}: port {t_port * 1e3:.3f} mm / {r_port:.4f} deg, JAX "
              f"{t_jax * 1e3:.3f} mm / {r_jax:.4f} deg")
        assert abs(t_port - t_jax) < 1e-3, (kw, t_port, t_jax)
        assert abs(r_port - r_jax) < 0.1, (kw, r_port, r_jax)
