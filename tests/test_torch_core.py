"""Port core math (sh, se3, camera, gaussians) against the JAX package."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gs_localization_tpu.core import se3 as jse3
from gs_localization_tpu.core import sh as jsh
from gs_localization_tpu.core.camera import (
    quat_to_rotmat as j_quat_to_rotmat, w2c_from_quat_t as j_w2c_from_quat_t)
from gs_localization_tpu.core.gaussians import GaussianParams as JGaussians
from gs_localization_torch.core import se3, sh
from gs_localization_torch.core.camera import (
    Camera, quat_to_rotmat, w2c_from_quat_t)
from gs_localization_torch.core.gaussians import FIELDS, GaussianParams
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch, np_of


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    k = sh.num_sh_coeffs(degree)
    assert k == jsh.num_sh_coeffs(degree)
    coeffs = rng.standard_normal((50, 16, 3)).astype(np.float32)
    dirs = rng.standard_normal((50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    np.testing.assert_allclose(
        np_of(sh.eval_sh(torch.tensor(coeffs), torch.tensor(dirs), degree)),
        np_of(jsh.eval_sh(jnp.asarray(coeffs), jnp.asarray(dirs), degree)),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        np_of(sh.sh_to_clamped_rgb(torch.tensor(coeffs), torch.tensor(dirs),
                                   degree)),
        np_of(jsh.sh_to_clamped_rgb(jnp.asarray(coeffs), jnp.asarray(dirs),
                                    degree)), atol=1e-6, rtol=1e-6)
    rgb = rng.uniform(0, 1, (20, 3)).astype(np.float32)
    np.testing.assert_allclose(sh.sh_dc_to_rgb(sh.rgb_to_sh_dc(rgb)), rgb,
                               atol=1e-6)
    np.testing.assert_allclose(np_of(sh.rgb_to_sh_dc(torch.tensor(rgb))),
                               np_of(jsh.rgb_to_sh_dc(jnp.asarray(rgb))),
                               atol=1e-6)


# theta norms on both sides of the small-angle branch (_SMALL = 1e-5)
THETAS = {
    "large": [0.3, -0.8, 1.1],
    "medium": [1e-3, 2e-3, -1e-3],
    "small": [3e-6, -2e-6, 4e-6],
    "zero": [0.0, 0.0, 0.0],
}


@pytest.mark.parametrize("name", list(THETAS))
def test_so3_and_se3_exp(name):
    theta = np.asarray(THETAS[name], np.float32)
    rho = np.asarray([0.1, -0.2, 0.3], np.float32)
    tau = np.concatenate([rho, theta])
    for fn_t, fn_j, x in [
        (se3.skew, jse3.skew, theta),
        (se3.so3_exp, jse3.so3_exp, theta),
        (se3.so3_left_jacobian, jse3.so3_left_jacobian, theta),
        (se3.se3_exp, jse3.se3_exp, tau),
    ]:
        np.testing.assert_allclose(np_of(fn_t(torch.tensor(x))),
                                   np_of(fn_j(jnp.asarray(x))),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", list(THETAS))
def test_apply_delta_grad_matches_jax(name):
    rng = np.random.default_rng(5)
    tau = np.concatenate([[0.02, -0.01, 0.03], THETAS[name]]).astype(
        np.float32)
    w2c = np.asarray(make_camera(64, 48, t=np.array([0.1, 0.2, -0.3],
                                                    np.float32)).w2c)
    weight = rng.standard_normal((4, 4)).astype(np.float32)

    def jloss(t):
        return jnp.sum(jse3.apply_delta(t, jnp.asarray(w2c)) * weight)

    g_j = jax.grad(jloss)(jnp.asarray(tau))
    tt = torch.tensor(tau, requires_grad=True)
    out = se3.apply_delta(tt, torch.tensor(w2c))
    (out * torch.tensor(weight)).sum().backward()
    np.testing.assert_allclose(np_of(out), np_of(jse3.apply_delta(
        jnp.asarray(tau), jnp.asarray(w2c))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(np_of(tt.grad), np_of(g_j), atol=1e-5,
                               rtol=1e-5)
    assert torch.isfinite(tt.grad).all()


def test_rotation_error():
    R1 = np.asarray(jse3.so3_exp(jnp.asarray([0.1, 0.2, -0.1])))
    R2 = np.asarray(jse3.so3_exp(jnp.asarray([0.0, 0.25, -0.05])))
    np.testing.assert_allclose(
        float(se3.rotation_geodesic_error_deg(torch.tensor(R1),
                                              torch.tensor(R2))),
        float(jse3.rotation_geodesic_error_deg(jnp.asarray(R1),
                                               jnp.asarray(R2))), rtol=1e-4)


def test_camera_matches_jax():
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.1, -0.2, 0.05])))
    t = np.array([0.3, -0.1, 0.5], np.float32)
    from gs_localization_tpu.core.camera import Camera as JCamera
    jc = JCamera.from_rt(R, t, 70.0, 72.0, 96, 64, cx=45.0, cy=30.0)
    tc = Camera.from_rt(R, t, 70.0, 72.0, 96, 64, cx=45.0, cy=30.0,
                        device="cpu")
    for name in ("w2c", "projection", "full_proj", "campos", "tan_fovx",
                 "tan_fovy"):
        np.testing.assert_allclose(np_of(getattr(tc, name)),
                                   np_of(getattr(jc, name)), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    tau = np.array([0.01, -0.02, 0.005, 0.02, 0.01, -0.03], np.float32)
    np.testing.assert_allclose(
        np_of(tc.with_delta(torch.tensor(tau)).w2c),
        np_of(jc.with_delta(jnp.asarray(tau)).w2c), atol=1e-6, rtol=1e-6)
    # carried over from the JAX object through numpy: identical values
    cc = camera_to_torch(jc)
    np.testing.assert_array_equal(np_of(cc.w2c), np_of(jc.w2c))
    assert (cc.width, cc.height, cc.znear, cc.zfar) == (96, 64, 0.01, 100.0)


def test_quaternion_pose():
    q = np.array([[0.9, 0.1, -0.3, 0.2], [0.0, 1.0, 0.0, 0.0]], np.float32)
    t = np.array([[0.1, 0.2, 0.3], [-1.0, 0.0, 2.0]], np.float32)
    np.testing.assert_allclose(np_of(quat_to_rotmat(torch.tensor(q))),
                               np_of(j_quat_to_rotmat(jnp.asarray(q))),
                               atol=1e-6)
    np.testing.assert_allclose(
        np_of(w2c_from_quat_t(torch.tensor(q), torch.tensor(t))),
        np_of(j_w2c_from_quat_t(jnp.asarray(q), jnp.asarray(t))), atol=1e-6)


def test_gaussians_carry_over_round_trip():
    g = random_scene(np.random.default_rng(0), n=100, sh_degree=3,
                     capacity=128)
    tg = gaussians_to_torch(g)
    assert (tg.sh_degree, tg.max_sh_degree, tg.capacity) == (3, 3, 128)
    back = tg.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(g, f)),
                                      err_msg=f)
    assert int(tg.num_live) == int(g.num_live) == 100
    for name in ("get_scaling", "get_rotation", "get_opacity",
                 "get_features"):
        np.testing.assert_allclose(np_of(getattr(tg, name)),
                                   np_of(getattr(g, name)), atol=1e-6,
                                   rtol=1e-6, err_msg=name)


def test_gaussians_from_arrays_and_empty():
    rng = np.random.default_rng(1)
    n = 10
    arrays = dict(
        xyz=rng.standard_normal((n, 3)), features_dc=rng.random((n, 1, 3)),
        features_rest=rng.random((n, 3, 3)), scaling=rng.random((n, 3)),
        rotation=rng.standard_normal((n, 4)), opacity=rng.random((n, 1)))
    jg = JGaussians.from_arrays(**arrays, sh_degree=1, capacity=16)
    tg = GaussianParams.from_arrays(**arrays, sh_degree=1, capacity=16,
                                    device="cpu")
    for f in FIELDS:
        np.testing.assert_allclose(np_of(getattr(tg, f)),
                                   np_of(getattr(jg, f)), atol=1e-7,
                                   err_msg=f)
    je = JGaussians.empty(8, sh_degree=2)
    te = GaussianParams.empty(8, sh_degree=2, device="cpu")
    assert (te.sh_degree, te.max_sh_degree) == (je.sh_degree,
                                                je.max_sh_degree)
    for f in FIELDS:
        np.testing.assert_array_equal(np_of(getattr(te, f)),
                                      np_of(getattr(je, f)), err_msg=f)
    with pytest.raises(KeyError):
        GaussianParams.from_numpy({"xyz": np.zeros((2, 3))}, 0, 0,
                                  device="cpu")
