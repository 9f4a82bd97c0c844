"""The plain versions of the refinement's pose-algebra kernels
(``csrc/pose_algebra.cu``) against ``torch.autograd`` and the loop's own
ops, in float64 on the CPU: A2's ``se3._apply_delta_adjoint`` against
autograd of ``se3.apply_delta`` on both branches of the exponential, V2's
``pose_mode._camera_vectors_adjoint`` against autograd of
``camera_vectors``, the two chained to the tangent, and S1's
``refine.refine_adam_plain`` against ``adam_update`` and
``torch.linalg.norm``."""

import numpy as np
import pytest
import torch

from gs_localization_torch.core import se3
from gs_localization_torch.core.camera import Camera
from gs_localization_torch.loc import refine
from gs_localization_torch.raster import pose_mode as pm

TOL = dict(rtol=1e-10, atol=1e-10)
W, H = 96, 64

# theta's size picks the exponential's branch: 0 and |theta| < 1e-5 the
# small-angle Taylor constants, 0.6 rad Rodrigues' formula
TAUS = {
    "zero": np.zeros(6),
    "small": np.array([0.02, -0.01, 0.03, 3e-6, -2e-6, 4e-6]),
    "large": np.array([0.2, -0.1, 0.3, 0.4, -0.3, 0.3]),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w2c(rng) -> torch.Tensor:
    tau = torch.tensor(np.concatenate([rng.uniform(-1, 1, 3),
                                       rng.uniform(-0.5, 0.5, 3)]))
    return se3.se3_exp(tau)


def _camera(w2c, cx_shift: float = 0.0) -> Camera:
    f = torch.tensor(80.0, dtype=torch.float64)
    return Camera(w2c=w2c, fx=f, fy=f * 1.1,
                  cx=torch.tensor(W / 2.0 + cx_shift, dtype=torch.float64),
                  cy=torch.tensor(H / 2.0 - cx_shift, dtype=torch.float64),
                  width=W, height=H)


@pytest.mark.parametrize("w2c_grad", [False, True])
@pytest.mark.parametrize("case", list(TAUS))
def test_apply_delta_adjoint_matches_autograd(case, w2c_grad):
    rng = np.random.default_rng(list(TAUS).index(case))
    tau = torch.tensor(TAUS[case], requires_grad=True)
    w2c = _w2c(rng).requires_grad_(w2c_grad)
    g = torch.tensor(rng.standard_normal((4, 4)))
    assert bool(se3._safe_angle(tau[3:])[1]) == (case != "large")
    se3.apply_delta(tau, w2c).backward(g)
    g_tau, g_w2c = se3._apply_delta_adjoint(tau.detach(), w2c.detach(), g)
    assert float(tau.grad[3:].abs().max()) > 0
    torch.testing.assert_close(g_tau, tau.grad, **TOL)
    if w2c_grad:
        torch.testing.assert_close(g_w2c, w2c.grad, **TOL)


@pytest.mark.parametrize("cx_shift", [0.0, 7.5])
def test_camera_vectors_adjoint_matches_autograd(cx_shift):
    rng = np.random.default_rng(11)
    w2c = _w2c(rng).requires_grad_()
    cam = _camera(w2c, cx_shift)
    gpose = torch.tensor(rng.standard_normal(24))
    pose, intr = pm._camera_vectors_plain(cam)
    assert pose.shape == (24,) and intr.shape == (4,)
    pose.backward(gpose)
    got = pm._camera_vectors_adjoint(cam, gpose)
    torch.testing.assert_close(got, w2c.grad, **TOL)
    # w2c's row 3 enters full_proj through the projection's column 3,
    # nonzero only in row 2, which the pose vector leaves out
    assert float(got[3].abs().max()) == 0.0


@pytest.mark.parametrize("case", list(TAUS))
def test_plain_adjoints_chain_to_the_tangent(case):
    """V2's and A2's plain versions in turn give the tangent the gradient
    that autograd gives it through ``camera_vectors(cam.with_delta(tau))``,
    the chain a pose-mode iteration differentiates."""
    rng = np.random.default_rng(20 + list(TAUS).index(case))
    cam = _camera(_w2c(rng), 3.0)
    tau = torch.tensor(TAUS[case], requires_grad=True)
    gpose = torch.tensor(rng.standard_normal(24))
    pose, _ = pm._camera_vectors_plain(cam.with_delta(tau))
    pose.backward(gpose)
    moved = cam.with_delta(tau.detach())
    g_w2c = pm._camera_vectors_adjoint(moved, gpose)
    g_tau, _ = se3._apply_delta_adjoint(tau.detach(), cam.w2c, g_w2c)
    torch.testing.assert_close(g_tau, tau.grad, **TOL)


@pytest.mark.parametrize("t", [1.0, 2.0, 37.0])
def test_refine_adam_plain_matches_adam_update(t):
    rng = np.random.default_rng(int(t))
    g6, g2 = (torch.tensor(rng.standard_normal(n)) for n in (6, 2))
    g6[4] = 0.0                              # a zero gradient entry
    m6, m2 = (torch.tensor(rng.standard_normal(n)) for n in (6, 2))
    v6, v2 = (torch.tensor(rng.uniform(0.0, 2.0, n)) for n in (6, 2))
    ab = torch.tensor(rng.standard_normal(2))
    lr = 1e-3
    u6, m6_want, v6_want = refine.adam_update(g6, m6, v6, t, lr)
    u2, m2_want, v2_want = refine.adam_update(g2, m2, v2, t, lr)
    ab_want = ab + u2
    state = [x.clone() for x in (m6, v6, m2, v2, ab)]
    upd6, norm = refine.refine_adam_plain(g6, g2, *state, t, lr)
    for got, want in zip(state + [upd6, norm],
                         [m6_want, v6_want, m2_want, v2_want, ab_want, u6,
                          torch.linalg.norm(u6)]):
        torch.testing.assert_close(got, want, **TOL)
    assert norm.shape == () and float(norm) > 0
