"""The plain version of pose mode's projection adjoint
(``raster/pose_mode.py::_project_adjoint``, the arithmetic of the CUDA
kernel P2) against ``torch.autograd`` of ``_project_core`` in float64 on
the CPU: random poses, dead (all-zero) positions, positions behind the
near plane, positions outside the 1.3 tan_fov clamp, and both guards."""

import dataclasses
from typing import Optional

import numpy as np
import pytest
import torch

from gs_localization_torch.core import se3
from gs_localization_torch.core.camera import Camera
from gs_localization_torch.raster.pose_mode import (
    _project_adjoint, _project_core, _project_stream_plain, _project_terms,
    camera_vectors)

W, H, F = 96, 64, 80.0
N, KEPT = 384, 320          # stream length, live prefix
COT_ROWS = (0, 1, 2, 3, 4, 11)   # px, py, conic a, b, c, depth


@dataclasses.dataclass(frozen=True)
class _FreeProjCamera(Camera):
    """A camera whose ``full_proj`` is a leaf of its own, so that autograd
    gives its gradient apart from the pose's."""

    fp: Optional[torch.Tensor] = None

    @property
    def full_proj(self) -> torch.Tensor:
        return self.fp


def _pose(rng, case: str) -> torch.Tensor:
    if case in ("depth_guard", "det_guard"):
        return torch.eye(4, dtype=torch.float64)
    tau = torch.tensor(np.concatenate([rng.uniform(-0.3, 0.3, 3),
                                       rng.uniform(-0.4, 0.4, 3)]))
    return se3.se3_exp(tau)


def _params(rng, case: str, w2c: torch.Tensor) -> torch.Tensor:
    """(16, N) float64 stream params: Gaussians in front of the camera in
    camera coordinates, moved to the world by the pose; ``case`` sets a
    share of positions to its special kind. Positions past KEPT and every
    seventh position are dead (all zero)."""
    cam_xyz = np.stack([rng.uniform(-1.0, 1.0, N), rng.uniform(-0.7, 0.7, N),
                        rng.uniform(1.5, 6.0, N)], 1)
    special = rng.random(N) < 0.3
    if case == "behind":          # at or behind the near plane
        cam_xyz[special, 2] = rng.uniform(-3.0, 0.2, special.sum())
    elif case == "clamped":       # |vx / vz| or |vy / vz| past 1.3 tan_fov
        cam_xyz[special, 0] *= rng.choice([-1.0, 1.0], special.sum()) * 4.0
        cam_xyz[special[::-1], 1] *= 5.0
    elif case == "depth_guard":   # vz == 0: z_safe takes over
        cam_xyz[special] = 0.0
    a = rng.standard_normal((N, 3, 3)) * 0.05
    cov = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(3)
    if case == "det_guard":       # on the axis with a singular 2-D conic
        cam_xyz[special, :2] = 0.0
        cam_xyz[special, 2] = 2.0
        s, k = 1e-3, (F / 2.0) ** 2
        cov[special] = [[s, s + 0.3 / k, 0.0], [s + 0.3 / k, s, 0.0],
                        [0.0, 0.0, s]]
    R, t = w2c[:3, :3].numpy(), w2c[:3, 3].numpy()
    xyz = (cam_xyz - t) @ R                      # world = R^T (cam - t)
    rows = np.zeros((16, N))
    rows[0:3] = xyz.T
    rows[3:9] = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T
    rows[9] = rng.uniform(0.1, 1.0, N)           # opacity
    rows[10] = 1.0                               # valid
    rows[11:14] = rng.uniform(0.0, 1.0, (3, N))  # rgb
    dead = np.arange(N) % 7 == 3
    dead[KEPT:] = True
    rows[:, dead] = 0.0
    return torch.tensor(rows)


def _camera(w2c: torch.Tensor, fp=None) -> Camera:
    f = torch.tensor(F, dtype=torch.float64)
    kw = dict(w2c=w2c, fx=f, fy=f, cx=torch.tensor(W / 2.0).double(),
              cy=torch.tensor(H / 2.0).double(), width=W, height=H)
    return Camera(**kw) if fp is None else _FreeProjCamera(**kw, fp=fp)


@pytest.mark.parametrize("case", ["random_pose", "dead", "behind", "clamped",
                                  "depth_guard", "det_guard"])
def test_adjoint_matches_autograd(case):
    rng = np.random.default_rng(["random_pose", "dead", "behind", "clamped",
                                 "depth_guard", "det_guard"].index(case))
    w2c0 = _pose(rng, case)
    params = _params(rng, case, w2c0)
    if case == "dead":
        params[:, rng.random(N) < 0.5] = 0.0
    kept_al = torch.tensor(KEPT, dtype=torch.int32)
    dstream = torch.tensor(rng.standard_normal((16, N)))
    w2c = w2c0.clone().requires_grad_()
    fp = _camera(w2c0).full_proj.detach().clone().requires_grad_()
    cam = _camera(w2c, fp)
    px, py, ia, ib, ic, validf, vz = _project_core(
        cam, *params[:9], params[10])
    outs = dict(zip(COT_ROWS, (px, py, ia, ib, ic, vz)))
    live = torch.arange(N) < KEPT
    loss = sum((torch.where(live, dstream[r], 0.0) * outs[r]).sum()
               for r in COT_ROWS)
    loss.backward()
    want = torch.cat([w2c.grad[:3].reshape(12), fp.grad[0:2].reshape(8),
                      fp.grad[3]])
    got = _project_adjoint(params, kept_al, cam, dstream)
    # the case really reaches what it names, at enough live positions
    t = _project_terms(_camera(w2c0), *params[:9])
    reached = {"behind": t.vz <= 0.2,
               "clamped": (t.ux.abs() > t.lim_x) | (t.uy.abs() > t.lim_y),
               "depth_guard": t.vz.abs() < 1e-6,
               "det_guard": t.det.abs() < 1e-12}.get(case)
    if reached is not None:
        assert int((reached & (params[10] > 0))[:KEPT].sum()) > 10
    assert torch.isfinite(want).all() and float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_adjoint_chains_to_the_tangent_through_camera_vectors():
    """The (24,) layout that ``camera_vectors`` builds and the adjoint fills
    is the one autograd chains to the camera tangent: the tangent's
    gradient by the adjoint equals autograd of the plain stream projection
    (float32, as the port runs)."""
    rng = np.random.default_rng(7)
    w2c0 = _pose(rng, "random_pose")
    params = _params(rng, "random_pose", w2c0).float()
    kept_al = torch.tensor(KEPT, dtype=torch.int32)
    dstream = torch.tensor(rng.standard_normal((16, N)), dtype=torch.float32)
    dstream[:, KEPT:] = 0.0
    cam = Camera.from_numpy(w2c0.numpy(), F, F, W / 2.0, H / 2.0, W, H,
                            device="cpu")
    tau = torch.zeros(6, requires_grad=True)
    stream = _project_stream_plain(params, cam.with_delta(tau))
    (want,) = torch.autograd.grad((stream * dstream).sum(), tau)
    pose, intr = camera_vectors(cam.with_delta(tau))
    assert pose.shape == (24,) and not intr.requires_grad
    g = _project_adjoint(params, kept_al, cam.with_delta(tau.detach()),
                         dstream)
    (got,) = torch.autograd.grad(pose, tau, grad_outputs=g)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
