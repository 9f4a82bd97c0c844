"""SE(3) / SO(3) Lie-group helpers.

Rodrigues exponential with a small-angle Taylor branch, left Jacobian ``V``,
and the retraction ``T_w2c <- exp(tau) @ T_w2c`` with tau = [rho, theta].

All products are full float32: reduced-precision (TF32) matmuls in the
~50-step sequential retraction random-walk the pose by 0.5-1.5 degrees, so
the port never enables them. The small-angle branch is a ``torch.where``.

``apply_delta`` has two implementations, chosen by the tangent's device:
a CUDA tangent launches the hand-written kernels of ``csrc/pose_algebra.cu``
(A1 forward, A2 its adjoint, in a ``torch.autograd.Function``) and must be
(6,) float32 with a (4, 4) float32 pose on its device, or they raise; a CPU
tangent takes the PyTorch ops (``se3_exp(tau) @ w2c``), the yardstick the
kernels are held against on the card. ``_apply_delta_adjoint`` is A2's
plain version.
"""

from __future__ import annotations

import torch

from .._kernels import check_tensor, launch
from ..utils.profiling import count_wait

_SMALL = 1e-5


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _safe_angle(theta: torch.Tensor):
    """(angle, is_small): angle clamped away from 0 for safe division; the
    small branch uses Taylor series so the clamp never leaks into outputs."""
    sq = torch.sum(theta * theta, dim=-1)
    is_small = sq < _SMALL * _SMALL
    angle = torch.sqrt(torch.where(is_small, torch.ones_like(sq), sq))
    return angle, is_small


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _exp_parts(theta: torch.Tensor):
    """W = skew(theta), W @ W, the angle and the small-branch flag of the
    exponential at (..., 3) theta."""
    W = skew(theta)
    W2 = W @ W
    a, is_small = _safe_angle(theta)
    return W, W2, a, is_small


def _sin_term(a, is_small) -> torch.Tensor:
    """sin(a) / a, 1 on the small branch."""
    return torch.where(is_small, torch.ones_like(a), torch.sin(a) / a)


def _cos_term(a, is_small) -> torch.Tensor:
    """(1 - cos(a)) / a^2, 1/2 on the small branch."""
    return torch.where(is_small, torch.full_like(a, 0.5),
                       (1.0 - torch.cos(a)) / (a * a))


def _cubic_term(a, is_small) -> torch.Tensor:
    """(a - sin(a)) / a^3, 1/6 on the small branch."""
    return torch.where(is_small, torch.full_like(a, 1.0 / 6.0),
                       (a - torch.sin(a)) / (a * a * a))


def _combine(W, W2, c_w, c_w2) -> torch.Tensor:
    """I + c_w W + c_w2 W2, the coefficients (...) broadcast over (3, 3)."""
    return _eye_like(W) + c_w[..., None, None] * W + c_w2[..., None, None] * W2


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix (Rodrigues)."""
    W, W2, a, small = _exp_parts(theta)
    return _combine(W, W2, _sin_term(a, small), _cos_term(a, small))


def so3_left_jacobian(theta: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V(theta): translation part of SE(3) exp is V @ rho."""
    W, W2, a, small = _exp_parts(theta)
    return _combine(W, W2, _cos_term(a, small), _cubic_term(a, small))


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [rho(3), theta(3)] -> (..., 4, 4) homogeneous transform."""
    rho = tau[..., :3]
    theta = tau[..., 3:]
    R = so3_exp(theta)
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(theta), rho)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    count_wait("se3_row", tau.device)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tau.dtype,
                          device=tau.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _apply_delta_adjoint(tau: torch.Tensor, w2c: torch.Tensor,
                         g: torch.Tensor):
    """The plain version of A2 (``csrc/pose_algebra.cu``): the hand-derived
    adjoint of ``exp(tau) @ w2c`` for a (6,) tangent and a (4, 4) pose, from
    the product's cotangent ``g``: (tau's gradient (6,), w2c's (4, 4)).
    Autograd's conventions: the small branch's Taylor constants carry no
    gradient through the angle."""
    with torch.no_grad():
        rho, theta = tau[:3], tau[3:]
        W, W2, a, is_small = _exp_parts(theta)
        s = _sin_term(a, is_small)
        c = _cos_term(a, is_small)
        c2 = _cubic_term(a, is_small)
        V = _combine(W, W2, c, c2)
        E = torch.zeros_like(w2c)
        E[:3, :3] = _combine(W, W2, s, c)
        E[:3, 3] = V @ rho
        E[3, 3] = 1.0
        gE = g @ w2c.T
        gR, gt = gE[:3, :3], gE[:3, 3]
        # t = V rho
        g_rho = V.T @ gt
        gV = gt[:, None] * rho[None, :]
        # R and V through W and W2 = W @ W
        G2 = c * gR + c2 * gV
        gW = s * gR + c * gV + G2 @ W.T + W.T @ G2
        g_theta = torch.stack([gW[2, 1] - gW[1, 2], gW[0, 2] - gW[2, 0],
                               gW[1, 0] - gW[0, 1]])
        # the angle through s, c (in R and V) and c2; d a / d theta =
        # theta / a on the large branch only
        sa, ca = torch.sin(a), torch.cos(a)
        a2 = a * a
        a3 = a2 * a
        omc = 1.0 - ca
        ds = (a * ca - sa) / a2
        dc = (a * sa - 2.0 * omc) / a3
        dc2 = (omc * a - 3.0 * (a - sa)) / (a3 * a)
        g_a = (torch.sum(gR * W) * ds
               + (torch.sum(gR * W2) + torch.sum(gV * W)) * dc
               + torch.sum(gV * W2) * dc2)
        r = torch.where(is_small, torch.zeros_like(a), g_a / a)
        g_theta = g_theta + theta * r
        return torch.cat([g_rho, g_theta]), E.T @ g


def apply_delta_fwd_cuda(tau: torch.Tensor, w2c: torch.Tensor
                         ) -> torch.Tensor:
    """Launch A1: ``exp(tau) @ w2c`` for a (6,) tangent and a (4, 4)
    pose."""
    check_tensor(tau, "tau", torch.float32, (6,), tau.device)
    check_tensor(w2c, "w2c", torch.float32, (4, 4), tau.device)
    out = torch.empty_like(w2c)
    launch("se3_apply_fwd", tau.device, tau, w2c, out)
    return out


def apply_delta_bwd_cuda(tau: torch.Tensor, w2c: torch.Tensor,
                         g: torch.Tensor):
    """Launch A2: (tau's gradient (6,), w2c's (4, 4)) from the cotangent
    ``g`` of ``exp(tau) @ w2c``; ``_apply_delta_adjoint`` is its plain
    version."""
    check_tensor(tau, "tau", torch.float32, (6,), tau.device)
    check_tensor(w2c, "w2c", torch.float32, (4, 4), tau.device)
    check_tensor(g, "g", torch.float32, (4, 4), tau.device)
    g_tau = torch.empty_like(tau)
    g_w2c = torch.empty_like(w2c)
    launch("se3_apply_bwd", tau.device, tau, w2c, g, g_tau, g_w2c)
    return g_tau, g_w2c


class _ApplyDelta(torch.autograd.Function):
    """A1 forward, A2 backward."""

    @staticmethod
    def forward(ctx, tau, w2c):
        ctx.save_for_backward(tau, w2c)
        return apply_delta_fwd_cuda(tau, w2c)

    @staticmethod
    def backward(ctx, g):
        tau, w2c = ctx.saved_tensors
        g_tau, g_w2c = apply_delta_bwd_cuda(tau, w2c, g.contiguous())
        return g_tau, (g_w2c if ctx.needs_input_grad[1] else None)


def apply_delta(tau: torch.Tensor, w2c: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction: w2c' = exp(tau) @ w2c. A CUDA tangent
    launches A1 (and A2 in the backward), with no wait, and raises unless it
    is (6,) float32 with a (4, 4) float32 pose on its device; a tangent
    elsewhere takes ``se3_exp`` and a matmul, broadcasting."""
    if tau.is_cuda:
        return _ApplyDelta.apply(tau.contiguous(), w2c.contiguous())
    return se3_exp(tau) @ w2c


def rotation_geodesic_error_deg(R_est: torch.Tensor,
                                R_gt: torch.Tensor) -> torch.Tensor:
    """Rotation error arccos((tr(R_gt^T R) - 1)/2) in degrees."""
    tr = torch.sum(R_gt * R_est, dim=(-2, -1))
    cosv = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cosv))
