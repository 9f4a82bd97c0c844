"""SE(3) / SO(3) Lie-group helpers.

Rodrigues exponential with a small-angle Taylor branch, left Jacobian ``V``,
and the retraction ``T_w2c <- exp(tau) @ T_w2c`` with tau = [rho, theta].

All products are full float32: reduced-precision (TF32) matmuls in the
~50-step sequential retraction random-walk the pose by 0.5-1.5 degrees, so
the port never enables them. The small-angle branch is a ``torch.where``.
"""

from __future__ import annotations

import torch

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


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix (Rodrigues)."""
    W = skew(theta)
    W2 = W @ W
    angle, is_small = _safe_angle(theta)
    a = angle[..., None, None]
    small = is_small[..., None, None]
    sin_term = torch.where(small, torch.ones_like(a), torch.sin(a) / a)
    cos_term = torch.where(small, torch.full_like(a, 0.5),
                           (1.0 - torch.cos(a)) / (a * a))
    return _eye_like(W) + sin_term * W + cos_term * W2


def so3_left_jacobian(theta: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V(theta): translation part of SE(3) exp is V @ rho."""
    W = skew(theta)
    W2 = W @ W
    angle, is_small = _safe_angle(theta)
    a = angle[..., None, None]
    small = is_small[..., None, None]
    c1 = torch.where(small, torch.full_like(a, 0.5),
                     (1.0 - torch.cos(a)) / (a * a))
    c2 = torch.where(small, torch.full_like(a, 1.0 / 6.0),
                     (a - torch.sin(a)) / (a * a * a))
    return _eye_like(W) + c1 * W + c2 * W2


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [rho(3), theta(3)] -> (..., 4, 4) homogeneous transform."""
    rho = tau[..., :3]
    theta = tau[..., 3:]
    R = so3_exp(theta)
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(theta), rho)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tau.dtype,
                          device=tau.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def apply_delta(tau: torch.Tensor, w2c: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction: w2c' = exp(tau) @ w2c (broadcasting)."""
    return se3_exp(tau) @ w2c


def rotation_geodesic_error_deg(R_est: torch.Tensor,
                                R_gt: torch.Tensor) -> torch.Tensor:
    """Rotation error arccos((tr(R_gt^T R) - 1)/2) in degrees."""
    tr = torch.sum(R_gt * R_est, dim=(-2, -1))
    cosv = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cosv))
