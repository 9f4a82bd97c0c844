"""Bundle adjustment: matrix-free Levenberg-Marquardt in PyTorch.

The reference delegates joint pose+structure refinement to COLMAP's C++
ceres solver inside ``pycolmap.incremental_mapping``
(hloc/reconstruction.py:186-229). This is the same inexact-LM solver as the
JAX package's ``sfm/bundle_adjust.py`` ("Bundle Adjustment in the Large"
style): the normal equations (JtJ + lambda I) delta = -Jt r are solved by
conjugate gradient using only Jacobian-vector products — ``torch.func.jvp``
for J, ``torch.func.vjp`` for Jt — so the sparse Jacobian is never
materialized. Every step is a fixed sequence of dense vectorized ops over all
observations at once, on the device of the problem's tensors.

Parameterization: SE(3) tangent deltas around the current poses (retraction
``exp(tau) @ w2c0``, core/se3.py) and additive deltas on points. Gauge
freedom is fixed by masking the tangents of ``fixed_cams``. Robustness via
IRLS Huber weights recomputed each outer iteration.

The CG is ``jax.scipy.sparse.linalg.cg``'s recurrence and stopping rule
(residual test against max(tol^2 * b.b, atol^2), tol 1e-5, atol 0, dot
products summed over the two leaves in the order (dx, tau)), run as a fixed
``cg_iters`` loop whose updates are masked once the test passes: the same
arithmetic as JAX's while loop, with no host sync per iteration. Steps are
accepted and lambda moved with ``torch.where``, so the LM loop never syncs
either.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jvp, vjp

from .. import resolve_device
from ..core.se3 import se3_exp

_CG_TOL = 1e-5


class BAProblem(NamedTuple):
    w2c0: torch.Tensor      # (C, 4, 4) current world->cam poses
    K: torch.Tensor         # (C, 3, 3) intrinsics
    points0: torch.Tensor   # (T, 3) current points
    cam_idx: torch.Tensor   # (E,) int64
    pt_idx: torch.Tensor    # (E,) int64
    uv: torch.Tensor        # (E, 2) observed pixels
    weight: torch.Tensor    # (E,) observation weights (0 = ignore)
    fixed_cams: torch.Tensor  # (C,) bool — gauge-fixed cameras (tau pinned 0)


class BAResult(NamedTuple):
    w2c: torch.Tensor       # (C, 4, 4)
    points: torch.Tensor    # (T, 3)
    cost0: torch.Tensor     # () initial robust cost
    cost: torch.Tensor      # () final robust cost
    num_iters: torch.Tensor  # () LM iterations accepted


def _project(w2c, K, X, cam_idx, pt_idx):
    """Pixel projections of point pt_idx[e] into camera cam_idx[e]. (E, 2)."""
    Rt = w2c[cam_idx]                               # (E, 4, 4)
    Xc = torch.einsum("eij,ej->ei", Rt[:, :3, :3], X[pt_idx]) + Rt[:, :3, 3]
    z = torch.clamp_min(Xc[:, 2], 1e-6)
    Ke = K[cam_idx]
    u = Ke[:, 0, 0] * Xc[:, 0] / z + Ke[:, 0, 2]
    v = Ke[:, 1, 1] * Xc[:, 1] / z + Ke[:, 1, 2]
    return torch.stack([u, v], -1)


def _apply_tau(tau, w2c0, fixed):
    tau = torch.where(fixed[:, None], 0.0, tau)
    return se3_exp(tau) @ w2c0


def _vdot(a, b):
    """The two-leaf dot product of JAX's CG: leaves in key order."""
    return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])


def _cg(matvec, b, maxiter: int):
    """x ~ A^-1 b for the (dx, tau) pair b, JAX's CG with x0 = 0 and
    ``maxiter`` masked iterations."""
    tol2 = float(np.float32(_CG_TOL) ** 2)     # jnp.square(tol) in float32
    atol2 = torch.clamp_min(tol2 * _vdot(b, b), 0.0)
    x = tuple(torch.zeros_like(v) for v in b)
    r = b
    gamma = _vdot(r, r)
    p = r
    for _ in range(maxiter):
        live = gamma > atol2
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x_ = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r_ = tuple(ri - alpha * ai for ri, ai in zip(r, Ap))
        gamma_ = _vdot(r_, r_)
        beta = gamma_ / gamma
        p_ = tuple(ri + beta * pi for ri, pi in zip(r_, p))
        x = tuple(torch.where(live, n, o) for n, o in zip(x_, x))
        r = tuple(torch.where(live, n, o) for n, o in zip(r_, r))
        p = tuple(torch.where(live, n, o) for n, o in zip(p_, p))
        gamma = torch.where(live, gamma_, gamma)
    return x


def bundle_adjust(
    problem: BAProblem,
    iters: int = 15,
    cg_iters: int = 40,
    huber_px: float = 4.0,
    lm_lambda0: float = 1e-3,
) -> BAResult:
    """Run ``iters`` LM steps on the device of the problem's tensors."""
    w2c0 = problem.w2c0.to(torch.float32)
    dev = w2c0.device
    K = problem.K.to(torch.float32)
    X0 = problem.points0.to(torch.float32)
    cam_idx = problem.cam_idx.to(torch.int64)
    pt_idx = problem.pt_idx.to(torch.int64)
    uv = problem.uv.to(torch.float32)
    w_obs = problem.weight.to(torch.float32)
    fixed = problem.fixed_cams.to(torch.bool)

    def predict(dx, tau):
        w2c = _apply_tau(tau, w2c0, fixed)
        return _project(w2c, K, X0 + dx, cam_idx, pt_idx)

    def robust_cost_and_weights(dx, tau):
        """Huber IRLS: weights sqrt(min(1, huber/|r|)), cost in px^2 units."""
        r2 = torch.sum((predict(dx, tau) - uv) ** 2, -1)
        rn = torch.sqrt(r2 + 1e-12)
        hub = torch.where(rn <= huber_px, r2, huber_px * (2 * rn - huber_px))
        cost = torch.sum(w_obs * hub)
        irls = w_obs * torch.sqrt(torch.clamp_max(huber_px / rn, 1.0))
        return cost, irls

    # the parameters are global deltas around the base state, as the pair
    # (dx, tau): the key order of the JAX package's parameter dict
    params = (torch.zeros_like(X0),
              torch.zeros((w2c0.shape[0], 6), dtype=torch.float32,
                          device=dev))
    cost0, _ = robust_cost_and_weights(*params)
    cost = cost0
    lam = torch.tensor(lm_lambda0, dtype=torch.float32, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(iters):
        _, irls = robust_cost_and_weights(*params)

        def residuals(dx, tau, irls=irls):
            return (predict(dx, tau) - uv) * irls[:, None]

        # matrix-free normal equations via jvp/vjp
        r, vjp_fn = vjp(residuals, *params)
        jtr = vjp_fn(r)

        def matvec(v, lam=lam, vjp_fn=vjp_fn, residuals=residuals,
                   params=params):
            _, jv = jvp(residuals, params, v)
            return tuple(a + lam * b for a, b in zip(vjp_fn(jv), v))

        delta = _cg(matvec, tuple(-g for g in jtr), cg_iters)
        trial = tuple(p + d for p, d in zip(params, delta))
        new_cost, _ = robust_cost_and_weights(*trial)
        accept = new_cost < cost
        params = tuple(torch.where(accept, t, p)
                       for t, p in zip(trial, params))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        lam = torch.clamp(lam, 1e-8, 1e6)
        accepted = accepted + accept.to(torch.int32)

    dx, tau = params
    return BAResult(w2c=_apply_tau(tau, w2c0, fixed), points=X0 + dx,
                    cost0=cost0, cost=cost, num_iters=accepted)


def bundle_adjust_np(
    w2c: np.ndarray, K: np.ndarray, points: np.ndarray,
    cam_idx: np.ndarray, pt_idx: np.ndarray, uv: np.ndarray,
    weight: Optional[np.ndarray] = None,
    fixed_cams: Optional[np.ndarray] = None,
    device="cuda",
    **kw,
):
    """Host-friendly wrapper: numpy in, the solver on ``device``, numpy out:
    (w2c, points, cost0, cost)."""
    dev = resolve_device(device)
    e = len(cam_idx)
    if weight is None:
        weight = np.ones(e, np.float32)
    if fixed_cams is None:
        fixed_cams = np.zeros(len(w2c), bool)
        fixed_cams[0] = True

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    prob = BAProblem(
        w2c0=t(w2c, torch.float32), K=t(K, torch.float32),
        points0=t(points, torch.float32),
        cam_idx=t(cam_idx, torch.int64), pt_idx=t(pt_idx, torch.int64),
        uv=t(uv, torch.float32), weight=t(weight, torch.float32),
        fixed_cams=t(fixed_cams, torch.bool),
    )
    res = bundle_adjust(
        prob, iters=kw.get("iters", 15), cg_iters=kw.get("cg_iters", 40),
        huber_px=kw.get("huber_px", 4.0),
        lm_lambda0=kw.get("lm_lambda0", 1e-3))
    return (res.w2c.cpu().numpy(), res.points.cpu().numpy(),
            float(res.cost0), float(res.cost))
