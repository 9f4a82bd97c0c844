"""Native PnP-RANSAC.

Replaces the reference's call into pycolmap.absolute_pose_estimation
(hloc/localize_sfm.py:53-68; RANSAC max_error default 12 px).

Design: vectorized hypothesis generation — B random 6-point samples, each
solved by DLT on the incidence equations x_i x (R X_i + t) = 0 with known
intrinsics (batched SVD), rotation re-projected to SO(3) by Procrustes —
then inlier counting for all hypotheses at once, and a Gauss-Newton polish
on the best hypothesis' inliers. Pure numpy (host-side init stage, matching
where the reference runs COLMAP), deterministic given the seed: a copy of
the JAX package's ``sfm/pnp.py`` that gives the same bits for the same
inputs and seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..core.camera import rotmat_to_quat


class PnPResult(NamedTuple):
    success: bool
    qvec: np.ndarray       # (4,) wxyz, w2c
    tvec: np.ndarray       # (3,)
    num_inliers: int
    inlier_mask: np.ndarray


def _bearings(points2d: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Pixel -> normalized camera coordinates (z=1 plane)."""
    x = (points2d[:, 0] - K[0, 2]) / K[0, 0]
    y = (points2d[:, 1] - K[1, 2]) / K[1, 1]
    return np.stack([x, y], axis=1)


def _dlt_pose_batch(X: np.ndarray, xn: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Batched DLT: X (B, 6, 3) world points, xn (B, 6, 2) normalized coords.

    Solves for P = [R|t] (3x4) minimizing the algebraic incidence error, then
    projects R onto SO(3). Returns (R (B,3,3), t (B,3)).
    """
    b, n, _ = X.shape
    Xh = np.concatenate([X, np.ones((b, n, 1))], axis=2)        # (B, 6, 4)
    zeros = np.zeros_like(Xh)
    # rows: [X 0 -x*X; 0 X -y*X] for each point
    r1 = np.concatenate([Xh, zeros, -xn[:, :, 0:1] * Xh], axis=2)
    r2 = np.concatenate([zeros, Xh, -xn[:, :, 1:2] * Xh], axis=2)
    A = np.concatenate([r1, r2], axis=1)                         # (B, 12, 12)
    # nullspace via SVD
    _, _, vt = np.linalg.svd(A)
    p = vt[:, -1, :].reshape(b, 3, 4)
    R_raw = p[:, :, :3]
    t_raw = p[:, :, 3]
    # fix sign: points must be in front (positive depth for majority)
    depths = np.einsum("bij,bnj->bni", R_raw, X)[:, :, 2] + t_raw[:, None, 2]
    sign = np.where(np.median(depths, axis=1) < 0, -1.0, 1.0)
    R_raw = R_raw * sign[:, None, None]
    t_raw = t_raw * sign[:, None]
    # Procrustes: R = U diag(1,1,det) V^T, scale = mean singular value
    U, S, Vt = np.linalg.svd(R_raw)
    det = np.linalg.det(U @ Vt)
    D = np.zeros_like(U)
    D[:, 0, 0] = 1.0
    D[:, 1, 1] = 1.0
    D[:, 2, 2] = det
    R = U @ D @ Vt
    scale = S.mean(axis=1) * np.sign(det)
    t = t_raw / np.where(np.abs(scale) < 1e-12, 1.0, scale)[:, None]
    return R, t


def _reproj_errors(R, t, X, pts2d, K):
    """R (B,3,3), t (B,3), X (N,3) -> (B, N) pixel errors (inf behind cam)."""
    Xc = np.einsum("bij,nj->bni", R, X) + t[:, None, :]
    z = Xc[:, :, 2]
    valid = z > 1e-6
    zs = np.where(valid, z, 1.0)
    u = K[0, 0] * Xc[:, :, 0] / zs + K[0, 2]
    v = K[1, 1] * Xc[:, :, 1] / zs + K[1, 2]
    err = np.sqrt((u - pts2d[None, :, 0]) ** 2 + (v - pts2d[None, :, 1]) ** 2)
    return np.where(valid, err, np.inf)


def _gauss_newton(R, t, X, pts2d, K, iters=10):
    """Polish (R, t) on all given correspondences (assumed inliers)."""
    from scipy.spatial.transform import Rotation

    rvec = Rotation.from_matrix(R).as_rotvec()
    params = np.concatenate([rvec, t])

    def residuals_jac(p):
        Rm = Rotation.from_rotvec(p[:3]).as_matrix()
        tv = p[3:]
        Xc = X @ Rm.T + tv
        z = np.maximum(Xc[:, 2], 1e-6)
        u = K[0, 0] * Xc[:, 0] / z + K[0, 2]
        v = K[1, 1] * Xc[:, 1] / z + K[1, 2]
        res = np.stack([u - pts2d[:, 0], v - pts2d[:, 1]], 1).reshape(-1)
        # Jacobian wrt left-multiplied so(3) delta and t
        n = X.shape[0]
        J = np.zeros((2 * n, 6))
        inv_z = 1.0 / z
        x, y = Xc[:, 0], Xc[:, 1]
        # d(u)/d(Xc) = fx * [1/z, 0, -x/z^2]; d(v)/d(Xc) = fy * [0, 1/z, -y/z^2]
        du = np.stack([K[0, 0] * inv_z, np.zeros(n), -K[0, 0] * x * inv_z**2], 1)
        dv = np.stack([np.zeros(n), K[1, 1] * inv_z, -K[1, 1] * y * inv_z**2], 1)
        # dXc/d(theta) = -[Xc]_x (left perturbation), dXc/dt = I
        def cross(vs):
            c = np.zeros((n, 3, 3))
            c[:, 0, 1] = -vs[:, 2]; c[:, 0, 2] = vs[:, 1]
            c[:, 1, 0] = vs[:, 2]; c[:, 1, 2] = -vs[:, 0]
            c[:, 2, 0] = -vs[:, 1]; c[:, 2, 1] = vs[:, 0]
            return c
        dXc_dth = -cross(Xc)
        J[0::2, :3] = np.einsum("ni,nij->nj", du, dXc_dth)
        J[1::2, :3] = np.einsum("ni,nij->nj", dv, dXc_dth)
        J[0::2, 3:] = du
        J[1::2, 3:] = dv
        return res, J

    for _ in range(iters):
        res, J = residuals_jac(params)
        H = J.T @ J + 1e-8 * np.eye(6)
        g = J.T @ res
        try:
            delta = -np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            break
        # left-multiplicative update on rotation
        Rm = Rotation.from_rotvec(delta[:3]).as_matrix() @ \
            Rotation.from_rotvec(params[:3]).as_matrix()
        params = np.concatenate([Rotation.from_matrix(Rm).as_rotvec(),
                                 params[3:] + delta[3:]])
        if np.linalg.norm(delta) < 1e-10:
            break
    Rm = Rotation.from_rotvec(params[:3]).as_matrix()
    return Rm, params[3:]


def pnp_ransac(
    points2d: np.ndarray,
    points3d: np.ndarray,
    K: np.ndarray,
    max_error_px: float = 12.0,
    max_hypotheses: int = 4096,
    confidence: float = 0.9999,
    seed: int = 0,
    min_inliers: int = 6,
) -> PnPResult:
    """Estimate a w2c pose from 2D-3D matches.

    Returns (success, qvec wxyz, tvec, inliers) in the COLMAP/localize_sfm
    output convention.
    """
    n = points2d.shape[0]
    fail = PnPResult(False, np.array([1.0, 0, 0, 0]), np.zeros(3), 0,
                     np.zeros(n, bool))
    if n < 6:
        return fail
    rng = np.random.default_rng(seed)
    sample_size = 6

    # hypothesis batch (adaptive early-out handled by simple two-stage growth)
    total = 0
    best_R, best_t, best_inl, best_count = None, None, None, -1
    batch = 512
    while total < max_hypotheses:
        idx = np.stack(
            [rng.choice(n, sample_size, replace=False) for _ in range(batch)]
        )
        X = points3d[idx]
        xn = _bearings(points2d, K)[idx]
        with np.errstate(all="ignore"):
            R, t = _dlt_pose_batch(X, xn)
            err = _reproj_errors(R, t, points3d, points2d, K)
        inl = err < max_error_px
        counts = inl.sum(axis=1)
        j = int(np.argmax(counts))
        if counts[j] > best_count:
            best_count = int(counts[j])
            best_R, best_t, best_inl = R[j], t[j], inl[j]
        total += batch
        # stop when confident
        w = min(max(best_count / n, 1e-9), 1.0 - 1e-9)
        needed = np.log(1 - confidence) / np.log(1 - w**sample_size)
        if total >= min(needed, max_hypotheses):
            break

    if best_count < min_inliers:
        return fail
    # polish on inliers, then re-score (one re-weighting round)
    for round_i in range(2):
        R, t = _gauss_newton(best_R, best_t, points3d[best_inl],
                             points2d[best_inl], K)
        err = _reproj_errors(R[None], t[None], points3d, points2d, K)[0]
        new_inl = err < max_error_px
        if round_i > 0 and new_inl.sum() <= best_inl.sum():
            break
        best_R, best_t, best_inl = R, t, new_inl
    qvec = rotmat_to_quat(best_R)
    return PnPResult(True, qvec, best_t, int(best_inl.sum()), best_inl)
