"""Pose-error metrics: the reference's evaluation protocol (numpy, host side).

  e_t = || -R_gt^T t_gt + R^T t ||      (camera-center distance)
  e_R = arccos((tr(R_gt^T R) - 1) / 2)  degrees

plus the threshold-recall table at (1cm,1deg) ... (5m,10deg).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

THRESHOLDS: Tuple[Tuple[float, float], ...] = (
    (0.01, 1.0), (0.02, 2.0), (0.03, 3.0), (0.05, 5.0),
    (0.25, 2.0), (0.5, 5.0), (5.0, 10.0),
)


def pose_errors(
    R_est: np.ndarray, t_est: np.ndarray,
    R_gt: np.ndarray, t_gt: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched ((B,3,3),(B,3)) -> (trans err meters, rot err degrees)."""
    R_est = np.asarray(R_est)
    batched = R_est.ndim == 3
    if not batched:
        R_est, t_est = R_est[None], np.asarray(t_est)[None]
        R_gt, t_gt = np.asarray(R_gt)[None], np.asarray(t_gt)[None]
    c_est = -np.einsum("bij,bi->bj", R_est, t_est)   # -R^T t
    c_gt = -np.einsum("bij,bi->bj", R_gt, t_gt)
    e_t = np.linalg.norm(c_gt - c_est, axis=1)
    tr = np.einsum("bji,bjk->bik", R_gt, R_est)
    cos = np.clip((np.trace(tr, axis1=1, axis2=2) - 1) / 2, -1.0, 1.0)
    e_r = np.degrees(np.arccos(cos))
    if not batched:
        return e_t[0], e_r[0]
    return e_t, e_r


def summarize_errors(
    e_t: np.ndarray, e_r: np.ndarray,
    thresholds: Sequence[Tuple[float, float]] = THRESHOLDS,
) -> Dict[str, float]:
    out = {
        "median_trans_m": float(np.median(e_t)),
        "median_rot_deg": float(np.median(e_r)),
    }
    for dt, dr in thresholds:
        ratio = float(np.mean((e_t < dt) & (e_r < dr)))
        out[f"recall@{dt}m,{dr}deg"] = ratio
    return out
