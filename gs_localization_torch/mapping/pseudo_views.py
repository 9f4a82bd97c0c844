"""Pseudo-camera synthesis for few-shot training.

When fewer than ``fewshot_threshold`` training views exist, extra camera
poses are generated: the training cameras are ordered into a short tour
(greedy nearest neighbour), and poses are interpolated between consecutive
cameras with cosine spacing (linear translation, quaternion slerp).
Training renders these views and holds their depth to a monocular depth
prior with a min-Pearson loss.

The tour and the interpolation run in numpy on the host, in the JAX
package's float64/float32 arithmetic: the cameras' ``w2c`` and ``campos``
are read as float32 arrays, the quaternions and the interpolation
parameter are float64, and the rotation matrix is built in float32.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.camera import Camera, quat_to_rotmat, rotmat_to_quat


def _tour_order(centers: np.ndarray) -> np.ndarray:
    """Short path through the camera centres: greedy nearest neighbour
    from camera 0 (the first of equally near cameras wins)."""
    n = centers.shape[0]
    d = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    order = [0]
    used = {0}
    for _ in range(n - 1):
        last = order[-1]
        nxt = min((j for j in range(n) if j not in used),
                  key=lambda j: d[last, j])
        order.append(nxt)
        used.add(nxt)
    return np.array(order)


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    if np.dot(q0, q1) < 0:
        q1 = -q1
    dot = np.clip(np.dot(q0, q1), -1.0, 1.0)
    if dot > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(dot)
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def generate_pseudo_poses(cameras: List[Camera],
                          n_per_edge: int = 3) -> List[Camera]:
    """``n_per_edge`` interpolated cameras on each edge of a tour of the
    given cameras, with the first camera's intrinsics, on its device."""
    if len(cameras) < 2:
        return []
    w2cs = [c.w2c.detach().cpu().numpy() for c in cameras]
    centers = np.stack([c.campos.detach().cpu().numpy() for c in cameras])
    order = _tour_order(centers)
    out: List[Camera] = []
    base = cameras[0]
    for a, b in zip(order[:-1], order[1:]):
        Ra, ta = w2cs[a][:3, :3], w2cs[a][:3, 3]
        Rb, tb = w2cs[b][:3, :3], w2cs[b][:3, 3]
        qa, qb = rotmat_to_quat(Ra), rotmat_to_quat(Rb)
        for k in range(1, n_per_edge + 1):
            # cosine-spaced interpolation parameter (denser near endpoints)
            u = k / (n_per_edge + 1)
            t = 0.5 * (1 - np.cos(np.pi * u))
            q = _slerp(qa, qb, t)
            w2c = np.eye(4, dtype=np.float32)
            w2c[:3, :3] = quat_to_rotmat(
                torch.tensor(q, dtype=torch.float32)).numpy()
            w2c[:3, 3] = (1 - t) * ta + t * tb
            out.append(base.replace(w2c=torch.tensor(w2c,
                                                     device=base.device)))
    return out
