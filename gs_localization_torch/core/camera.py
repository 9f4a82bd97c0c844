"""Camera model and projective math.

Conventions match the reference (so trained maps and poses interoperate):

- ``w2c`` is the 4x4 world-to-camera matrix (camera = w2c @ [x;1]).
- OpenGL-style projection with z_sign=+1 and z in [0,1], znear=0.01,
  zfar=100 by default, principal-point aware.
- NDC -> pixel: ((v+1)*S - 1)/2.

``Camera`` is a frozen dataclass of float32 tensors on one device plus the
static image size; ``replace`` returns a modified copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import se3


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def w2c_from_rt(R_c2w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 w2c from the reference's (R, T) storage: ``R`` is the
    camera-to-world rotation, ``t`` the world-to-camera translation."""
    top = torch.cat([R_c2w.transpose(-1, -2), t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def w2c_from_quat_t(qvec_wxyz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """COLMAP-style pose (qw qx qy qz, t) -> 4x4 w2c."""
    R = quat_to_rotmat(qvec_wxyz)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion (not necessarily unit) -> (..., 3, 3)."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    q = q / torch.clamp_min(n, 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R) -> np.ndarray:
    """3x3 rotation -> wxyz unit quaternion (float64 numpy, host-side),
    with the same branch choice as the JAX package and w >= 0."""
    m = np.asarray(R, dtype=np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array(
            [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array(
            [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s])
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array(
            [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return q.astype(np.float64)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def projection_matrix(fx, fy, cx, cy, width: int, height: int,
                      znear: float = 0.01, zfar: float = 100.0) -> torch.Tensor:
    """Principal-point-aware GL projection (z in [0,1], z_sign +1); with
    cx=W/2, cy=H/2 it reduces to the symmetric projection."""
    left = znear / fx * (((2 * cx - width) / width - 1.0) * width / 2.0)
    right = znear / fx * (((2 * cx - width) / width + 1.0) * width / 2.0)
    top = znear / fy * (((2 * cy - height) / height + 1.0) * height / 2.0)
    bottom = znear / fy * (((2 * cy - height) / height - 1.0) * height / 2.0)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    row0 = torch.stack([2.0 * znear / (right - left), zero,
                        (right + left) / (right - left), zero], dim=-1)
    row1 = torch.stack([zero, 2.0 * znear / (top - bottom),
                        (top + bottom) / (top - bottom), zero], dim=-1)
    row2 = torch.stack([zero, zero, one * (zfar / (zfar - znear)),
                        one * (-(zfar * znear) / (zfar - znear))], dim=-1)
    row3 = torch.stack([zero, zero, one, zero], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: w2c (4,4) and scalar intrinsics (float32 tensors on
    one device) plus the static image size."""

    w2c: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @classmethod
    def from_rt(cls, R_c2w, t, fx, fy, width: int, height: int,
                cx: Optional[float] = None, cy: Optional[float] = None,
                device="cuda", **kw) -> "Camera":
        dev = resolve_device(device)
        if cx is None:
            cx = width / 2.0
        if cy is None:
            cy = height / 2.0
        return cls(
            w2c=w2c_from_rt(_f32(R_c2w, dev), _f32(t, dev)),
            fx=_f32(fx, dev), fy=_f32(fy, dev),
            cx=_f32(cx, dev), cy=_f32(cy, dev),
            width=int(width), height=int(height), **kw)

    @classmethod
    def from_fov(cls, R_c2w, t, fovx: float, fovy: float, width: int,
                 height: int, **kw) -> "Camera":
        return cls.from_rt(R_c2w, t, fov2focal(fovx, width),
                           fov2focal(fovy, height), width, height, **kw)

    @classmethod
    def from_numpy(cls, w2c, fx, fy, cx, cy, width: int, height: int,
                   znear: float = 0.01, zfar: float = 100.0,
                   device="cuda") -> "Camera":
        """Carry a camera over from numpy values (e.g. the JAX package's
        ``Camera`` fields through ``np.asarray``)."""
        dev = resolve_device(device)
        return cls(w2c=_f32(w2c, dev), fx=_f32(fx, dev), fy=_f32(fy, dev),
                   cx=_f32(cx, dev), cy=_f32(cy, dev), width=int(width),
                   height=int(height), znear=float(znear), zfar=float(zfar))

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    @property
    def tan_fovx(self) -> torch.Tensor:
        return self.width / (2.0 * self.fx)

    @property
    def tan_fovy(self) -> torch.Tensor:
        return self.height / (2.0 * self.fy)

    @property
    def projection(self) -> torch.Tensor:
        return projection_matrix(self.fx, self.fy, self.cx, self.cy,
                                 self.width, self.height, self.znear,
                                 self.zfar)

    @property
    def full_proj(self) -> torch.Tensor:
        return self.projection @ self.w2c

    @property
    def R_w2c(self) -> torch.Tensor:
        return self.w2c[..., :3, :3]

    @property
    def t_w2c(self) -> torch.Tensor:
        return self.w2c[..., :3, 3]

    @property
    def campos(self) -> torch.Tensor:
        """Camera center in world coordinates: -R^T t."""
        return -torch.einsum("...ji,...j->...i", self.R_w2c, self.t_w2c)

    def with_delta(self, tau: torch.Tensor) -> "Camera":
        """Apply an SE(3) tangent delta: w2c' = exp(tau) @ w2c (differentiable)."""
        return self.replace(w2c=se3.apply_delta(tau, self.w2c))

    def with_pose(self, R_c2w, t) -> "Camera":
        """The same intrinsics at a new pose (R camera-to-world, t
        world-to-camera), on this camera's device."""
        return self.replace(w2c=w2c_from_rt(_f32(R_c2w, self.device),
                                            _f32(t, self.device)))
