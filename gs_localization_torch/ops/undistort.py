"""Image undistortion (OpenCV radial-tangential model).

A source-coordinate map per camera, then a bilinear remap per image, as
plain gathers with the JAX package's edge rule: a sample outside
[0, W-1] x [0, H-1] is zero, and the 2x2 cell is clamped so that the last
row and column interpolate inside the image. (``F.grid_sample``'s
``align_corners`` and padding modes do not give that rule.)

Model (OPENCV params k1 k2 p1 p2 [k3]):
  x' = x(1 + k1 r^2 + k2 r^4 + k3 r^6) + 2 p1 x y + p2 (r^2 + 2 x^2)
  y' = y(1 + k1 r^2 + k2 r^4 + k3 r^6) + p1 (r^2 + 2 y^2) + 2 p2 x y
"""

from __future__ import annotations

import torch

from .. import resolve_device


def undistort_map(width: int, height: int, fx, fy, cx, cy,
                  k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
                  device="cuda") -> torch.Tensor:
    """(H, W, 2) float32 source pixel coordinates (u, v) of each
    undistorted target pixel, on ``device``."""
    device = resolve_device(device)
    xs = (torch.arange(width, dtype=torch.float32, device=device) - cx) / fx
    ys = (torch.arange(height, dtype=torch.float32, device=device) - cy) / fy
    x = xs[None, :].expand(height, width)
    y = ys[:, None].expand(height, width)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd * fx + cx, yd * fy + cy], dim=-1)


def remap_bilinear(image: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` (H, W[, C]) at ``src`` (H', W', 2) float
    coordinates; out-of-bounds samples are zero."""
    h, w = image.shape[:2]
    u, v = src[..., 0], src[..., 1]
    valid = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u = torch.clamp(u, 0.0, float(w - 1))
    v = torch.clamp(v, 0.0, float(h - 1))
    x0 = torch.clamp(torch.floor(u).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(v).to(torch.int64), 0, h - 2)
    fx_ = u - x0
    fy_ = v - y0
    if image.dim() == 3:
        fx_, fy_, valid = fx_[..., None], fy_[..., None], valid[..., None]
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    out = (image[y0, x0] * (1 - fx_) * (1 - fy_) + image[y0, x1] * fx_
           * (1 - fy_) + image[y1, x0] * (1 - fx_) * fy_
           + image[y1, x1] * fx_ * fy_)
    return torch.where(valid, out, torch.zeros_like(out))


def undistort_image(image: torch.Tensor, fx, fy, cx, cy,
                    dist_params) -> torch.Tensor:
    """Build the map for ``image``'s size and remap it, on its device."""
    h, w = image.shape[:2]
    k = list(dist_params) + [0.0] * (5 - len(dist_params))
    src = undistort_map(w, h, fx, fy, cx, cy, *k[:5], device=image.device)
    return remap_bilinear(image, src)
