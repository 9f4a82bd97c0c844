"""RGB-D back-projection: point clouds from an image and its depth.

Map initialisation without SfM points, and SLAM-style incremental
extension: the pixels of an RGB-D frame (every ``stride``-th row and
column) are lifted to world points, each with the surface sample spacing
depth * stride / fx, which sets the initial Gaussian scale in place of the
k-NN distance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import sh as sh_lib
from ..core.camera import Camera
from ..core.gaussians import GaussianParams, inverse_sigmoid


def backproject_rgbd(
    camera: Camera,
    rgb,                          # (H, W, 3)
    depth,                        # (H, W) metres, 0 / negative = invalid
    stride: int = 4,
    depth_max: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(points (N, 3) world, colours (N, 3), spacing (N,)) as float32 numpy,
    computed on the camera's device, for the valid sampled pixels
    (1e-3 < depth < depth_max) in row-major order."""
    dev = camera.device
    rgb = torch.as_tensor(rgb, dtype=torch.float32, device=dev)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    h, w = depth.shape
    ys = torch.arange(0, h, stride, device=dev)
    xs = torch.arange(0, w, stride, device=dev)
    d = depth[ys][:, xs]
    c = rgb[ys][:, xs]
    u = xs[None, :].to(torch.float32)
    v = ys[:, None].to(torch.float32)
    x_cam = (u - camera.cx) / camera.fx * d
    y_cam = (v - camera.cy) / camera.fy * d
    pts_cam = torch.stack([x_cam, y_cam, d], dim=-1).reshape(-1, 3)
    valid = ((d > 1e-3) & (d < depth_max)).reshape(-1)
    pts_world = (pts_cam - camera.t_w2c) @ camera.R_w2c    # R^T (p - t)
    spacing = (d * stride / camera.fx).reshape(-1)
    return (pts_world[valid].cpu().numpy(),
            c.reshape(-1, 3)[valid].cpu().numpy(),
            spacing[valid].cpu().numpy())


def extend_gaussians_from_rgbd(
    gaussians: GaussianParams,
    camera: Camera,
    rgb,
    depth,
    stride: int = 8,
    point_size: float = 1.0,
):
    """Back-project an RGB-D keyframe and write its points as new Gaussians
    into the free slots, in slot order (the r-th point into the r-th free
    slot); points past the free count are dropped. Returns (params,
    num_added as a () int32 tensor)."""
    pts, cols, sp = backproject_rgbd(camera, rgb, depth, stride)
    dev = gaussians.device
    free_slots = torch.nonzero(~gaussians.live).squeeze(1)
    k = min(pts.shape[0], int(free_slots.shape[0]))
    target = free_slots[:k]

    def f32(x):
        return torch.as_tensor(np.asarray(x[:k], np.float32), device=dev)

    def put(field: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        out = field.clone()
        out[target] = rows.to(field.dtype)
        return out

    scales = torch.log(torch.clamp_min(f32(sp) * point_size, 1e-7))
    k1 = gaussians.features_rest.shape[1]
    new = gaussians.replace(
        xyz=put(gaussians.xyz, f32(pts)),
        features_dc=put(gaussians.features_dc,
                        sh_lib.rgb_to_sh_dc(f32(cols))[:, None, :]),
        features_rest=put(gaussians.features_rest,
                          torch.zeros((k, k1, 3), device=dev)),
        scaling=put(gaussians.scaling, scales[:, None].repeat(1, 3)),
        rotation=put(gaussians.rotation, torch.tensor(
            [[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(k, 1)),
        opacity=put(gaussians.opacity, inverse_sigmoid(
            torch.full((k, 1), 0.1, device=dev))),
        live=put(gaussians.live, torch.ones(k, dtype=torch.bool,
                                            device=dev)),
    )
    return new, torch.tensor(k, dtype=torch.int32, device=dev)


def gaussians_from_rgbd(
    camera: Camera, rgb, depth, stride: int = 4, sh_degree: int = 3,
    capacity: Optional[int] = None, point_size: float = 1.0,
) -> GaussianParams:
    """A map initialised from one RGB-D frame, on the camera's device:
    scales from the local sample spacing instead of k-NN."""
    pts, cols, sp = backproject_rgbd(camera, rgb, depth, stride)
    return GaussianParams.from_pcd(
        pts, cols, sh_degree=sh_degree, capacity=capacity,
        mean_sq_dist=(sp * point_size) ** 2, device=camera.device)
