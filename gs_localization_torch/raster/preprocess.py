"""Per-Gaussian preprocessing: projection, EWA covariance, culling, SH color.

Vectorized over all P Gaussians and differentiable w.r.t. Gaussian
parameters AND camera inputs (the camera-side gradients drive pose
refinement). Reference math (cuda_rasterizer/forward.cu):

- near cull: view-space z <= 0.2 drops the Gaussian
- projection w-epsilon 1e-7
- Jacobian clamp at 1.3*tan(fov)
- +0.3 low-pass on the cov2D diagonal
- radius = ceil(3*sqrt(max eigenvalue)), eigenvalue floor 0.1
- ndc -> pixel ((v+1)*S - 1)/2
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import sh as sh_lib
from ..core.camera import Camera
from ..core.gaussians import GaussianParams


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all shape (P, ...))."""

    depths: torch.Tensor        # (P,)   view-space z
    means2d: torch.Tensor       # (P, 2) pixel coords
    conic: torch.Tensor         # (P, 3) inverse 2D covariance (a, b, c)
    rgb: torch.Tensor           # (P, 3) view-dependent color
    opacity: torch.Tensor       # (P,)   activated opacity
    radii: torch.Tensor         # (P,)   int32 screen radius (0 = culled)
    rect: torch.Tensor          # (P, 4) int32 tile rect (x0, y0, x1, y1)
    tiles_touched: torch.Tensor  # (P,)  int32
    valid: torch.Tensor         # (P,)  bool


def build_cov3d(scaling: torch.Tensor, rotation_unit: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """Sigma = R S^2 R^T from activated scales and unit wxyz quats. (P, 3, 3)."""
    s = scaling * scale_modifier
    w, x, y, z = (rotation_unit[:, 0], rotation_unit[:, 1],
                  rotation_unit[:, 2], rotation_unit[:, 3])
    R = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )
    RS = R * s[:, None, :]          # R @ diag(s)
    return RS @ RS.transpose(-1, -2)


def _rect_int(v: torch.Tensor, hi: int, finite: torch.Tensor) -> torch.Tensor:
    """clip(v, 0, hi) -> int32, with non-finite rows zeroed BEFORE the cast
    (a NaN cast gives INT_MIN in torch; JAX leaves it platform-defined)."""
    v = torch.clamp(v, 0, hi)
    return torch.where(finite, v, torch.zeros_like(v)).to(torch.int32)


def preprocess(
    gaussians: GaussianParams,
    camera: Camera,
    tile_size: int = 16,
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,
    near_cull: float = 0.2,
) -> Preprocessed:
    xyz = gaussians.xyz                      # (P, 3)
    w2c = camera.w2c
    full_proj = camera.full_proj
    fx, fy = camera.fx, camera.fy
    width, height = camera.width, camera.height
    grid_x = -(-width // tile_size)
    grid_y = -(-height // tile_size)

    # ---- view / clip transforms -------------------------------------
    p_view = xyz @ w2c[:3, :3].T + w2c[:3, 3]            # (P, 3)
    depth = p_view[:, 2]
    p_hom = xyz @ full_proj[:3, :3].T + full_proj[:3, 3]
    p_w_hom = xyz @ full_proj[3, :3] + full_proj[3, 3]
    inv_w = 1.0 / (p_w_hom + 1e-7)
    p_proj = p_hom * inv_w[:, None]

    # ---- 3D covariance -> EWA 2D covariance -------------------------
    cov3d = build_cov3d(gaussians.get_scaling, gaussians.get_rotation,
                        scale_modifier)
    Rw = w2c[:3, :3]
    cov_cam = torch.einsum("ij,pjk,lk->pil", Rw, cov3d, Rw)

    z_safe = torch.where(torch.abs(depth) < 1e-6,
                         torch.full_like(depth, 1e-6), depth)
    lim_x = 1.3 * camera.tan_fovx
    lim_y = 1.3 * camera.tan_fovy
    tx = torch.clamp(p_view[:, 0] / z_safe, -lim_x, lim_x) * z_safe
    ty = torch.clamp(p_view[:, 1] / z_safe, -lim_y, lim_y) * z_safe
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    a = (
        j00 * j00 * cov_cam[:, 0, 0]
        + 2.0 * j00 * j02 * cov_cam[:, 0, 2]
        + j02 * j02 * cov_cam[:, 2, 2]
    ) + 0.3
    b = (
        j00 * j11 * cov_cam[:, 0, 1]
        + j00 * j12 * cov_cam[:, 0, 2]
        + j02 * j11 * cov_cam[:, 1, 2]
        + j02 * j12 * cov_cam[:, 2, 2]
    )
    c = (
        j11 * j11 * cov_cam[:, 1, 1]
        + 2.0 * j11 * j12 * cov_cam[:, 1, 2]
        + j12 * j12 * cov_cam[:, 2, 2]
    ) + 0.3

    det = a * c - b * b
    det_safe = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 0.0)))

    # ---- screen position & tile rect --------------------------------
    px = ((p_proj[:, 0] + 1.0) * width - 1.0) * 0.5
    py = ((p_proj[:, 1] + 1.0) * height - 1.0) * 0.5
    means2d = torch.stack([px, py], dim=-1)

    # Opacity-aware binning radius: beyond r = sqrt(2 ln(255 opa) lambda_max)
    # every pixel fails the blend's alpha >= 1/255 gate, so pairs outside it
    # render exactly nothing. The 3-sigma radius stays for `radii`.
    opacity = gaussians.get_opacity[:, 0]
    r_cull = torch.sqrt(
        torch.clamp_min(2.0 * torch.log(torch.clamp_min(opacity, 1e-30)
                                        * 255.0), 0.0)
        * torch.clamp_min(lambda1, 0.0))
    rad_i = torch.minimum(radius_f, torch.ceil(r_cull))

    # non-finite projections (NaN params, inf radii) must cull, not
    # propagate into the integer tile math
    finite = (torch.isfinite(px) & torch.isfinite(py)
              & torch.isfinite(radius_f) & torch.isfinite(r_cull)
              & torch.isfinite(depth))
    x0 = _rect_int(torch.floor((px - rad_i) / tile_size), grid_x, finite)
    y0 = _rect_int(torch.floor((py - rad_i) / tile_size), grid_y, finite)
    x1 = _rect_int(torch.floor((px + rad_i + tile_size - 1) / tile_size),
                   grid_x, finite)
    y1 = _rect_int(torch.floor((py + rad_i + tile_size - 1) / tile_size),
                   grid_y, finite)

    base_valid = (
        gaussians.live
        & finite
        & (depth > near_cull)
        & (torch.abs(det) > 1e-12)
    )
    area = (x1 - x0) * (y1 - y0)
    valid = base_valid & (area > 0) & (r_cull > 0.0)
    tiles_touched = torch.where(valid, area, torch.zeros_like(area)).to(
        torch.int32)
    # radii/visibility keep the reference's 3-sigma semantics
    rx0 = torch.clamp(torch.floor((px - radius_f) / tile_size), 0, grid_x)
    ry0 = torch.clamp(torch.floor((py - radius_f) / tile_size), 0, grid_y)
    rx1 = torch.clamp(torch.floor((px + radius_f + tile_size - 1) / tile_size),
                      0, grid_x)
    ry1 = torch.clamp(torch.floor((py + radius_f + tile_size - 1) / tile_size),
                      0, grid_y)
    ref_valid = base_valid & ((rx1 - rx0) * (ry1 - ry0) > 0)
    radii = torch.where(ref_valid, radius_f,
                        torch.zeros_like(radius_f)).to(torch.int32)

    # ---- color ------------------------------------------------------
    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        dirs = xyz - camera.campos
        # rsqrt-with-floor: keeps the gradient NaN-free at dirs == 0
        sq = torch.sum(dirs * dirs, dim=-1, keepdim=True)
        dirs = dirs * torch.rsqrt(torch.clamp_min(sq, 1e-20))
        rgb = sh_lib.sh_to_clamped_rgb(gaussians.get_features, dirs,
                                       gaussians.sh_degree)

    return Preprocessed(
        depths=depth,
        means2d=means2d,
        conic=conic,
        rgb=rgb,
        opacity=opacity,
        radii=radii,
        rect=torch.stack([x0, y0, x1, y1], dim=-1),
        tiles_touched=tiles_touched,
        valid=valid,
    )
