"""Pose-mode rendering: per-pair projection with no per-iteration gather.

The pose-refinement loop renders the same Gaussians ~50 times while the
pose moves by ~1e-3 per step, so the loop is restructured:

  per rebin : preprocess + stream binning at the current pose, then ONE
              gather of pose-INDEPENDENT params per pair (xyz, cov3d, opacity,
              rgb frozen at the rebin view direction) into the aligned pair
              stream (``StreamPairPack``; per-tile lists never truncated).
  per iter  : project each pair ELEMENTWISE under the current pose (the
              preprocess math) and blend the stream. The stream cotangent
              chains through the elementwise projection to the 6-dim camera
              tangent by autograd: no scatter in the backward.

The capped ``PairPack`` layout (``use_stream=False``) gathers the same
params into per-tile (T, 16, max_per_tile) windows once per rebin, and
blends them with the pregathered kernels (K3/K4).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..utils.profiling import span
from . import stream_blend
from .pallas_blend import blend_pregathered_pallas
from .preprocess import build_cov3d, preprocess
from .rasterize import (RasterizerConfig, bin_gaussians_for, bin_stream_for,
                        composite)


class PairPack(NamedTuple):
    """Pose-independent params per pair in per-tile windows (capped)."""

    params: torch.Tensor     # (T, 16, cap) rows as StreamPairPack's
    counts: torch.Tensor     # (T,) int32
    overflow: torch.Tensor   # () bool


class StreamPairPack(NamedTuple):
    """Pose-independent params laid out as an ALIGNED pair stream.

    Rows (16, MR_AL+chunk): 0..2 xyz, 3..8 cov3d (upper triangle), 9
    opacity, 10 valid, 11..13 rgb (frozen at the rebin view dir), 14..15
    pad. Dead positions (alignment gaps / truncated tail) are all-zero.
    """

    params: torch.Tensor       # (16, MR_AL+chunk) transposed stream rows
    tstart: torch.Tensor       # (num_tiles,) int32 aligned tile starts
    walk_counts: torch.Tensor  # (num_tiles,) int32
    kept_al: torch.Tensor      # () int32 live aligned-stream length
    overflow: torch.Tensor     # () bool
    align: int = 256           # window alignment the stream was built with


# param rows
_PX, _PY, _PZ = 0, 1, 2
_C00, _C01, _C02, _C11, _C12, _C22 = 3, 4, 5, 6, 7, 8
_POPA, _PVALID, _PR, _PG, _PB = 9, 10, 11, 12, 13


def _project_core(camera: Camera, x, y, z, c00, c01, c02, c11, c12, c22,
                  prep_valid, near_cull: float = 0.2):
    """Elementwise per-pair projection under the current pose: the
    per-Gaussian preprocess math on arrays of any shape, differentiable
    w.r.t. the camera. Returns (px, py, conic_a, conic_b, conic_c, valid_f,
    view_z)."""
    w2c = camera.w2c
    fx, fy = camera.fx, camera.fy
    width, height = camera.width, camera.height
    R, t = w2c[:3, :3], w2c[:3, 3]
    vx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    vy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    vz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]

    # clip projection through full_proj (row-major, as in preprocess)
    FP = camera.full_proj
    hx = FP[0, 0] * x + FP[0, 1] * y + FP[0, 2] * z + FP[0, 3]
    hy = FP[1, 0] * x + FP[1, 1] * y + FP[1, 2] * z + FP[1, 3]
    hw = FP[3, 0] * x + FP[3, 1] * y + FP[3, 2] * z + FP[3, 3]
    inv_w = 1.0 / (hw + 1e-7)
    px = ((hx * inv_w + 1.0) * width - 1.0) * 0.5
    py = ((hy * inv_w + 1.0) * height - 1.0) * 0.5

    # cov3d rows -> camera frame: Vc = R C R^T, needed entries only
    def rowmul(i):
        m0 = R[i, 0] * c00 + R[i, 1] * c01 + R[i, 2] * c02
        m1 = R[i, 0] * c01 + R[i, 1] * c11 + R[i, 2] * c12
        m2 = R[i, 0] * c02 + R[i, 1] * c12 + R[i, 2] * c22
        return m0, m1, m2

    r0, r1, r2 = rowmul(0), rowmul(1), rowmul(2)

    def dot(row, j):
        return row[0] * R[j, 0] + row[1] * R[j, 1] + row[2] * R[j, 2]

    v00, v01, v02 = dot(r0, 0), dot(r0, 1), dot(r0, 2)
    v11, v12 = dot(r1, 1), dot(r1, 2)
    v22 = dot(r2, 2)

    z_safe = torch.where(torch.abs(vz) < 1e-6, torch.full_like(vz, 1e-6), vz)
    lim_x = 1.3 * camera.tan_fovx
    lim_y = 1.3 * camera.tan_fovy
    tx = torch.clamp(vx / z_safe, -lim_x, lim_x) * z_safe
    ty = torch.clamp(vy / z_safe, -lim_y, lim_y) * z_safe
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    a = j00 * j00 * v00 + 2.0 * j00 * j02 * v02 + j02 * j02 * v22 + 0.3
    b = j00 * j11 * v01 + j00 * j12 * v02 + j02 * j11 * v12 \
        + j02 * j12 * v22
    c = j11 * j11 * v11 + 2.0 * j11 * j12 * v12 + j12 * j12 * v22 + 0.3

    det = a * c - b * b
    det_safe = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    valid = (prep_valid > 0.5) & (vz > near_cull) & (torch.abs(det) > 1e-12)
    return (px, py, c * inv_det, -b * inv_det, a * inv_det,
            valid.to(torch.float32), vz)


def _project_pairs(params: torch.Tensor, camera: Camera,
                   near_cull: float = 0.2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, 16, cap) params + pose -> (geom (T,8,cap), rgbd (T,4,cap))."""
    px, py, ia, ib, ic, validf, vz = _project_core(
        camera, params[:, _PX], params[:, _PY], params[:, _PZ],
        params[:, _C00], params[:, _C01], params[:, _C02],
        params[:, _C11], params[:, _C12], params[:, _C22],
        params[:, _PVALID], near_cull)
    geom = torch.stack([px, py, ia, ib, ic, params[:, _POPA], validf,
                        torch.zeros_like(px)], dim=1)
    rgbd = torch.stack([params[:, _PR], params[:, _PG], params[:, _PB], vz],
                       dim=1)
    return geom, rgbd


def _project_stream(params: torch.Tensor, camera: Camera,
                    near_cull: float = 0.2) -> torch.Tensor:
    """(16, N) stream params + pose -> (16, N) blend-layout stream rows
    [x, y, a, b, c, opa, valid, pad, r, g, b, depth, 0, 0, 0, 0]. Dead
    positions (all-zero params) project to valid == 0 (det == 0)."""
    px, py, ia, ib, ic, validf, vz = _project_core(
        camera, params[_PX], params[_PY], params[_PZ],
        params[_C00], params[_C01], params[_C02],
        params[_C11], params[_C12], params[_C22],
        params[_PVALID], near_cull)
    zero = torch.zeros_like(px)
    return torch.stack(
        [px, py, ia, ib, ic, params[_POPA], validf, zero,
         params[_PR], params[_PG], params[_PB], vz,
         zero, zero, zero, zero], dim=0)


def _param_pack(gaussians: GaussianParams, prep,
                config: RasterizerConfig) -> torch.Tensor:
    """(P, 14) pose-independent rows: xyz, cov3d, opacity, valid, rgb."""
    cov3d = build_cov3d(gaussians.get_scaling, gaussians.get_rotation,
                        config.scale_modifier)
    return torch.stack(
        [gaussians.xyz[:, 0], gaussians.xyz[:, 1], gaussians.xyz[:, 2],
         cov3d[:, 0, 0], cov3d[:, 0, 1], cov3d[:, 0, 2],
         cov3d[:, 1, 1], cov3d[:, 1, 2], cov3d[:, 2, 2],
         prep.opacity, prep.valid.to(torch.float32),
         prep.rgb[:, 0], prep.rgb[:, 1], prep.rgb[:, 2]],
        dim=1)


@torch.no_grad()
def build_pair_pack(
    gaussians: GaussianParams,
    camera: Camera,
    config: RasterizerConfig,
) -> PairPack:
    """Preprocess + bin at the given pose, gather params per pair ONCE into
    per-tile windows of ``max_per_tile`` lanes."""
    prep = preprocess(gaussians, camera, tile_size=config.tile_size,
                      scale_modifier=config.scale_modifier)
    bins = bin_gaussians_for(prep, camera, config)
    pack = _param_pack(gaussians, prep, config)
    pack = torch.cat([pack, pack.new_zeros((pack.shape[0], 2))], dim=1)
    return PairPack(params=pack[bins.tile_gid.long()].transpose(1, 2)
                    .contiguous(),                         # (T, 16, cap)
                    counts=bins.tile_counts,
                    overflow=bins.overflow | bins.tile_overflow)


@torch.no_grad()
def build_stream_pair_pack(
    gaussians: GaussianParams,
    camera: Camera,
    config: RasterizerConfig,
) -> StreamPairPack:
    """Preprocess + stream-bin at the given pose, gather params ONCE into
    the aligned pair stream. No per-tile cap. Spans ``rebin/preprocess``,
    ``rebin/bin`` (``bin_stream``: the sorts, the search, the binning
    kernels' segment expansions) and
    ``rebin/gather`` (the pose-independent rows and ``assemble_stream``)."""
    chunk = config.pallas_chunk
    with span("rebin/preprocess"):
        prep = preprocess(gaussians, camera, tile_size=config.tile_size,
                          scale_modifier=config.scale_modifier)
    with span("rebin/bin"):
        sbins = bin_stream_for(prep, camera, config)
    with span("rebin/gather"):
        pack = _param_pack(gaussians, prep, config)
        # dead positions: zero params -> det == 0 -> gated out of the blend
        params = stream_blend.assemble_stream(pack, sbins.gid_of_pos, chunk)
    return StreamPairPack(
        params=params,
        tstart=sbins.tstart,
        walk_counts=sbins.walk_counts,
        kept_al=sbins.kept_al,
        overflow=sbins.overflow | sbins.tile_overflow,
        align=sbins.align,
    )


def render_pose_mode(
    pack,
    camera: Camera,
    config: RasterizerConfig,
    bg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (color (H,W,3), depth (H,W), alpha (H,W)) at the given pose, from
    a ``StreamPairPack`` (K1/K2) or a ``PairPack`` (K3/K4)."""
    ts = config.tile_size
    chunk = config.pallas_chunk
    grid_x = -(-camera.width // ts)
    if isinstance(pack, PairPack):
        geom, rgbd = _project_pairs(pack.params, camera)
        out = blend_pregathered_pallas(pack.counts, geom, rgbd, grid_x, ts,
                                       chunk=chunk)
        return composite(out, camera, ts, bg)
    if not isinstance(pack, StreamPairPack):
        raise TypeError(f"expected a StreamPairPack or a PairPack, got "
                        f"{type(pack).__name__}")
    if pack.align != chunk:
        raise ValueError(f"pack aligned to {pack.align}, blend chunk {chunk}: "
                         "the backward needs align == chunk")
    stream_t = _project_stream(pack.params, camera)
    out = stream_blend.blend_stream_direct(
        stream_t, pack.tstart, pack.walk_counts, pack.kept_al, grid_x, ts,
        chunk=chunk)
    return composite(out, camera, ts, bg)
