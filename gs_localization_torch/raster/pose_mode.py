"""Pose-mode rendering: per-pair projection with no per-iteration gather.

The pose-refinement loop renders the same Gaussians ~50 times while the
pose moves by ~1e-3 per step, so the loop is restructured:

  per rebin : preprocess + stream binning at the current pose, then ONE
              gather of pose-INDEPENDENT params per pair (xyz, cov3d, opacity,
              rgb frozen at the rebin view direction) into the aligned pair
              stream (``StreamPairPack``; per-tile lists never truncated).
  per iter  : project each pair ELEMENTWISE under the current pose (the
              preprocess math) and blend the stream. The stream cotangent
              reduces onto the 24 pose scalars (w2c rows 0-2, full_proj
              rows 0, 1, 3) and autograd chains it to the 6-dim camera
              tangent: no scatter in the backward.

The stream's projection has two implementations, chosen by the device of
the tensors: CUDA tensors launch the hand-written kernels of
``csrc/pose_project.cu`` (P1 projects the positions below ``kept_al``,
read on the device, and zeroes the rest; P2 is its analytic adjoint,
reduced onto the pose in a fixed order), or raise; CPU tensors take the
plain versions (``_project_core`` by autograd over every position, and
``_project_adjoint``, the adjoint P2 computes, as PyTorch ops), which are
the yardstick the kernels are held against on the card. The pose vector
they take (``camera_vectors``) is likewise V1 of ``csrc/pose_algebra.cu``
for a CUDA camera, with its adjoint V2, and tensor ops elsewhere.

The capped ``PairPack`` layout (``use_stream=False``) gathers the same
params into per-tile (T, 16, max_per_tile) windows once per rebin, and
blends them with the pregathered kernels (K3/K4).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._kernels import check_tensor, launch
from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..utils.profiling import count, note, span
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


class _Terms(NamedTuple):
    """``_project_core``'s intermediates that its outputs and its adjoint
    read."""

    vz: torch.Tensor
    hx: torch.Tensor
    hy: torch.Tensor
    inv_w: torch.Tensor
    rows: tuple            # (r0, r1, r2): the rows of R C, 3 arrays each
    v00: torch.Tensor
    v01: torch.Tensor
    v02: torch.Tensor
    v11: torch.Tensor
    v12: torch.Tensor
    v22: torch.Tensor
    z_safe: torch.Tensor
    ux: torch.Tensor       # vx / z_safe
    uy: torch.Tensor
    lim_x: torch.Tensor
    lim_y: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    inv_z: torch.Tensor
    inv_z2: torch.Tensor
    j00: torch.Tensor
    j02: torch.Tensor
    j11: torch.Tensor
    j12: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    det: torch.Tensor
    inv_det: torch.Tensor


def _project_terms(camera: Camera, x, y, z, c00, c01, c02, c11, c12,
                   c22) -> _Terms:
    """The per-Gaussian preprocess math under the current pose, its
    intermediates kept: ``_project_core``'s forward and what its adjoint
    (``_project_adjoint``) recomputes."""
    w2c = camera.w2c
    fx, fy = camera.fx, camera.fy
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
    ux = vx / z_safe
    uy = vy / z_safe
    tx = torch.clamp(ux, -lim_x, lim_x) * z_safe
    ty = torch.clamp(uy, -lim_y, lim_y) * z_safe
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
    return _Terms(vz, hx, hy, inv_w, (r0, r1, r2), v00, v01, v02, v11, v12,
                  v22, z_safe, ux, uy, lim_x, lim_y, tx, ty, inv_z, inv_z2,
                  j00, j02, j11, j12, a, b, c, det, inv_det)


def _project_core(camera: Camera, x, y, z, c00, c01, c02, c11, c12, c22,
                  prep_valid, near_cull: float = 0.2):
    """Elementwise per-pair projection under the current pose: the
    per-Gaussian preprocess math on arrays of any shape, differentiable
    w.r.t. the camera. Returns (px, py, conic_a, conic_b, conic_c, valid_f,
    view_z)."""
    q = _project_terms(camera, x, y, z, c00, c01, c02, c11, c12, c22)
    px = ((q.hx * q.inv_w + 1.0) * camera.width - 1.0) * 0.5
    py = ((q.hy * q.inv_w + 1.0) * camera.height - 1.0) * 0.5
    valid = ((prep_valid > 0.5) & (q.vz > near_cull)
             & (torch.abs(q.det) > 1e-12))
    return (px, py, q.c * q.inv_det, -q.b * q.inv_det, q.a * q.inv_det,
            valid.to(torch.float32), q.vz)


def _project_adjoint(params: torch.Tensor, kept_al: torch.Tensor,
                     camera: Camera, dstream: torch.Tensor) -> torch.Tensor:
    """The plain version of P2 (``csrc/pose_project.cu``): the hand-derived
    adjoint of ``_project_core`` over a (16, N) stream, from the stream
    cotangent ``dstream`` (blend-layout rows; rows 0-4 and 11 carry a pose
    gradient) at the positions below ``kept_al``, onto the (24,) camera
    vector [w2c rows 0-2, full_proj rows 0, 1, 3]. Autograd's conventions:
    the clamp passes the gradient only inside its limits (inclusive), each
    ``torch.where`` routes it to the branch it took. Per-position terms in
    the params' dtype, summed in float64."""
    with torch.no_grad():
        x, y, z = params[_PX], params[_PY], params[_PZ]
        q = _project_terms(camera, x, y, z, params[_C00], params[_C01],
                           params[_C02], params[_C11], params[_C12],
                           params[_C22])
        gpx, gpy, goa, gob, goc = dstream[0], dstream[1], dstream[2], \
            dstream[3], dstream[4]
        sx, sy = 0.5 * camera.width, 0.5 * camera.height
        # px = ((hx inv_w + 1) W - 1) / 2, inv_w = 1 / (hw + 1e-7)
        ghx = gpx * sx * q.inv_w
        ghy = gpy * sy * q.inv_w
        ginv_w = gpx * sx * q.hx + gpy * sy * q.hy
        ghw = -ginv_w * q.inv_w * q.inv_w
        # conic (c, -b, a) * inv_det; the determinant's guard routes nothing
        ga, gb, gc = goc * q.inv_det, -gob * q.inv_det, goa * q.inv_det
        ginv_det = goa * q.c - gob * q.b + goc * q.a
        gdet = torch.where(torch.abs(q.det) < 1e-12, torch.zeros_like(q.det),
                           -ginv_det * q.inv_det * q.inv_det)
        ga = ga + gdet * q.c
        gc = gc + gdet * q.a
        gb = gb - 2.0 * gdet * q.b
        # 2-D covariance J V J^T + 0.3 I
        j00, j02, j11, j12 = q.j00, q.j02, q.j11, q.j12
        gv00 = ga * j00 * j00
        gv01 = gb * j00 * j11
        gv02 = 2.0 * ga * j00 * j02 + gb * j00 * j12
        gv11 = gc * j11 * j11
        gv12 = gb * j02 * j11 + 2.0 * gc * j11 * j12
        gv22 = ga * j02 * j02 + gb * j02 * j12 + gc * j12 * j12
        gj00 = 2.0 * ga * (j00 * q.v00 + j02 * q.v02) \
            + gb * (j11 * q.v01 + j12 * q.v02)
        gj02 = 2.0 * ga * (j00 * q.v02 + j02 * q.v22) \
            + gb * (j11 * q.v12 + j12 * q.v22)
        gj11 = gb * (j00 * q.v01 + j02 * q.v12) \
            + 2.0 * gc * (j11 * q.v11 + j12 * q.v12)
        gj12 = gb * (j00 * q.v02 + j02 * q.v22) \
            + 2.0 * gc * (j11 * q.v12 + j12 * q.v22)
        # Jacobian: j00 = fx / z, j02 = -fx tx / z^2 (and y)
        fx, fy = camera.fx, camera.fy
        ginv_z2 = -(gj02 * fx * q.tx + gj12 * fy * q.ty)
        ginv_z = gj00 * fx + gj11 * fy + 2.0 * ginv_z2 * q.inv_z
        gtx = -gj02 * fx * q.inv_z2
        gty = -gj12 * fy * q.inv_z2
        # tx = clamp(vx / z_safe) z_safe
        zero = torch.zeros_like(gtx)
        gux = torch.where((q.ux >= -q.lim_x) & (q.ux <= q.lim_x),
                          gtx * q.z_safe, zero)
        guy = torch.where((q.uy >= -q.lim_y) & (q.uy <= q.lim_y),
                          gty * q.z_safe, zero)
        gzs = (-ginv_z * q.inv_z * q.inv_z
               + gtx * torch.clamp(q.ux, -q.lim_x, q.lim_x)
               + gty * torch.clamp(q.uy, -q.lim_y, q.lim_y)
               - (gux * q.ux + guy * q.uy) / q.z_safe)
        gv = (gux / q.z_safe, guy / q.z_safe,
              dstream[11] + torch.where(torch.abs(q.vz) < 1e-6, zero, gzs))
        # w2c: v_i = W_i . (x, y, z, 1) and V = R C R^T through r_i = R_i C:
        # dV_ij / dR_k = [k == i] r_j + [k == j] r_i
        S = ((2.0 * gv00, gv01, gv02), (gv01, 2.0 * gv11, gv12),
             (gv02, gv12, 2.0 * gv22))
        X = (x, y, z)
        terms = []
        for i in range(3):
            terms += [gv[i] * X[k] + S[i][0] * q.rows[0][k]
                      + S[i][1] * q.rows[1][k] + S[i][2] * q.rows[2][k]
                      for k in range(3)]
            terms.append(gv[i])
        for gh in (ghx, ghy, ghw):
            terms += [gh * X[k] for k in range(3)]
            terms.append(gh)
        terms = torch.stack(terms)                          # (24, N)
        live = torch.arange(terms.shape[1], device=terms.device) < kept_al
        terms = torch.where(live, terms, torch.zeros_like(terms))
        return terms.sum(dim=1, dtype=torch.float64).to(params.dtype)


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


def _project_stream_plain(params: torch.Tensor, camera: Camera,
                          near_cull: float = 0.2) -> torch.Tensor:
    """``_project_core`` over every column of a (16, N) stream, as PyTorch
    ops (autograd gives the backward). Dead positions (all-zero params)
    project to valid == 0 (prep_valid == 0)."""
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


_GRAD = 24          # pose scalars: w2c rows 0-2, full_proj rows 0, 1, 3
_THREADS = 256
_BWD_BLOCKS = 1024  # P2's first-pass grid at most (its partials' rows)


def _camera_vectors_plain(camera: Camera
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``camera_vectors`` by tensor ops on the camera's device (no host
    read); the plain version of V1."""
    fp = camera.full_proj
    pose = torch.cat([camera.w2c[:3], fp[0:2], fp[3:4]]).reshape(_GRAD)
    intr = torch.stack([camera.fx, camera.fy, camera.tan_fovx,
                        camera.tan_fovy])
    return pose, intr


def _camera_vectors_adjoint(camera: Camera,
                            gpose: torch.Tensor) -> torch.Tensor:
    """The plain version of V2 (``csrc/pose_algebra.cu``): the (24,) pose
    vector's cotangent onto w2c's (4, 4), rows 0-2 directly plus
    projection^T applied to the full_proj rows 0, 1 and 3."""
    with torch.no_grad():
        zero = torch.zeros_like(gpose[:4])
        gfp = torch.cat([gpose[12:20], zero, gpose[20:]]).reshape(4, 4)
        direct = torch.cat([gpose[:12], zero]).reshape(4, 4)
        return camera.projection.T @ gfp + direct


def _intrinsics(camera: Camera, dev) -> tuple:
    """fx, fy, cx, cy, checked as V1/V2 take them: 0-d float32 on ``dev``,
    constants."""
    vals = (camera.fx, camera.fy, camera.cx, camera.cy)
    for name, v in zip(("fx", "fy", "cx", "cy"), vals):
        check_tensor(v, name, torch.float32, (), dev)
        if v.requires_grad:
            raise ValueError("the CUDA camera vectors differentiate the pose "
                             "only; the intrinsics must not require grad")
    return vals


def pose_vectors_fwd_cuda(camera: Camera
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch V1: ``camera_vectors``' (24,) pose and (4,) intrinsics."""
    w2c = camera.w2c.contiguous()
    dev = w2c.device
    check_tensor(w2c, "w2c", torch.float32, (4, 4), dev)
    pose = torch.empty(_GRAD, dtype=torch.float32, device=dev)
    intr = torch.empty(4, dtype=torch.float32, device=dev)
    launch("pose_vectors_fwd", dev, w2c, *_intrinsics(camera, dev),
           camera.width, camera.height, camera.znear, camera.zfar, pose, intr)
    return pose, intr


def pose_vectors_bwd_cuda(camera: Camera,
                          gpose: torch.Tensor) -> torch.Tensor:
    """Launch V2: the pose vector's cotangent onto w2c's (4, 4);
    ``_camera_vectors_adjoint`` is its plain version."""
    dev = gpose.device
    check_tensor(gpose, "gpose", torch.float32, (_GRAD,), dev)
    g_w2c = torch.empty((4, 4), dtype=torch.float32, device=dev)
    launch("pose_vectors_bwd", dev, *_intrinsics(camera, dev), camera.width,
           camera.height, camera.znear, camera.zfar, gpose, g_w2c)
    return g_w2c


class _CameraVectors(torch.autograd.Function):
    """V1 forward, V2 backward: the gradient reaches w2c only (the
    intrinsics are constants)."""

    @staticmethod
    def forward(ctx, w2c, camera):
        # w2c is camera.w2c, passed for autograd to see it
        ctx.camera = camera
        pose, intr = pose_vectors_fwd_cuda(camera)
        ctx.mark_non_differentiable(intr)
        return pose, intr

    @staticmethod
    def backward(ctx, gpose, gintr):
        return pose_vectors_bwd_cuda(ctx.camera, gpose.contiguous()), None


def camera_vectors(camera: Camera) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pose as the kernels take it, on the camera's device with no host
    read: (24,) [w2c rows 0-2, full_proj rows 0, 1, 3], differentiable, and
    (4,) [fx, fy, tan_fovx, tan_fovy], constants. A CUDA camera launches V1
    (V2 in the backward), and raises unless its pose is (4, 4) float32 and
    its intrinsics 0-d float32 that do not require grad; a camera elsewhere
    takes the tensor ops (``_camera_vectors_plain``)."""
    if camera.w2c.is_cuda:
        return _CameraVectors.apply(camera.w2c, camera)
    return _camera_vectors_plain(camera)


def _check_inputs(params, kept_al, pose, intr) -> None:
    dev = params.device
    if not params.is_cuda:
        raise ValueError(f"the CUDA pose projection takes CUDA tensors, got "
                         f"{dev}")
    if params.dim() != 2 or params.shape[0] != 16:
        raise ValueError(f"params: shape {tuple(params.shape)}, expected "
                         f"(16, N)")
    check_tensor(params, "params", torch.float32, params.shape, dev)
    check_tensor(kept_al, "kept_al", torch.int32, (), dev)
    check_tensor(pose, "pose", torch.float32, (_GRAD,), dev)
    check_tensor(intr, "intr", torch.float32, (4,), dev)


def pose_project_fwd_cuda(params, kept_al, pose, intr, width: int,
                          height: int, near_cull: float) -> torch.Tensor:
    """Launch P1: (16, N) params -> (16, N) blend-layout stream rows,
    ``_project_core``'s at positions below ``kept_al``, zero past it."""
    _check_inputs(params, kept_al, pose, intr)
    n = params.shape[1]
    out = torch.empty_like(params)
    launch("pose_project_fwd", params.device, params, kept_al, pose, intr,
           n, width, height, near_cull, out)
    return out


def pose_project_bwd_cuda(params, kept_al, pose, intr, dstream, width: int,
                          height: int) -> torch.Tensor:
    """Launch P2 (its two passes): the (24,) gradient of ``pose`` from the
    stream cotangent ``dstream`` at the positions below ``kept_al``;
    ``_project_adjoint`` is its plain version."""
    _check_inputs(params, kept_al, pose, intr)
    n = params.shape[1]
    check_tensor(dstream, "dstream", torch.float32, params.shape,
                 params.device)
    blocks = max(1, min(-(-n // _THREADS), _BWD_BLOCKS))
    partials = torch.empty((blocks, _GRAD), dtype=torch.float64,
                           device=params.device)
    grad = torch.empty(_GRAD, dtype=torch.float32, device=params.device)
    launch("pose_project_bwd", params.device, params, kept_al, pose, intr,
           dstream, n, width, height, partials, blocks, grad)
    return grad


class _PoseProject(torch.autograd.Function):
    """P1 forward, P2 backward: the gradient reaches the pose vector only
    (the params are pose-independent and the intrinsics constant)."""

    @staticmethod
    def forward(ctx, params, kept_al, pose, intr, width, height, near_cull):
        ctx.save_for_backward(params, kept_al, pose, intr)
        ctx.size = (width, height)
        return pose_project_fwd_cuda(params, kept_al, pose, intr, width,
                                     height, near_cull)

    @staticmethod
    def backward(ctx, dstream):
        params, kept_al, pose, intr = ctx.saved_tensors
        grad = pose_project_bwd_cuda(params, kept_al, pose, intr,
                                     dstream.contiguous(), *ctx.size)
        return None, None, grad, None, None, None, None


def _project_stream(params: torch.Tensor, kept_al: torch.Tensor,
                    camera: Camera, near_cull: float = 0.2) -> torch.Tensor:
    """(16, N) stream params + pose -> (16, N) blend-layout stream rows
    [x, y, a, b, c, opa, valid, pad, r, g, b, depth, 0, 0, 0, 0].

    CUDA tensors launch P1 (forward) and P2 (backward) of
    ``csrc/pose_project.cu`` over the positions below ``kept_al``, zero
    past it, or raise; CPU tensors take the plain version
    (``_project_stream_plain``, every position)."""
    if params.is_cuda:
        pose, intr = camera_vectors(camera)
        return _PoseProject.apply(params, kept_al, pose, intr, camera.width,
                                  camera.height, near_cull)
    if params.device.type == "cpu":
        return _project_stream_plain(params, camera, near_cull)
    raise ValueError(f"unsupported device {params.device}")


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
    ``rebin/gather`` (the pose-independent rows and ``assemble_stream``);
    counts the stream's columns, which every iteration's projection runs
    over, as ``stream_slots`` and notes its live aligned length
    ``kept_al`` (the device scalar, read once the profile is over) on the
    enclosing span."""
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
    count("stream_slots", params.shape[1])
    note(kept_al=sbins.kept_al)
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
    a ``StreamPairPack`` (K1/K2) or a ``PairPack`` (K3/K4). Spans: the
    per-pair projection's forward ``render/project``, the blend and the
    images ``render/blend``."""
    ts = config.tile_size
    chunk = config.pallas_chunk
    grid_x = -(-camera.width // ts)
    if isinstance(pack, PairPack):
        with span("render/project"):
            geom, rgbd = _project_pairs(pack.params, camera)
        with span("render/blend"):
            out = blend_pregathered_pallas(pack.counts, geom, rgbd, grid_x,
                                           ts, chunk=chunk)
            return composite(out, camera, ts, bg)
    if not isinstance(pack, StreamPairPack):
        raise TypeError(f"expected a StreamPairPack or a PairPack, got "
                        f"{type(pack).__name__}")
    if pack.align != chunk:
        raise ValueError(f"pack aligned to {pack.align}, blend chunk {chunk}: "
                         "the backward needs align == chunk")
    with span("render/project"):
        stream_t = _project_stream(pack.params, pack.kept_al, camera)
    with span("render/blend"):
        out = stream_blend.blend_stream_direct(
            stream_t, pack.tstart, pack.walk_counts, pack.kept_al, grid_x,
            ts, chunk=chunk)
        return composite(out, camera, ts, bg)
