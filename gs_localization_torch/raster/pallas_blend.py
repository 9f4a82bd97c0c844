"""Pregathered blend: per-tile windows gathered before the blend.

forward   (K3) each 16x16 tile walks its own window geom (8, cap) rows
          [x, y, a, b, c, opa, valid, pad] and rgbd (4, cap) rows
          [r, g, b, depth] front to back, in chunks of ``min(chunk, cap)``
          pairs, over its first ``count`` lanes, and stops after the first
          chunk at whose end every pixel has T < 1e-4.
backward  (K4) walks the visited chunks in reverse from the residuals and
          writes per-pair dL/d(geom rows 0-5) and dL/d(rgbd), summed over
          the tile's pixels, into the tile's own (8, cap) and (4, cap)
          blocks; lanes it does not visit are zero.

Two implementations of each, chosen by the device of the tensors:

- CUDA tensors launch the hand-written kernels of ``csrc/pallas_blend.cu``
  (built at first use, ``_kernels.py``), or raise;
- CPU tensors take the plain PyTorch versions below
  (``pregathered_blend_fwd_plain`` / ``pregathered_blend_bwd_plain``), which
  are also the yardstick the kernels are held against on the card. A
  pregathered window is a gathered stream window, so they reuse the stream
  blend's ``_fwd_block``.

Callers: the training path's ``blend_tiles_pallas`` (one packed row gather
``pack[tile_gid]``; gradients reach the Gaussians through PyTorch's adjoint
of that gather) and pose mode's ``PairPack`` (``blend_pregathered_pallas``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import LAUNCHES
from .. import _kernels
from .blend import TileBlendOut
from .stream_blend import (_blocks, _check, _fwd_block, _pixel_coords,
                           _raise_on, _tile_out)

_GEOM_ROWS = 8
_RGBD_ROWS = 4
_TILE = 16          # the kernels run one 256-thread CTA per 16x16 tile


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _counts(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """The kernels' clamp: a corrupt count never indexes past the window."""
    return torch.clamp(counts.long(), 0, cap)


def _window_block(geom, rgbd, count, chunk: int):
    """(12, B, K*chunk) rows of a block of tiles, cut to the chunks the
    longest list of the block needs."""
    k_max = int(torch.div(count + chunk - 1, chunk,
                          rounding_mode="floor").max()) if count.numel() else 0
    win = torch.cat([geom[:, :, :k_max * chunk], rgbd[:, :, :k_max * chunk]],
                    dim=1)
    return win.transpose(0, 1)


def pregathered_blend_fwd_plain(counts: torch.Tensor, geom: torch.Tensor,
                                rgbd: torch.Tensor, grid_x: int, ts: int,
                                chunk: int, dtype=torch.float32):
    """K3's outputs in plain PyTorch: accum (T,4,npix), log_t (T,npix,1),
    resid (T,npix,2) = [log_full, k_stop], computed in ``dtype`` (float64
    is the yardstick for the float32 versions)."""
    num_tiles, _, cap = geom.shape
    npix = ts * ts
    count = _counts(counts, cap)
    tiles = torch.arange(num_tiles, device=geom.device)
    geom, rgbd = geom.to(dtype), rgbd.to(dtype)
    out = dict(dtype=dtype, device=geom.device)
    accum = torch.zeros((num_tiles, 4, npix), **out)
    log_t = torch.zeros((num_tiles, npix, 1), **out)
    resid = torch.zeros((num_tiles, npix, 2), **out)
    for lo, hi in _blocks(num_tiles, npix, chunk):
        win = _window_block(geom[lo:hi], rgbd[lo:hi], count[lo:hi], chunk)
        px, py = _pixel_coords(tiles[lo:hi], grid_x, ts)
        acc, log_app, log_full, k_stop = _fwd_block(win, count[lo:hi], px, py,
                                                    chunk)
        accum[lo:hi] = acc
        log_t[lo:hi, :, 0] = log_app
        resid[lo:hi, :, 0] = log_full
        resid[lo:hi, :, 1] = k_stop.to(dtype)[:, None]
    return accum, log_t, resid


def pregathered_blend_bwd_plain(counts: torch.Tensor, geom: torch.Tensor,
                                rgbd: torch.Tensor, gacc: torch.Tensor,
                                glogt: torch.Tensor, grid_x: int, ts: int,
                                chunk: int, dtype=torch.float32):
    """K4's (dgeom (T,8,cap), drgbd (T,4,cap)) in plain PyTorch: autograd
    through the plain forward, one block of tiles at a time, in ``dtype``.
    Lanes past a tile's count or its last visited chunk are zero."""
    num_tiles, _, cap = geom.shape
    npix = ts * ts
    count = _counts(counts, cap)
    tiles = torch.arange(num_tiles, device=geom.device)
    geom, rgbd = geom.to(dtype), rgbd.to(dtype)
    gacc, glogt = gacc.to(dtype), glogt.to(dtype)
    dgeom = torch.zeros_like(geom)
    drgbd = torch.zeros_like(rgbd)
    for lo, hi in _blocks(num_tiles, npix, chunk):
        win = _window_block(geom[lo:hi].detach(), rgbd[lo:hi].detach(),
                            count[lo:hi], chunk)
        width = win.shape[2]
        if width == 0:
            continue
        px, py = _pixel_coords(tiles[lo:hi], grid_x, ts)
        with torch.enable_grad():
            win = win.requires_grad_()
            acc, log_app, _, _ = _fwd_block(win, count[lo:hi], px, py, chunk)
            dwin, = torch.autograd.grad(
                (acc, log_app), (win,),
                (gacc[lo:hi], glogt[lo:hi].reshape(hi - lo, npix)))
        dwin = dwin.transpose(0, 1)                      # (B, 12, width)
        dgeom[lo:hi, :6, :width] = dwin[:, :6]
        drgbd[lo:hi, :, :width] = dwin[:, _GEOM_ROWS:]
    return dgeom, drgbd


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load()
    lib.gsl_pregathered_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P,
                                        _P, _P, _P]
    lib.gsl_pregathered_fwd.restype = _I
    lib.gsl_pregathered_bwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P,
                                        _P, _P, _P, _P, _P]
    lib.gsl_pregathered_bwd.restype = _I
    return lib


def tile_order(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """The kernels' tile order, deepest first: a stable descending argsort
    of the clamped counts, as int32 (the plain version of the order the
    kernels compute on the card). Block b walks tile ``order[b]``; outputs
    stay indexed by tile, so the order changes only when each tile runs."""
    return torch.argsort(_counts(counts, cap), descending=True,
                         stable=True).to(torch.int32)


def _check_common(counts, geom, rgbd, ts: int, chunk: int) -> None:
    if ts != _TILE:
        raise ValueError(f"the CUDA pregathered blend takes tile_size "
                         f"{_TILE}, got {ts}")
    if not geom.is_cuda:
        raise ValueError(f"the CUDA pregathered blend takes CUDA tensors, "
                         f"got {geom.device}")
    if geom.dim() != 3 or geom.shape[1] != _GEOM_ROWS:
        raise ValueError(f"geom: shape {tuple(geom.shape)}, expected "
                         f"(T, {_GEOM_ROWS}, cap)")
    num_tiles, _, cap = geom.shape
    if chunk < 1 or cap % chunk:
        raise ValueError(f"chunk must be positive and divide cap {cap}, got "
                         f"{chunk}")
    dev = geom.device
    _check(geom, "geom", torch.float32, geom.shape, dev)
    _check(rgbd, "rgbd", torch.float32, (num_tiles, _RGBD_ROWS, cap), dev)
    _check(counts, "counts", torch.int32, (num_tiles,), dev)


def pregathered_blend_fwd_cuda(counts, geom, rgbd, grid_x: int, ts: int,
                               chunk: int, order=None):
    """Launch K3: -> accum (T,4,npix), log_t (T,npix,1), resid (T,npix,2).
    ``order``, an int32 (T,) tensor if given, receives the tile order the
    kernel ran in (scratch otherwise)."""
    _check_common(counts, geom, rgbd, ts, chunk)
    lib = _lib()
    num_tiles, _, cap = geom.shape
    npix = ts * ts
    if order is None:
        order = torch.empty_like(counts)
    _check(order, "order", torch.int32, (num_tiles,), geom.device)
    out = dict(dtype=torch.float32, device=geom.device)
    accum = torch.empty((num_tiles, 4, npix), **out)
    log_t = torch.empty((num_tiles, npix, 1), **out)
    resid = torch.empty((num_tiles, npix, 2), **out)
    with torch.cuda.device(geom.device):
        cs = torch.cuda.current_stream().cuda_stream
        rc = lib.gsl_pregathered_fwd(
            counts.data_ptr(), order.data_ptr(), geom.data_ptr(),
            rgbd.data_ptr(), num_tiles, cap, grid_x, chunk, accum.data_ptr(),
            log_t.data_ptr(), resid.data_ptr(), cs)
    _raise_on(lib, rc, "pregathered blend forward launch")
    LAUNCHES["pregathered_fwd"] += 1
    return accum, log_t, resid


def pregathered_blend_bwd_cuda(counts, geom, rgbd, gacc, glogt, resid,
                               grid_x: int, ts: int, chunk: int):
    """Launch K4: -> dgeom (T,8,cap), drgbd (T,4,cap); the kernel writes
    every element, zero where no visited lane is."""
    _check_common(counts, geom, rgbd, ts, chunk)
    num_tiles, _, cap = geom.shape
    npix = ts * ts
    dev = geom.device
    _check(gacc, "gacc", torch.float32, (num_tiles, 4, npix), dev)
    _check(glogt, "glogt", torch.float32, (num_tiles, npix, 1), dev)
    _check(resid, "resid", torch.float32, (num_tiles, npix, 2), dev)
    lib = _lib()
    dgeom = torch.empty_like(geom)
    drgbd = torch.empty_like(rgbd)
    order = torch.empty_like(counts)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream().cuda_stream
        rc = lib.gsl_pregathered_bwd(
            counts.data_ptr(), order.data_ptr(), geom.data_ptr(),
            rgbd.data_ptr(), num_tiles, cap, grid_x, chunk, gacc.data_ptr(),
            glogt.data_ptr(), resid.data_ptr(), dgeom.data_ptr(),
            drgbd.data_ptr(), cs)
    _raise_on(lib, rc, "pregathered blend backward launch")
    LAUNCHES["pregathered_bwd"] += 1
    return dgeom, drgbd


# ---------------------------------------------------------------------------
# device dispatch + autograd
# ---------------------------------------------------------------------------

def pregathered_blend_fwd(counts, geom, rgbd, grid_x: int, ts: int,
                          chunk: int):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if geom.is_cuda:
        return pregathered_blend_fwd_cuda(counts, geom, rgbd, grid_x, ts,
                                          chunk)
    if geom.device.type == "cpu":
        return pregathered_blend_fwd_plain(counts, geom, rgbd, grid_x, ts,
                                           chunk)
    raise ValueError(f"unsupported device {geom.device}")


def pregathered_blend_bwd(counts, geom, rgbd, gacc, glogt, resid,
                          grid_x: int, ts: int, chunk: int):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if geom.is_cuda:
        return pregathered_blend_bwd_cuda(counts, geom, rgbd, gacc, glogt,
                                          resid, grid_x, ts, chunk)
    if geom.device.type == "cpu":
        return pregathered_blend_bwd_plain(counts, geom, rgbd, gacc, glogt,
                                           grid_x, ts, chunk)
    raise ValueError(f"unsupported device {geom.device}")


class _PregatheredBlend(torch.autograd.Function):
    """(counts, geom, rgbd) -> (accum, log_t), saving the residuals;
    backward -> (None, dgeom, drgbd)."""

    @staticmethod
    def forward(ctx, counts, geom, rgbd, grid_x, ts, chunk):
        accum, log_t, resid = pregathered_blend_fwd(counts, geom, rgbd,
                                                    grid_x, ts, chunk)
        ctx.save_for_backward(counts, geom, rgbd, resid)
        ctx.cfg = (grid_x, ts, chunk)
        return accum, log_t

    @staticmethod
    def backward(ctx, gacc, glogt):
        counts, geom, rgbd, resid = ctx.saved_tensors
        grid_x, ts, chunk = ctx.cfg
        dgeom, drgbd = pregathered_blend_bwd(
            counts, geom, rgbd, gacc.contiguous(), glogt.contiguous(), resid,
            grid_x, ts, chunk)
        return None, dgeom, drgbd, None, None, None


def blend_pregathered_pallas(
    tile_counts: torch.Tensor,  # (num_tiles,) int32
    geom: torch.Tensor,         # (num_tiles, 8, cap)
    rgbd: torch.Tensor,         # (num_tiles, 4, cap)
    grid_x: int,
    tile_size: int,
    chunk: int = 256,
) -> TileBlendOut:
    """Blend already-gathered per-pair rows (pose mode's ``PairPack``);
    grads flow to ``geom`` and ``rgbd``."""
    cap = geom.shape[2]
    chunk = min(chunk, cap)
    if cap % chunk:
        raise ValueError(f"window width {cap} is not a multiple of the "
                         f"chunk {chunk}")
    accum, log_t = _PregatheredBlend.apply(
        tile_counts, geom.contiguous(), rgbd.contiguous(), grid_x,
        tile_size, chunk)
    return _tile_out(accum, log_t)


def gather_windows(tile_gid, means2d, conic, rgb, opacity, depths):
    """One packed row gather ``pack[tile_gid]`` and a transpose -> the
    per-tile windows (geom (T, 8, cap), rgbd (T, 4, cap)). Per-pair validity
    is the kernels' ``lane < count``, so the valid row is all ones (as in
    the JAX package, unlike the stream pack's ``prep.valid``)."""
    ones = torch.ones_like(opacity)
    pack = torch.stack(
        [means2d[:, 0], means2d[:, 1],
         conic[:, 0], conic[:, 1], conic[:, 2],
         opacity, ones, torch.zeros_like(opacity),
         rgb[:, 0], rgb[:, 1], rgb[:, 2], depths],
        dim=1)                                            # (P, 12)
    gathered = pack[tile_gid.long()].transpose(1, 2)      # (T, 12, cap)
    return (gathered[:, :_GEOM_ROWS].contiguous(),
            gathered[:, _GEOM_ROWS:].contiguous())


def blend_tiles_pallas(
    tile_gid: torch.Tensor,     # (num_tiles, cap) int32
    tile_counts: torch.Tensor,  # (num_tiles,) int32
    means2d: torch.Tensor,      # (P, 2)
    conic: torch.Tensor,        # (P, 3)
    rgb: torch.Tensor,          # (P, 3)
    opacity: torch.Tensor,      # (P,)
    depths: torch.Tensor,       # (P,)
    grid_x: int,
    grid_y: int,
    tile_size: int,
    chunk: int = 256,
) -> TileBlendOut:
    """The training path's blend: ``gather_windows``, then K3/K4; the
    gradients reach the per-Gaussian rows through PyTorch's adjoint of the
    gather."""
    geom, rgbd = gather_windows(tile_gid, means2d, conic, rgb, opacity,
                                depths)
    return blend_pregathered_pallas(tile_counts, geom, rgbd, grid_x,
                                    tile_size, chunk)
