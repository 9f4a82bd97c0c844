"""Stream blend: per-tile windows read straight from the pair stream.

forward   (K1) each 16x16 tile walks its chunk-aligned window
          [tstart, tstart + walk_count) of the transposed pair stream
          (16, MR_AL + chunk) front to back, in chunks, and stops after the
          first chunk at whose end every pixel has T < 1e-4.
backward  (K2) walks the visited chunks in reverse from the residuals and
          writes per-pair dL/d(x, y, a, b, c, opa, r, g, b, depth), summed
          over the tile's pixels, at the pair's own stream position. The
          CUDA backward takes what the CUDA forward recorded (its log_t
          and a ``BlendWalk``): it is the adjoint of exactly the pairs the
          forward applied.

K1/K2 run the same device code as the pregathered kernels K3/K4
(``csrc/blend_common.cuh``): a stream window is a gathered window whose
rows lie ``mrpad`` floats apart.

Two implementations of each, chosen by the device of the tensors:

- CUDA tensors launch the hand-written kernels of ``csrc/stream_blend.cu``
  (built at first use, ``_kernels.py``), or raise;
- CPU tensors take the plain PyTorch versions below
  (``stream_blend_fwd_plain`` / ``stream_blend_bwd_plain``), which are also
  the yardstick the kernels are held against on the card.

Row layout: 0 x, 1 y, 2..4 conic a b c, 5 opacity, 6 valid, 7 pad,
8..10 rgb, 11 depth, 12..15 zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._kernels import check_tensor, launch
from .binning import StreamBins
from .blend import TileBlendOut
from .constants import ALPHA_MAX, ALPHA_MIN, LOG_T_EPS

_RPAD = 16          # stream rows: 12 semantic rows, padded
_TILE = 16          # the kernels run one 256-thread CTA per 16x16 tile
# The chunks the CUDA wrappers take. The piece walks' shared memory does not
# depend on the chunk, so the card sets no upper limit; a wider range would
# be an option that no caller uses (the pipelines run chunk 256).
_MAX_CHUNK = 512

# plain versions: tiles per block, so that (tiles, 256, chunk) temporaries
# stay near 2^22 elements whatever the scene
_PLAIN_ELEMS = 1 << 22


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _window(tstart, walk_counts, mrpad: int, chunk: int):
    """The kernels' clamp: a corrupt bin table never indexes out of bounds."""
    start = torch.clamp(tstart.long(), 0, mrpad - chunk)
    count = torch.minimum(torch.clamp_min(walk_counts.long(), 0),
                          mrpad - chunk - start)
    return start, count


def _descending(count: torch.Tensor) -> torch.Tensor:
    """A stable descending argsort of per-tile walk counts, as int32: the
    plain version of the tile order the kernels compute on the card."""
    return torch.argsort(count, descending=True, stable=True).to(torch.int32)


def tile_order(tstart: torch.Tensor, walk_counts: torch.Tensor, mrpad: int,
               chunk: int) -> torch.Tensor:
    """K1/K2's tile order, deepest first: the tiles by their clamped walk
    counts, ties in tile order. Block b walks tile ``order[b]``; outputs
    stay indexed by tile, so the order changes only when each tile runs."""
    return _descending(_window(tstart, walk_counts, mrpad, chunk)[1])


def _pixel_coords(tiles: torch.Tensor, grid_x: int, ts: int):
    """(B,) tile ids -> (B, npix) float pixel x, y."""
    ii = torch.arange(ts * ts, device=tiles.device)
    px = ((tiles % grid_x) * ts)[:, None] + ii % ts
    py = (torch.div(tiles, grid_x, rounding_mode="floor") * ts)[:, None] \
        + torch.div(ii, ts, rounding_mode="floor")
    return px.to(torch.float32), py.to(torch.float32)


def _power_araw(g: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    x, y = g[0][:, None, :], g[1][:, None, :]
    ca, cb, cc = g[2][:, None, :], g[3][:, None, :], g[4][:, None, :]
    dx = x - px[:, :, None]
    dy = y - py[:, :, None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    return power, g[5][:, None, :] * torch.exp(torch.clamp_max(power, 0.0))


def _chunk_alpha(g: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                 lane_ok: torch.Tensor) -> torch.Tensor:
    """Gated alpha (B, npix, G) of one chunk g (16, B, G); same operation
    order as the kernels' gate.

    In a wider dtype than float32 (the yardstick the float32 walks are read
    against) the threshold tests -- the gate and the clamp at ALPHA_MAX --
    are taken on the float32 values, as the contract defines them, so that
    the two differ by the rounding of the blend and not by which pairs
    pass."""
    power, araw = _power_araw(g, px, py)
    vld = g[6][:, None, :]
    if g.dtype == torch.float32:
        gate = ((power <= 0.0) & (araw >= ALPHA_MIN) & (vld > 0.5)
                & lane_ok[:, None, :])
        return torch.where(gate, torch.clamp_max(araw, ALPHA_MAX),
                           torch.zeros_like(araw))
    with torch.no_grad():
        p32, a32 = _power_araw(g.float(), px.float(), py.float())
    gate = ((p32 <= 0.0) & (a32 >= ALPHA_MIN) & (vld > 0.5)
            & lane_ok[:, None, :])
    alpha = torch.where(a32 < ALPHA_MAX, araw, torch.full_like(araw,
                                                               ALPHA_MAX))
    return torch.where(gate, alpha, torch.zeros_like(araw))


def _fwd_block(win: torch.Tensor, count: torch.Tensor, px: torch.Tensor,
               py: torch.Tensor, chunk: int):
    """Blend one block of tiles over their gathered windows
    win (16, B, n_chunks*chunk), in win's dtype. Returns accum (B,4,npix),
    log_app (B,npix), log_full (B,npix), k_stop (B,)."""
    bsz, npix = px.shape
    dev, dtype = win.device, win.dtype
    px, py = px.to(dtype), py.to(dtype)
    n_chunks = torch.div(count + chunk - 1, chunk, rounding_mode="floor")
    log_full = torch.zeros((bsz, npix), dtype=dtype, device=dev)
    log_app = torch.zeros_like(log_full)
    acc = torch.zeros((bsz, 4, npix), dtype=dtype, device=dev)
    k_stop = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    lanes = torch.arange(chunk, device=dev)
    for k in range(win.shape[2] // chunk):
        running = (k < n_chunks) & (log_full.amax(dim=1) >= LOG_T_EPS)
        g = win[:, :, k * chunk:(k + 1) * chunk]
        lane_ok = ((k * chunk + lanes)[None, :] < count[:, None]) \
            & running[:, None]
        alpha = _chunk_alpha(g, px, py, lane_ok)
        la = torch.log(1.0 - alpha)
        clog = log_full[:, :, None] + torch.cumsum(la, dim=2)
        applied = clog >= LOG_T_EPS
        w = torch.where(applied, alpha * torch.exp(clog - la),
                        torch.zeros_like(alpha))
        acc = acc + torch.einsum("cbg,bpg->bcp", g[8:12], w)
        log_full = log_full + la.sum(dim=2)
        log_app = log_app + torch.where(applied, la,
                                        torch.zeros_like(la)).sum(dim=2)
        k_stop = k_stop + running.to(torch.int64)
    return acc, log_app, log_full, k_stop


def _blocks(num_tiles: int, npix: int, chunk: int):
    step = max(1, _PLAIN_ELEMS // (npix * chunk))
    for lo in range(0, num_tiles, step):
        yield lo, min(num_tiles, lo + step)


def _gather_windows(stream, start, count, chunk: int):
    """(16, B, K*chunk) windows of a block of tiles and their positions."""
    mrpad = stream.shape[1]
    k_max = int(torch.div(count + chunk - 1, chunk,
                          rounding_mode="floor").max()) if count.numel() else 0
    pos = start[:, None] + torch.arange(k_max * chunk, device=stream.device)
    pos = torch.clamp_max(pos, mrpad - 1)    # lanes past count are gated
    return stream[:, pos], pos


def stream_blend_fwd_plain(stream: torch.Tensor, tstart: torch.Tensor,
                           walk_counts: torch.Tensor, grid_x: int, ts: int,
                           chunk: int):
    """K1's outputs in plain PyTorch: accum (T,4,npix), log_t (T,npix,1),
    resid (T,npix,2) = [log_full, k_stop]."""
    num_tiles = tstart.shape[0]
    npix = ts * ts
    mrpad = stream.shape[1]
    start, count = _window(tstart, walk_counts, mrpad, chunk)
    tiles = torch.arange(num_tiles, device=stream.device)
    accum = torch.zeros((num_tiles, 4, npix), dtype=torch.float32,
                        device=stream.device)
    log_t = torch.zeros((num_tiles, npix, 1), dtype=torch.float32,
                        device=stream.device)
    resid = torch.zeros((num_tiles, npix, 2), dtype=torch.float32,
                        device=stream.device)
    for lo, hi in _blocks(num_tiles, npix, chunk):
        win, _ = _gather_windows(stream, start[lo:hi], count[lo:hi], chunk)
        px, py = _pixel_coords(tiles[lo:hi], grid_x, ts)
        acc, log_app, log_full, k_stop = _fwd_block(win, count[lo:hi], px, py,
                                                    chunk)
        accum[lo:hi] = acc
        log_t[lo:hi, :, 0] = log_app
        resid[lo:hi, :, 0] = log_full
        resid[lo:hi, :, 1] = k_stop.to(torch.float32)[:, None]
    return accum, log_t, resid


def stream_blend_bwd_plain(stream: torch.Tensor, tstart: torch.Tensor,
                           walk_counts: torch.Tensor, gacc: torch.Tensor,
                           glogt: torch.Tensor, grid_x: int, ts: int,
                           chunk: int) -> torch.Tensor:
    """K2's dstream (16, mrpad) in plain PyTorch: autograd through the plain
    forward, one block of tiles at a time. Positions no tile visits are
    zero; the caller masks positions >= kept_al."""
    num_tiles = tstart.shape[0]
    npix = ts * ts
    mrpad = stream.shape[1]
    start, count = _window(tstart, walk_counts, mrpad, chunk)
    tiles = torch.arange(num_tiles, device=stream.device)
    dstream = torch.zeros_like(stream)
    rows = torch.arange(_RPAD, device=stream.device)[:, None, None]
    for lo, hi in _blocks(num_tiles, npix, chunk):
        win, pos = _gather_windows(stream.detach(), start[lo:hi],
                                   count[lo:hi], chunk)
        if win.shape[2] == 0:
            continue
        px, py = _pixel_coords(tiles[lo:hi], grid_x, ts)
        with torch.enable_grad():
            win = win.requires_grad_()
            acc, log_app, _, _ = _fwd_block(win, count[lo:hi], px, py, chunk)
            dwin, = torch.autograd.grad(
                (acc, log_app), (win,),
                (gacc[lo:hi], glogt[lo:hi].reshape(hi - lo, npix)))
        dstream.index_put_((rows, pos[None].expand_as(dwin)), dwin,
                           accumulate=True)
    return dstream


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

class BlendWalk(NamedTuple):
    """What a CUDA blend forward (K1, K3) records for its backward (K2,
    K4): the tile order it ran in, (T,) int32; for each pixel one past the
    window lane of the last pair it applied, (T, npix) int32 (0 where it
    applied none); and each pixel's log T at the start of every chunk its
    tile walked, float32 (0 at chunks no tile walked): (mrpad / chunk, npix)
    by the chunk's position in the stream for K1, (T, cap / chunk, npix)
    for K3. The backward runs in that order, is the adjoint of exactly
    those pairs, and starts each chunk's reverse walk from the forward's own
    log T."""
    order: torch.Tensor
    last: torch.Tensor
    chunk_logt: torch.Tensor


def _new_walk(num_tiles: int, npix: int, chunks: tuple, device) -> BlendWalk:
    """A walk to fill; ``chunks`` is the shape of the records' leading
    dimensions. The records start at 0, so that two launches on the same
    inputs give the same bits everywhere."""
    out = dict(dtype=torch.int32, device=device)
    return BlendWalk(torch.empty((num_tiles,), **out),
                     torch.empty((num_tiles, npix), **out),
                     torch.zeros((*chunks, npix), dtype=torch.float32,
                                 device=device))


def _check_walk(walk: BlendWalk, num_tiles: int, npix: int, chunks: tuple,
                device) -> None:
    check_tensor(walk.order, "walk.order", torch.int32, (num_tiles,), device)
    check_tensor(walk.last, "walk.last", torch.int32, (num_tiles, npix),
                 device)
    check_tensor(walk.chunk_logt, "walk.chunk_logt", torch.float32,
                 (*chunks, npix), device)


def _stream_chunks(mrpad: int, chunk: int) -> tuple:
    """K1's records: one row per chunk of the stream."""
    return (-(-mrpad // chunk),)


def _check_common(stream, tstart, walk_counts, ts: int, chunk: int) -> None:
    if ts != _TILE:
        raise ValueError(f"the CUDA stream blend takes tile_size {_TILE}, "
                         f"got {ts}")
    if chunk % 32 or not 32 <= chunk <= _MAX_CHUNK:
        raise ValueError(f"chunk must be a multiple of 32 in [32, "
                         f"{_MAX_CHUNK}], got {chunk}")
    dev = stream.device
    if not stream.is_cuda:
        raise ValueError(f"the CUDA stream blend takes CUDA tensors, got "
                         f"{dev}")
    if stream.dim() != 2 or stream.shape[0] != _RPAD \
            or stream.shape[1] < chunk:
        raise ValueError(f"stream: shape {tuple(stream.shape)}, expected "
                         f"({_RPAD}, >= chunk)")
    check_tensor(stream, "stream", torch.float32, stream.shape, dev)
    check_tensor(tstart, "tstart", torch.int32, tstart.shape, dev)
    check_tensor(walk_counts, "walk_counts", torch.int32, tstart.shape, dev)
    if tstart.dim() != 1:
        raise ValueError("tstart must be 1-D")


def stream_blend_fwd_cuda(stream, tstart, walk_counts, grid_x: int, ts: int,
                          chunk: int):
    """Launch K1: -> accum (T,4,npix), log_t (T,npix,1), resid (T,npix,2)
    and the ``BlendWalk`` that K2 takes."""
    _check_common(stream, tstart, walk_counts, ts, chunk)
    num_tiles = tstart.shape[0]
    npix = ts * ts
    walk = _new_walk(num_tiles, npix,
                     _stream_chunks(stream.shape[1], chunk), stream.device)
    out = dict(dtype=torch.float32, device=stream.device)
    accum = torch.empty((num_tiles, 4, npix), **out)
    log_t = torch.empty((num_tiles, npix, 1), **out)
    resid = torch.empty((num_tiles, npix, 2), **out)
    launch("stream_fwd", stream.device, tstart, walk_counts, walk.order,
           stream, num_tiles, stream.shape[1], grid_x, chunk, accum, log_t,
           resid, walk.last, walk.chunk_logt)
    return accum, log_t, resid, walk


def stream_blend_bwd_cuda(stream, tstart, walk_counts, gacc, glogt, log_t,
                          walk: BlendWalk, grid_x: int, ts: int,
                          chunk: int) -> torch.Tensor:
    """Launch K2 on K1's ``log_t`` and ``walk``: -> dstream (16, mrpad),
    zero where no tile writes."""
    _check_common(stream, tstart, walk_counts, ts, chunk)
    num_tiles = tstart.shape[0]
    npix = ts * ts
    dev = stream.device
    check_tensor(gacc, "gacc", torch.float32, (num_tiles, 4, npix), dev)
    check_tensor(glogt, "glogt", torch.float32, (num_tiles, npix, 1), dev)
    check_tensor(log_t, "log_t", torch.float32, (num_tiles, npix, 1), dev)
    _check_walk(walk, num_tiles, npix,
                _stream_chunks(stream.shape[1], chunk), dev)
    dstream = torch.zeros_like(stream)
    launch("stream_bwd", dev, tstart, walk_counts, walk.order, stream,
           num_tiles, stream.shape[1], grid_x, chunk, gacc, glogt, log_t,
           walk.last, walk.chunk_logt, dstream)
    return dstream


# ---------------------------------------------------------------------------
# device dispatch + autograd
# ---------------------------------------------------------------------------

def stream_blend_fwd(stream, tstart, walk_counts, grid_x: int, ts: int,
                     chunk: int):
    """K1 on CUDA tensors, its plain version on CPU tensors: -> accum,
    log_t, resid and the walk for the backward (None on the CPU)."""
    if stream.is_cuda:
        return stream_blend_fwd_cuda(stream, tstart, walk_counts, grid_x, ts,
                                     chunk)
    if stream.device.type == "cpu":
        return (*stream_blend_fwd_plain(stream, tstart, walk_counts, grid_x,
                                        ts, chunk), None)
    raise ValueError(f"unsupported device {stream.device}")


def stream_blend_bwd(stream, tstart, walk_counts, gacc, glogt, log_t, walk,
                     grid_x: int, ts: int, chunk: int) -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    if stream.is_cuda:
        return stream_blend_bwd_cuda(stream, tstart, walk_counts, gacc,
                                     glogt, log_t, walk, grid_x, ts, chunk)
    if stream.device.type == "cpu":
        return stream_blend_bwd_plain(stream, tstart, walk_counts, gacc,
                                      glogt, grid_x, ts, chunk)
    raise ValueError(f"unsupported device {stream.device}")


class _StreamBlend(torch.autograd.Function):
    """Blend of a pre-assembled stream; the cotangent of the stream itself
    is the gradient (no slot reduction)."""

    @staticmethod
    def forward(ctx, stream_t, tstart, walk_counts, kept_al, grid_x, ts,
                chunk):
        accum, log_t, _, walk = stream_blend_fwd(stream_t, tstart,
                                                 walk_counts, grid_x, ts,
                                                 chunk)
        ctx.save_for_backward(stream_t, tstart, walk_counts, kept_al, log_t)
        ctx.walk = walk
        ctx.cfg = (grid_x, ts, chunk)
        return accum, log_t

    @staticmethod
    def backward(ctx, gacc, glogt):
        stream_t, tstart, walk_counts, kept_al, log_t = ctx.saved_tensors
        grid_x, ts, chunk = ctx.cfg
        dstream = stream_blend_bwd(stream_t, tstart, walk_counts,
                                   gacc.contiguous(), glogt.contiguous(),
                                   log_t, ctx.walk, grid_x, ts, chunk)
        # positions past the live aligned stream carry no pair
        pos_ok = torch.arange(stream_t.shape[1],
                              device=stream_t.device) < kept_al
        dstream = torch.where(pos_ok[None, :], dstream,
                              torch.zeros_like(dstream))
        return dstream, None, None, None, None, None, None


def _tile_out(accum: torch.Tensor, log_t: torch.Tensor) -> TileBlendOut:
    return TileBlendOut(color=accum[:, 0:3, :].transpose(1, 2),
                        depth=accum[:, 3, :], log_t=log_t[:, :, 0])


def blend_stream_direct(
    stream_t: torch.Tensor,     # (16, MR_AL+chunk) pre-assembled stream rows
    tstart: torch.Tensor,       # (num_tiles,) int32 aligned tile starts
    walk_counts: torch.Tensor,  # (num_tiles,) int32
    kept_al: torch.Tensor,      # () int32 live aligned-stream length
    grid_x: int,
    tile_size: int,
    chunk: int = 256,
) -> TileBlendOut:
    """Blend a pre-assembled pair stream; grads flow to the stream rows.

    The stream's alignment must equal ``chunk`` (``bin_stream(align=chunk)``):
    the backward writes whole chunks inside each tile's aligned window.
    """
    accum, log_t = _StreamBlend.apply(stream_t, tstart, walk_counts,
                                      kept_al, grid_x, tile_size, chunk)
    return _tile_out(accum, log_t)


def assemble_stream(pack: torch.Tensor, gid_of_pos: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """(P, R) per-Gaussian rows, R <= 16 -> (16, MR_AL+chunk) stream, rows
    R.. zero; the dead row P (zero params) is gated out of the blend.

    The gather is an ``index_select``, whose adjoint is ``index_add_``
    (atomic adds on the card, so the sums' order varies between runs);
    ``blend_stream`` takes the stream's gradient in slot order instead
    (``slot_order_pack_grad``). Advanced indexing's adjoint would sort the
    positions and walk each Gaussian's duplicates serially: every alignment
    gap points at the dead row, hundreds of thousands of duplicates of one
    index in a training view, which made that adjoint most of a training
    step on the card."""
    rows = pack.shape[1]
    if rows > _RPAD:
        raise ValueError(f"pack has {rows} rows, the stream holds {_RPAD}")
    pack_pad = torch.cat([pack, pack.new_zeros((1, rows))], dim=0)
    stream = torch.index_select(pack_pad, 0, gid_of_pos)  # (MR_AL, R)
    mr_al = stream.shape[0]
    stream_t = torch.cat([stream.T, pack.new_zeros((_RPAD - rows, mr_al))],
                         dim=0)
    return torch.cat([stream_t, pack.new_zeros((_RPAD, chunk))], dim=1)


def slot_order_pack_grad(dstream_t: torch.Tensor, sbins: StreamBins,
                         rows: int) -> torch.Tensor:
    """The stream's cotangent (16, MR_AL+chunk) reduced to the per-Gaussian
    rows (P, rows) in slot order, as the JAX ``_make_stream_core`` backward
    does (``raster/stream_blend.py:400-417`` of the JAX package): zero the
    positions past ``kept_al``; gather each pair slot's row by
    ``pos_by_slot`` (unmapped slots point at position MR_AL, which is
    zero); sum each rank's ``fast_k`` fast slots; sum each rank's slow
    segment as the difference of a running sum over the slow pool at
    ``slow_starts``; write the ranks' rows to their Gaussians by ``order``.

    Every step is a gather, a sum in an order fixed by the shapes, or a
    write to unique indices: no atomics, so the result has the same bits on
    every run. The running sum is float64 (JAX's is float32, whose
    differences lose the digits of a small segment beside the pool's
    total) and blocked (``_running_sum``)."""
    p = sbins.order.shape[0]
    fast_k = sbins.fast_k
    dev = dstream_t.device
    drows = dstream_t[:rows].T                            # (mrpad, rows)
    pos_ok = torch.arange(drows.shape[0], device=dev) < sbins.kept_al
    drows = torch.where(pos_ok[:, None], drows, torch.zeros_like(drows))
    dslot = torch.index_select(drows, 0, sbins.pos_by_slot.long())
    nfast = p * fast_k
    dranked = dslot[:nfast].reshape(p, fast_k, rows).sum(dim=1)
    cum = _running_sum(dslot[nfast:])
    bounds = torch.clamp(sbins.slow_starts.long(), 0, cum.shape[0] - 1)
    dranked = dranked + (cum[bounds[1:]] - cum[bounds[:-1]]).to(
        dranked.dtype)
    return torch.zeros_like(dranked).index_copy_(0, sbins.order.long(),
                                                 dranked)


_SCAN_BLOCK = 256


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """(n, R) -> (n + 1, R) float64 exclusive running sums down dim 0, in
    an order fixed by the shape: blocks of _SCAN_BLOCK rows are scanned
    one row after another (PyTorch scans a dimension that is neither the
    only nor the last one with one thread per column, in order), and the
    blocks' totals the same way, recursively. A scan of the whole column at
    once would take the card's decoupled look-back, whose association
    varies between runs."""
    n, r = x.shape
    x = x.to(torch.float64)
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.cat([x, x.new_zeros((nb * _SCAN_BLOCK - n, r))]).reshape(
        nb, _SCAN_BLOCK, r).cumsum(dim=1)
    if nb > 1:
        blocks = blocks + _running_sum(blocks[:, -1])[:-1, None, :]
    return torch.cat([x.new_zeros((1, r)),
                      blocks.reshape(nb * _SCAN_BLOCK, r)[:n]])


class _SlotOrderStream(torch.autograd.Function):
    """``assemble_stream`` forward; backward ``slot_order_pack_grad``."""

    @staticmethod
    def forward(ctx, pack, sbins, chunk):
        ctx.sbins = sbins
        ctx.rows = pack.shape[1]
        return assemble_stream(pack, sbins.gid_of_pos, chunk)

    @staticmethod
    def backward(ctx, dstream_t):
        return (slot_order_pack_grad(dstream_t, ctx.sbins, ctx.rows), None,
                None)


def blend_stream(
    pack: torch.Tensor,        # (P, 12) per-Gaussian rows (original order)
    sbins: StreamBins,
    grid_x: int,
    tile_size: int,
    chunk: int = 256,
) -> TileBlendOut:
    """Counterpart of the JAX ``blend_stream_pallas``. Gradients reach
    ``pack`` through the slot-order reduction of the stream's cotangent
    (``slot_order_pack_grad``, JAX's own backward), so a training step has
    the same bits on every run."""
    if sbins.align != chunk:
        raise ValueError(f"stream aligned to {sbins.align}, blend chunk "
                         f"{chunk}: the backward needs align == chunk")
    stream_t = _SlotOrderStream.apply(pack, sbins, chunk)
    return blend_stream_direct(stream_t, sbins.tstart, sbins.walk_counts,
                               sbins.kept_al, grid_x, tile_size, chunk)
