"""Tile binning: a depth-ranked, chunk-aligned pair stream (``bin_stream``)
or a padded per-tile id matrix (``bin_gaussians``).

Same pair semantics as the JAX package's ``bin_stream`` and
``bin_gaussians``, down to the integers:

1. argsort Gaussians by the **bitcast-int32** view depth (positive IEEE
   floats order correctly as ints), stable.
2. offset-major pair expansion: Gaussian s emits its k-th covered tile for
   k < fast_k directly into a dense (P, fast_k) matrix; Gaussians covering
   more than fast_k tiles go through a slow pool of static capacity
   ``max_pairs``, whose slot j belongs to the largest rank whose segment
   starts at or before j (``slot_owner``).
3. pairs sort once by a **packed int32 key** ``tile * R + depth_rank``
   (R = next pow2 >= P); a per-tile opacity cull drops (Gaussian, tile)
   pairs whose max alpha over the tile is below the blend's 1/255 gate.
4. per-tile [start, count) by a searchsorted on the key boundaries, then
   either an aligned layout (stream: tile t's pairs live at [tstart[t],
   tstart[t]+count) with tstart a multiple of ``align`` so windows never
   overlap across tiles; ``place_stream``) or a padded (num_tiles,
   max_per_tile) id matrix.

All shapes are static; the slow pool (``overflow``) and the materialized
stream or per-tile cap (``tile_overflow``) are the capacities and are
reported as flags.

The two segment expansions (``slot_owner``, ``place_stream``) have two
implementations each, chosen by the device of the tensors: CUDA tensors
launch the hand-written kernels of ``csrc/binning.cu`` (a binary search per
slot or position; no scan, nothing read to the host), or raise; CPU tensors
take the plain versions (``slot_owner_plain``, ``place_stream_plain``: a
scatter-max and a running max, as the JAX package computes them), which
are the yardstick the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import LAUNCHES
from .. import _kernels
from .._kernels import check_tensor, raise_on
from .constants import ALPHA_MIN as _ALPHA_MIN
from .preprocess import Preprocessed

INT32_MAX = 2**31 - 1


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _tile_qmin(mx, my, ca, cb, cc, tx, ty, tile_size: int):
    """Exact min of the conic quadratic q(d) = a dx^2 + 2b dxdy + c dy^2
    over tile (tx, ty)'s pixel-center box, elementwise: 0 if the mean lies
    inside, else the least of the four edges, each a clamped 1-D quadratic
    minimum."""
    xlo = tx * tile_size - mx
    xhi = xlo + (tile_size - 1)
    ylo = ty * tile_size - my
    yhi = ylo + (tile_size - 1)
    inside = (xlo <= 0) & (0 <= xhi) & (ylo <= 0) & (0 <= yhi)
    a_s = torch.clamp_min(ca, 1e-12)
    c_s = torch.clamp_min(cc, 1e-12)

    def edge_x(e):
        ys = torch.minimum(torch.maximum(-cb * e / c_s, ylo), yhi)
        return ca * e * e + 2.0 * cb * e * ys + cc * ys * ys

    def edge_y(e):
        xs = torch.minimum(torch.maximum(-cb * e / a_s, xlo), xhi)
        return ca * xs * xs + 2.0 * cb * xs * e + cc * e * e

    q = torch.minimum(torch.minimum(edge_x(xlo), edge_x(xhi)),
                      torch.minimum(edge_y(ylo), edge_y(yhi)))
    return torch.where(inside, torch.zeros_like(q), q)


def _cull_table(prep: Preprocessed) -> torch.Tensor:
    """(P, 10) float32 row per Gaussian for one packed gather:
    [x0, y0, x1, y1, mx, my, conic a, b, c, qmax]; a tile survives iff
    qmin(tile) <= qmax, i.e. max alpha in the tile >= ALPHA_MIN."""
    op = prep.opacity
    qmax = torch.where(op > _ALPHA_MIN, 2.0 * torch.log(op * 255.0),
                       torch.full_like(op, -1.0))
    return torch.cat([prep.rect.to(torch.float32), prep.means2d, prep.conic,
                      qmax[:, None]], dim=1)


class Binning(NamedTuple):
    """Per-tile Gaussian ids at a static capacity ``max_per_tile``."""

    tile_gid: torch.Tensor     # (num_tiles, max_per_tile) int32 Gaussian ids;
    #   lanes past the count hold the ids the key matrix gives (real ids)
    tile_mask: torch.Tensor    # (num_tiles, max_per_tile) bool
    tile_counts: torch.Tensor  # (num_tiles,) int32, clipped to max_per_tile
    num_rendered: torch.Tensor   # () int32 total emitted pairs
    overflow: torch.Tensor       # () bool: slow-path capacity exceeded
    tile_overflow: torch.Tensor  # () bool: some tile's count > max_per_tile
    max_tile_count: torch.Tensor  # () int32 true max count (pre-clip)


def _check_rank_size(num_tiles: int, rank_size: int) -> None:
    assert (num_tiles + 1) * rank_size < 2**31, (
        f"packed sort key overflow: {num_tiles} tiles x {rank_size} rank "
        "slots")


def _depth_order(prep: Preprocessed) -> torch.Tensor:
    """Stable argsort by the bitcast-int32 view depth, invalid last."""
    depths = prep.depths.detach().contiguous()
    depth_key = torch.where(prep.valid, depths.view(torch.int32),
                            torch.full_like(depths.view(torch.int32),
                                            INT32_MAX))
    return torch.argsort(depth_key, stable=True).to(torch.int32)


class StreamBins(NamedTuple):
    """Depth-rank pair stream. All ids are depth RANKS (positions in the
    depth sort); ``order`` maps rank -> original Gaussian index."""

    order: torch.Tensor        # (P,) int32 depth order (rank -> orig id)
    rank_of_pos: torch.Tensor  # (MR,) int32 depth rank per sorted position
    gid_of_pos: torch.Tensor   # (MR_AL,) int32 original id per ALIGNED
    #   position (gaps and truncated tail = dead row P)
    pos_by_slot: torch.Tensor  # (S,) int32 aligned position per pair slot
    #   (MR_AL = none); slots: fast = rank*fast_k + k, slow = P*fast_k + idx
    slow_starts: torch.Tensor  # (P + 1,) int32 slow-path segment bounds
    tstart: torch.Tensor       # (num_tiles,) int32 ALIGNED tile start
    walk_counts: torch.Tensor  # (num_tiles,) int32 materialized count
    tile_counts: torch.Tensor  # (num_tiles,) int32 true counts (uncapped)
    kept: torch.Tensor         # () int32 pairs actually materialized
    kept_al: torch.Tensor      # () int32 aligned-stream length in use
    num_rendered: torch.Tensor   # () int32 total emitted pairs
    overflow: torch.Tensor       # () bool: slow-path capacity exceeded
    tile_overflow: torch.Tensor  # () bool: stream truncated at max_render
    max_tile_count: torch.Tensor  # () int32
    align: int = 256             # window alignment the stream was built with
    fast_k: int = 1              # fast slots per rank (pos_by_slot's layout)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# segment expansions: plain versions, CUDA kernels, device dispatch
# ---------------------------------------------------------------------------

def slot_owner_plain(starts: torch.Tensor, p: int,
                     max_pairs: int) -> torch.Tensor:
    """(max_pairs,) int32 owner rank of each slow-pool slot: each of the
    ``p`` ranks marks its segment start ``starts[rank]`` (the largest rank
    wins; starts at or past the pool are dropped), then a running max fills
    the segment."""
    dev = starts.device
    seg = starts[:p]
    in_pool = seg < max_pairs
    mark = torch.zeros(max_pairs, dtype=torch.int32, device=dev)
    mark.scatter_reduce_(0, seg[in_pool].long(), _arange(p, dev)[in_pool],
                         reduce="amax")
    return torch.cummax(mark, 0).values


def place_stream_plain(keys_sorted: torch.Tensor, slot_of_pos: torch.Tensor,
                       order: torch.Tensor, tstart_pos: torch.Tensor,
                       astart_all: torch.Tensor, kept: torch.Tensor, mr: int,
                       mr_al: int, rank_size: int):
    """The first ``mr`` sorted positions laid into the aligned stream:
    -> (rank_of_pos (mr,), gid_of_apos (mr_al,), ap_by_slot (S,)), int32.

    Position i's aligned position is i plus its tile's shift
    ``astart_all[t] - tstart_pos[t]`` (constant per tile and non-decreasing:
    each tile's shift is scatter-maxed at its first position, clamped to
    ``mr - 1``, and a running max broadcasts it). The live positions (i <
    ``kept``, a 0-d tensor) write their Gaussian id at it (below ``mr_al``)
    and it at their slot ``slot_of_pos[i]``; gaps and the truncated tail
    hold the dead row P, unmapped slots ``mr_al``."""
    dev = keys_sorted.device
    p = order.shape[0]
    s = keys_sorted.shape[0]
    rank_mr = torch.clamp_max(keys_sorted[:mr] & (rank_size - 1), p - 1)
    gid_mr = order[rank_mr.long()]
    shift = astart_all[:-1] - tstart_pos                 # (T,) >= 0
    pos_iota = _arange(mr, dev)
    heads = torch.zeros(mr, dtype=torch.int32, device=dev)
    if mr > 0:
        heads.scatter_reduce_(0, torch.clamp_max(tstart_pos, mr - 1).long(),
                              shift, reduce="amax")
    shift_of_pos = torch.cummax(heads, 0).values
    ap_of_pos = pos_iota + shift_of_pos                  # aligned position
    pos_live = pos_iota < kept

    gid_of_apos = torch.full((mr_al,), p, dtype=torch.int32, device=dev)
    put = pos_live & (ap_of_pos < mr_al)
    gid_of_apos[ap_of_pos[put].long()] = gid_mr[put]
    ap_by_slot = torch.full((s,), mr_al, dtype=torch.int32, device=dev)
    slot_mr = slot_of_pos[:mr]
    put = pos_live & (slot_mr < s)
    ap_by_slot[slot_mr[put].long()] = ap_of_pos[put]
    return rank_mr, gid_of_apos, ap_by_slot


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load()
    lib.gsl_bin_owner.argtypes = [_P, _I, _I, _P, _P]
    lib.gsl_bin_owner.restype = _I
    lib.gsl_bin_place.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _P, _P, _P, _P]
    lib.gsl_bin_place.restype = _I
    return lib


def slot_owner_cuda(starts: torch.Tensor, p: int,
                    max_pairs: int) -> torch.Tensor:
    """``slot_owner_plain`` by the kernel ``bin_owner`` (a binary search of
    each slot in ``starts``)."""
    dev = starts.device
    if not starts.is_cuda:
        raise ValueError(f"the CUDA slot owner takes CUDA tensors, got {dev}")
    check_tensor(starts, "starts", torch.int32, (p + 1,), dev)
    owner = torch.empty(max_pairs, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.gsl_bin_owner(starts.data_ptr(), p, max_pairs,
                               owner.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    raise_on(lib, rc, "slot owner launch")
    LAUNCHES["bin_owner"] += 1
    return owner


def place_stream_cuda(keys_sorted: torch.Tensor, slot_of_pos: torch.Tensor,
                      order: torch.Tensor, tstart_pos: torch.Tensor,
                      astart_all: torch.Tensor, kept: torch.Tensor, mr: int,
                      mr_al: int, rank_size: int):
    """``place_stream_plain`` by the kernel ``bin_place`` (a binary search of
    each position in the clamped tile starts); ``slot_of_pos`` is int64, as
    ``torch.sort`` gives it."""
    dev = keys_sorted.device
    if not keys_sorted.is_cuda:
        raise ValueError(f"the CUDA stream placement takes CUDA tensors, got "
                         f"{dev}")
    p = order.shape[0]
    s = keys_sorted.shape[0]
    num_tiles = tstart_pos.shape[0]
    if p < 1:
        raise ValueError("place_stream: no ranks to place")
    if not 0 <= mr <= s:
        raise ValueError(f"place_stream: mr {mr} outside [0, {s}]")
    for t, name, dtype, shape in (
            (keys_sorted, "keys_sorted", torch.int32, (s,)),
            (slot_of_pos, "slot_of_pos", torch.int64, (s,)),
            (order, "order", torch.int32, (p,)),
            (tstart_pos, "tstart_pos", torch.int32, (num_tiles,)),
            (astart_all, "astart_all", torch.int32, (num_tiles + 1,)),
            (kept, "kept", torch.int32, ())):
        check_tensor(t, name, dtype, shape, dev)
    out = dict(dtype=torch.int32, device=dev)
    rank_of_pos = torch.empty(mr, **out)
    gid_of_apos = torch.full((mr_al,), p, **out)
    ap_by_slot = torch.full((s,), mr_al, **out)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.gsl_bin_place(
            keys_sorted.data_ptr(), slot_of_pos.data_ptr(), order.data_ptr(),
            tstart_pos.data_ptr(), astart_all.data_ptr(), kept.data_ptr(),
            mr, mr_al, s, num_tiles, rank_size - 1, p, rank_of_pos.data_ptr(),
            gid_of_apos.data_ptr(), ap_by_slot.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    raise_on(lib, rc, "stream placement launch")
    LAUNCHES["bin_place"] += 1
    return rank_of_pos, gid_of_apos, ap_by_slot


def slot_owner(starts: torch.Tensor, p: int, max_pairs: int) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if starts.is_cuda:
        return slot_owner_cuda(starts, p, max_pairs)
    if starts.device.type == "cpu":
        return slot_owner_plain(starts, p, max_pairs)
    raise ValueError(f"unsupported device {starts.device}")


def place_stream(keys_sorted, slot_of_pos, order, tstart_pos, astart_all,
                 kept, mr: int, mr_al: int, rank_size: int):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    args = (keys_sorted, slot_of_pos, order, tstart_pos, astart_all, kept,
            mr, mr_al, rank_size)
    if keys_sorted.is_cuda:
        return place_stream_cuda(*args)
    if keys_sorted.device.type == "cpu":
        return place_stream_plain(*args)
    raise ValueError(f"unsupported device {keys_sorted.device}")


def _emit_pair_keys(prep: Preprocessed, order: torch.Tensor, grid_x: int,
                    grid_y: int, rank_size: int, max_pairs: int,
                    fast_k: int, tile_size: int, tile_cull: bool):
    """Packed int32 keys ``tile * rank_size + depth_rank`` (sentinel =
    dead/culled), the slow-path segment bounds, the true slow-pair count
    and the per-rank rect tile counts."""
    dev = order.device
    p = prep.depths.shape[0]
    num_tiles = grid_x * grid_y
    ctab = _cull_table(prep)[order.long()]   # one packed row gather (P, 10)
    # a rect can never legitimately touch more than the whole grid
    touched_s = torch.clamp(prep.tiles_touched[order.long()], 0, num_tiles)
    x0 = ctab[:, 0].to(torch.int32)
    y0 = ctab[:, 1].to(torch.int32)
    w_s = torch.clamp_min(ctab[:, 2].to(torch.int32) - x0, 1)
    sentinel = num_tiles * rank_size

    k_idx = _arange(fast_k, dev)[None, :]
    tile_x = x0[:, None] + k_idx % w_s[:, None]
    tile_y = y0[:, None] + torch.div(k_idx, w_s[:, None],
                                     rounding_mode="floor")
    tile_fast = tile_y * grid_x + tile_x
    is_fast = touched_s <= fast_k
    ok_fast = is_fast[:, None] & (k_idx < touched_s[:, None])
    ok_fast = ok_fast & (tile_fast >= 0) & (tile_fast < num_tiles)
    if tile_cull:
        qf = _tile_qmin(ctab[:, 4:5], ctab[:, 5:6], ctab[:, 6:7],
                        ctab[:, 7:8], ctab[:, 8:9],
                        tile_x.to(torch.float32), tile_y.to(torch.float32),
                        tile_size)
        ok_fast = ok_fast & (qf <= ctab[:, 9:10])
    rank = _arange(p, dev)[:, None]
    key_fast = torch.where(ok_fast, tile_fast * rank_size + rank,
                           torch.full_like(tile_fast, sentinel))

    touched_slow = torch.where(is_fast, torch.zeros_like(touched_s),
                               touched_s)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(touched_slow, 0, dtype=torch.int32)])
    total_slow = starts[-1]
    pair_idx = _arange(max_pairs, dev)
    pair_ok = pair_idx < torch.clamp_max(total_slow, max_pairs)
    gsrt = slot_owner(starts, p, max_pairs)
    # starts fit f32 exactly below 2^24 (one packed gather needs one dtype)
    assert max_pairs < 2**24, "slow pool too large for the f32-packed table"
    table = torch.cat([ctab[:, 0:2], w_s.to(torch.float32)[:, None],
                       starts[:p].to(torch.float32)[:, None], ctab[:, 4:10]],
                      dim=1)
    rows = table[gsrt.long()]               # one packed row gather (MP, 10)
    local = pair_idx - rows[:, 3].to(torch.int32)
    w_g = rows[:, 2].to(torch.int32)
    tx = rows[:, 0].to(torch.int32) + local % w_g
    ty = rows[:, 1].to(torch.int32) + torch.div(local, w_g,
                                                rounding_mode="floor")
    tile_slow = ty * grid_x + tx
    ok_slow = pair_ok & (tile_slow >= 0) & (tile_slow < num_tiles)
    if tile_cull:
        qs = _tile_qmin(rows[:, 4], rows[:, 5], rows[:, 6], rows[:, 7],
                        rows[:, 8], tx.to(torch.float32),
                        ty.to(torch.float32), tile_size)
        ok_slow = ok_slow & (qs <= rows[:, 9])
    key_slow = torch.where(ok_slow, tile_slow * rank_size + gsrt,
                           torch.full_like(tile_slow, sentinel))
    keys = torch.cat([key_fast.reshape(-1), key_slow])
    return keys, starts, total_slow, touched_s


def bin_stream(
    prep: Preprocessed,
    grid_x: int,
    grid_y: int,
    max_pairs: int,
    max_render: int,
    fast_k: int = 1,
    align: int = 256,
    tile_size: int = 16,
    tile_cull: bool = True,
) -> StreamBins:
    """Depth-sorted tile binning as a pair stream (see StreamBins)."""
    if fast_k < 1:
        raise ValueError("stream binning requires a fast path (fast_k >= 1)")
    dev = prep.depths.device
    p = prep.depths.shape[0]
    num_tiles = grid_x * grid_y
    rank_size = _next_pow2(max(p, 2))
    _check_rank_size(num_tiles, rank_size)
    order = _depth_order(prep)
    keys, starts, total_slow, touched_s = _emit_pair_keys(
        prep, order, grid_x, grid_y, rank_size, max_pairs, fast_k,
        tile_size, tile_cull)
    s = keys.shape[0]
    mr = min((max_render // align) * align, (s // align) * align)
    mr_al = mr + num_tiles * align        # aligned stream capacity
    # live keys are unique, so only the sentinel tail could order
    # differently from the JAX two-operand sort; no live slot reads it
    keys_sorted, slot_of_pos = torch.sort(keys, stable=True)

    boundaries = _arange(num_tiles + 1, dev) * rank_size
    bounds = torch.searchsorted(keys_sorted, boundaries, right=False).to(
        torch.int32)
    kept_true = bounds[-1]                 # first sentinel position
    kept = torch.clamp_max(kept_true, mr)
    tstart_pos = bounds[:-1]
    tcount = bounds[1:] - bounds[:-1]

    acount = torch.div(tcount + align - 1, align,
                       rounding_mode="floor") * align
    astart_all = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.cumsum(acount, 0, dtype=torch.int32)])
    kept_al = torch.clamp_max(astart_all[-1], mr_al)
    astart = torch.clamp_max(astart_all[:-1], mr_al)
    walk_counts = torch.minimum(tcount, torch.clamp_min(mr_al - astart, 0))

    rank_mr, gid_of_apos, ap_by_slot = place_stream(
        keys_sorted, slot_of_pos, order, tstart_pos, astart_all, kept, mr,
        mr_al, rank_size)

    num_rendered = torch.sum(touched_s, dtype=torch.int32)
    max_tile_count = torch.max(tcount)
    return StreamBins(
        order=order,
        rank_of_pos=rank_mr,
        gid_of_pos=gid_of_apos,
        pos_by_slot=ap_by_slot,
        slow_starts=starts,
        tstart=astart,
        walk_counts=walk_counts,
        tile_counts=tcount,
        kept=kept,
        kept_al=kept_al,
        num_rendered=num_rendered,
        overflow=total_slow > max_pairs,
        tile_overflow=kept_true > mr,
        max_tile_count=max_tile_count,
        align=align,
        fast_k=fast_k,
    )


def bin_gaussians(
    prep: Preprocessed,
    grid_x: int,
    grid_y: int,
    max_pairs: int,
    max_per_tile: int,
    fast_k: int = 8,
    tile_size: int = 16,
    tile_cull: bool = True,
) -> Binning:
    """Depth-sorted tile binning as a padded (num_tiles, max_per_tile) id
    matrix (see Binning); a tile's pairs past ``max_per_tile`` (its
    farthest) are dropped and flagged by ``tile_overflow``."""
    dev = prep.depths.device
    p = prep.depths.shape[0]
    num_tiles = grid_x * grid_y
    rank_size = _next_pow2(max(p, 2))
    _check_rank_size(num_tiles, rank_size)
    order = _depth_order(prep)
    keys, _, total_slow, touched_s = _emit_pair_keys(
        prep, order, grid_x, grid_y, rank_size, max_pairs, fast_k,
        tile_size, tile_cull)
    keys_sorted = torch.sort(keys).values

    boundaries = _arange(num_tiles + 1, dev) * rank_size
    bounds = torch.searchsorted(keys_sorted, boundaries, right=False).to(
        torch.int32)
    tstart = bounds[:-1]
    tcount = bounds[1:] - bounds[:-1]
    kidx = _arange(max_per_tile, dev)
    flat_idx = torch.clamp(tstart[:, None] + kidx[None, :], 0,
                           keys.shape[0] - 1)
    tile_mask = kidx[None, :] < torch.clamp_max(tcount, max_per_tile)[:, None]
    rank_mat = keys_sorted[flat_idx.long()] & (rank_size - 1)
    tile_gid = order[torch.clamp_max(rank_mat, p - 1).long()]

    max_tile_count = torch.max(tcount)
    return Binning(
        tile_gid=tile_gid,
        tile_mask=tile_mask,
        tile_counts=torch.clamp_max(tcount, max_per_tile),
        num_rendered=torch.sum(touched_s, dtype=torch.int32),
        overflow=total_slow > max_pairs,
        tile_overflow=max_tile_count > max_per_tile,
        max_tile_count=max_tile_count,
    )
