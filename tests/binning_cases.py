"""Seeded inputs of tile binning's two segment expansions (the slow pool's
slot owners and the stream's aligned placement), at their edges, in numpy,
with the brute-force rule each must follow. Imports no JAX, so that the card
tests that use it also run on a machine that has none."""

import numpy as np

# name -> (owner: p, pool, share of zero-length segments, segment lengths;
#          placement: tiles, share of empty tiles, pairs per live tile, mr,
#          mr_al, or None for bin_stream's mr + tiles * ALIGN)
EXPANSION_CASES = {
    # many zero-length segments, a live sentinel tail
    "zero_length_segments": dict(p=90, pool=600, zero=0.7, seg=(1, 12),
                                 tiles=24, empty=0.3, per_tile=(1, 40),
                                 mr=512, mr_al=None),
    # segment starts at and past the pool; every position live, the stream
    # truncated: many tiles clamped to mr - 1
    "starts_past_pool": dict(p=120, pool=256, zero=0.2, seg=(1, 9),
                             tiles=60, empty=0.1, per_tile=(3, 30), mr=64,
                             mr_al=None),
    # few live positions (kept < mr)
    "kept_below_mr": dict(p=40, pool=2048, zero=0.1, seg=(1, 6), tiles=12,
                          empty=0.5, per_tile=(1, 5), mr=1024, mr_al=None),
    # a short aligned capacity: live positions whose ap >= mr_al
    "ap_past_capacity": dict(p=200, pool=900, zero=0.4, seg=(1, 20),
                             tiles=30, empty=0.2, per_tile=(1, 70), mr=768,
                             mr_al=400),
    # nothing to place
    "mr_zero": dict(p=16, pool=0, zero=0.5, seg=(1, 4), tiles=6, empty=0.5,
                    per_tile=(1, 9), mr=0, mr_al=None),
}
ALIGN = 32


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def expansion_case(name: str, seed: int = 0) -> dict:
    """numpy inputs of ``slot_owner`` (starts, p, max_pairs) and
    ``place_stream`` (keys_sorted, slot_of_pos, order, tstart_pos,
    astart_all, kept, mr, mr_al, rank_size), laid out as ``bin_stream``
    makes them: starts non-decreasing from 0, keys sorted with a sentinel
    tail, tile starts from the key boundaries, aligned starts from counts
    rounded up to ALIGN."""
    c = EXPANSION_CASES[name]
    rng = np.random.default_rng(seed)
    p = c["p"]
    seg = rng.integers(*c["seg"], p, endpoint=True)
    seg[rng.uniform(size=p) < c["zero"]] = 0
    starts = np.concatenate([[0], np.cumsum(seg)]).astype(np.int32)

    rank_size = _next_pow2(max(p, 2))
    tiles = c["tiles"]
    tcount = rng.integers(*c["per_tile"], tiles, endpoint=True)
    tcount[rng.uniform(size=tiles) < c["empty"]] = 0
    live = np.concatenate([
        t * rank_size + np.sort(rng.choice(p, size=min(int(n), p),
                                           replace=False))
        for t, n in enumerate(tcount)]).astype(np.int64)
    tcount = np.array([min(int(n), p) for n in tcount])
    n_slots = max(len(live) + 50, c["mr"])
    keys = np.full(n_slots, tiles * rank_size, np.int64)
    keys[:len(live)] = live
    slot_of_pos = rng.permutation(n_slots).astype(np.int64)
    tstart_pos = np.concatenate([[0], np.cumsum(tcount)[:-1]])
    acount = -(-tcount // ALIGN) * ALIGN
    astart_all = np.concatenate([[0], np.cumsum(acount)])
    mr = c["mr"]
    mr_al = c["mr_al"] if c["mr_al"] is not None else mr + tiles * ALIGN
    return dict(
        starts=starts, p=p, max_pairs=c["pool"],
        keys_sorted=keys.astype(np.int32), slot_of_pos=slot_of_pos,
        order=rng.permutation(p).astype(np.int32),
        tstart_pos=tstart_pos.astype(np.int32),
        astart_all=astart_all.astype(np.int32),
        kept=np.int32(min(len(live), mr)), mr=mr, mr_al=mr_al,
        rank_size=rank_size)


def owner_rule(starts, p: int, max_pairs: int) -> np.ndarray:
    """Each pool slot j: the largest rank whose segment starts at or before
    j (0 where none does)."""
    out = np.zeros(max_pairs, np.int32)
    for j in range(max_pairs):
        ranks = np.nonzero(starts[:p] <= j)[0]
        out[j] = ranks.max() if len(ranks) else 0
    return out


def place_rule(keys_sorted, slot_of_pos, order, tstart_pos, astart_all,
               kept, mr: int, mr_al: int, rank_size: int):
    """Position by position: the rank from the key; the shift, the largest
    of 0 and every tile's astart - tstart whose start (clamped to mr - 1)
    is at or before the position; the writes of the live positions, each
    target written at most once."""
    p, s = len(order), len(keys_sorted)
    rank = np.minimum(keys_sorted[:mr] & (rank_size - 1), p - 1)
    gid = np.full(mr_al, p, np.int32)
    by_slot = np.full(s, mr_al, np.int32)
    seen_ap, seen_slot = set(), set()
    for i in range(min(int(kept), mr)):
        shifts = [0] + [int(astart_all[t]) - int(tstart_pos[t])
                        for t in range(len(tstart_pos))
                        if min(int(tstart_pos[t]), mr - 1) <= i]
        ap = i + max(shifts)
        if ap < mr_al:
            assert ap not in seen_ap
            seen_ap.add(ap)
            gid[ap] = order[rank[i]]
        slot = int(slot_of_pos[i])
        if slot < s:
            assert slot not in seen_slot
            seen_slot.add(slot)
            by_slot[slot] = ap
    return rank.astype(np.int32), gid, by_slot
