"""Port bin_stream against the JAX package: exact integers.

Both sides bin THE SAME preprocessed arrays (JAX's, through numpy), so float
rounding in preprocess cannot break the integer comparison.
"""

import numpy as np
import pytest

from gs_localization_tpu.raster import binning as jbin
from gs_localization_tpu.raster.preprocess import preprocess as j_preprocess
from gs_localization_torch.raster import binning as tbin
from binning_cases import (EXPANSION_CASES, expansion_case, owner_rule,
                           place_rule)
from helpers import make_camera, random_scene
from torch_bridge import np_of, prep_to_torch

FIELDS = ("order", "rank_of_pos", "gid_of_pos", "pos_by_slot", "slow_starts",
          "tstart", "walk_counts", "tile_counts", "kept", "kept_al",
          "num_rendered", "overflow", "tile_overflow", "max_tile_count")


@pytest.fixture(scope="module")
def slow_heavy():
    # big scales -> rects spanning many tiles -> slow-path heavy at fast_k=1
    g = random_scene(np.random.default_rng(3), n=120, sh_degree=1,
                     scale_range=(-2.5, -1.2))
    return j_preprocess(g, make_camera(64, 48), tile_size=16), 4, 3


@pytest.fixture(scope="module")
def wide():
    g = random_scene(np.random.default_rng(0), 500, capacity=512)
    return j_preprocess(g, make_camera(96, 64, fov=1.0), tile_size=16), 6, 4


def _both(prep, gx, gy, **kw):
    return (jbin.bin_stream(prep, gx, gy, **kw),
            tbin.bin_stream(prep_to_torch(prep), gx, gy, **kw))


def _assert_equal(jb, tb):
    for name in FIELDS:
        np.testing.assert_array_equal(np_of(getattr(tb, name)),
                                      np_of(getattr(jb, name)),
                                      err_msg=name)


@pytest.mark.parametrize("fast_k,align,tile_cull", [
    (1, 32, True), (1, 64, False), (8, 32, True), (8, 128, True)])
def test_bin_stream_exact(slow_heavy, wide, fast_k, align, tile_cull):
    for prep, gx, gy in (slow_heavy, wide):
        jb, tb = _both(prep, gx, gy, max_pairs=1 << 15, max_render=1 << 15,
                       fast_k=fast_k, align=align, tile_cull=tile_cull)
        assert not bool(jb.overflow) and not bool(jb.tile_overflow)
        _assert_equal(jb, tb)
        assert tb.align == align


def test_slow_path_is_exercised(slow_heavy):
    prep, gx, gy = slow_heavy
    _, tb = _both(prep, gx, gy, max_pairs=1 << 15, max_render=1 << 15,
                  fast_k=1, align=32)
    # most pairs come from the slow pool at fast_k=1 on this scene
    assert int(tb.slow_starts[-1]) > int(tb.kept) // 2


def test_stream_truncation_flag(slow_heavy):
    prep, gx, gy = slow_heavy
    jb, tb = _both(prep, gx, gy, max_pairs=1 << 15, max_render=64, fast_k=1,
                   align=32)
    assert bool(tb.tile_overflow) and int(tb.kept) == 64
    _assert_equal(jb, tb)


def test_slow_pool_overflow_flag(slow_heavy):
    prep, gx, gy = slow_heavy
    jb, tb = _both(prep, gx, gy, max_pairs=16, max_render=1 << 15, fast_k=1,
                   align=32)
    assert bool(tb.overflow)
    _assert_equal(jb, tb)


def test_windows_are_aligned_and_disjoint(wide):
    prep, gx, gy = wide
    tb = tbin.bin_stream(prep_to_torch(prep), gx, gy, max_pairs=1 << 15,
                         max_render=1 << 15, fast_k=1, align=64)
    start, count = np_of(tb.tstart), np_of(tb.walk_counts)
    assert (start % 64 == 0).all()
    ends = start + -(-count // 64) * 64
    order = np.argsort(start, kind="stable")
    assert (ends[order][:-1] <= start[order][1:]).all()
    assert int(ends.max()) <= int(tb.kept_al)


def test_packed_key_assert():
    import torch
    from gs_localization_torch.raster.preprocess import Preprocessed
    p = 1 << 16
    z = torch.zeros(p)
    prep = Preprocessed(z, torch.zeros(p, 2), torch.zeros(p, 3),
                        torch.zeros(p, 3), z, z.int(), torch.zeros(p, 4).int(),
                        z.int(), z.bool())
    with pytest.raises(AssertionError, match="packed sort key"):
        tbin.bin_stream(prep, 200, 200, max_pairs=64, max_render=64)


PLACE_ARGS = ("keys_sorted", "slot_of_pos", "order", "tstart_pos",
              "astart_all", "kept")


@pytest.mark.parametrize("name", list(EXPANSION_CASES))
def test_segment_expansions_follow_brute_force(name):
    """The plain versions behind the binning kernels' interfaces
    (``slot_owner``, ``place_stream``) against the brute-force rules of
    ``binning_cases``, at their edges."""
    import torch
    c = expansion_case(name)
    owner = tbin.slot_owner(torch.from_numpy(c["starts"]), c["p"],
                            c["max_pairs"])
    np.testing.assert_array_equal(
        owner.numpy(), owner_rule(c["starts"], c["p"], c["max_pairs"]))
    got = tbin.place_stream(*(torch.from_numpy(np.asarray(c[k]))
                              for k in PLACE_ARGS),
                            c["mr"], c["mr_al"], c["rank_size"])
    want = place_rule(*(c[k] for k in PLACE_ARGS), c["mr"], c["mr_al"],
                      c["rank_size"])
    for field, g, w in zip(("rank_of_pos", "gid_of_pos", "pos_by_slot"), got,
                           want):
        assert g.dtype == torch.int32, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
