"""Port bin_gaussians against the JAX package: exact integers, the whole id
matrix included (its masked lanes hold real ids that the pregathered
blend's gather reads, and its adjoint adds zeros into).

Both sides bin THE SAME preprocessed arrays (JAX's, through numpy), so float
rounding in preprocess cannot break the integer comparison.
"""

import numpy as np
import jax
import pytest

from gs_localization_tpu.raster import binning as jbin
from gs_localization_tpu.raster.preprocess import preprocess as j_preprocess
from gs_localization_torch.raster import binning as tbin
from helpers import make_camera, random_scene
from torch_bridge import np_of, prep_to_torch

FIELDS = ("tile_gid", "tile_mask", "tile_counts", "num_rendered", "overflow",
          "tile_overflow", "max_tile_count")


@pytest.fixture(scope="module")
def prep():
    # 48x32 image, 100 Gaussians, large enough that some rects span many
    # tiles (slow path at small fast_k)
    g = random_scene(np.random.default_rng(5), n=100, sh_degree=1,
                     capacity=100, scale_range=(-3.0, -1.5))
    return jax.jit(lambda g, c: j_preprocess(g, c, tile_size=16))(
        g, make_camera(48, 32))


def _both(prep, **kw):
    j_bin = jax.jit(lambda p: jbin.bin_gaussians(p, 3, 2, **kw))
    return j_bin(prep), tbin.bin_gaussians(prep_to_torch(prep), 3, 2, **kw)


def _assert_equal(jb, tb):
    for name in FIELDS:
        np.testing.assert_array_equal(np_of(getattr(tb, name)),
                                      np_of(getattr(jb, name)),
                                      err_msg=name)


@pytest.mark.parametrize("max_per_tile,fast_k,tile_cull", [
    (128, 8, True), (128, 1, False), (128, 0, True), (16, 8, True)])
def test_bin_gaussians_exact(prep, max_per_tile, fast_k, tile_cull):
    jb, tb = _both(prep, max_pairs=1 << 12, max_per_tile=max_per_tile,
                   fast_k=fast_k, tile_cull=tile_cull)
    _assert_equal(jb, tb)
    assert tb.tile_gid.shape == (6, max_per_tile)
    counts = np_of(tb.tile_counts)
    if max_per_tile == 16:
        # a small cap truncates the busiest tiles
        assert bool(tb.tile_overflow) and int(tb.max_tile_count) > 16
        assert counts.max() == 16
    else:
        assert not bool(tb.tile_overflow) and counts.max() > 8


def test_slow_pool_overflow_flag(prep):
    jb, tb = _both(prep, max_pairs=8, max_per_tile=128, fast_k=1)
    assert bool(tb.overflow)
    _assert_equal(jb, tb)


def test_packed_key_assert(prep):
    """Past int32's reach (40,000 tiles x 2^16 rank slots) the packed keys
    are int64 and bin the same pairs as the int32 keys of the map without
    a tail of culled Gaussians."""
    import torch
    small = prep_to_torch(prep)
    n, wide_p = small.depths.shape[0], 1 << 16
    wide = type(small)(*(torch.cat([x, x.new_zeros((wide_p - n,)
                                                   + x.shape[1:])])
                         for x in small))
    kw = dict(max_pairs=1 << 12, max_per_tile=64, fast_k=1)
    a = tbin.bin_gaussians(small, 200, 200, **kw)
    b = tbin.bin_gaussians(wide, 200, 200, **kw)
    for name in FIELDS[1:]:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(a.tile_counts.sum()) > 100
    assert torch.equal(a.tile_gid[a.tile_mask], b.tile_gid[b.tile_mask])
