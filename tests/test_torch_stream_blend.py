"""Stream blend: the port's plain versions of K1/K2 against the JAX Pallas
kernels in interpret mode, on streams built by the JAX package and on the
edge windows of ``blend_edges.py`` laid into a stream. The CUDA kernels are
held against the plain versions in test_torch_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gs_localization_torch as gsl
from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import stream_blend as jsb
from gs_localization_tpu.raster.pose_mode import (
    _project_stream as j_project_stream,
    build_stream_pair_pack as j_build_pack)
from gs_localization_torch.raster import pallas_blend as pb
from gs_localization_torch.raster import stream_blend as sb
from blend_edges import EDGE_GRID, drift_window, edge_stream, edge_windows
from helpers import make_camera, random_scene
from torch_bridge import np_of

CASES = {
    # tiles of several chunks each (chunk 32)
    "multi_chunk": dict(seed=0, n=500, spread=1.0, chunk=32),
    # every tile single-chunk, border tiles empty (walk_count == 0): the
    # regime of the TPU runtime fault, KNOWN_ISSUES.md #1
    "single_chunk": dict(seed=4, n=40, spread=0.5, chunk=128),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    c = CASES[request.param]
    g = random_scene(np.random.default_rng(c["seed"]), c["n"],
                     spread=c["spread"])
    cam = make_camera(96, 64, fov=1.0)
    cfg = JConfig(max_pairs=1 << 14, max_render=1 << 14, fast_k=1,
                  backend="pallas_interpret", pallas_chunk=c["chunk"])
    pack = j_build_pack(g, cam, cfg)
    stream = j_project_stream(pack.params, cam)
    wc = np.asarray(pack.walk_counts)
    if request.param == "single_chunk":
        assert wc.max() <= c["chunk"] and (wc == 0).any()
    else:
        assert wc.max() > 2 * c["chunk"]
    return dict(stream=stream, tstart=pack.tstart, wcount=pack.walk_counts,
                kept_al=pack.kept_al, grid_x=6, chunk=c["chunk"])


def _torch_inputs(c):
    return (torch.tensor(np.asarray(c["stream"])),
            torch.tensor(np.asarray(c["tstart"])),
            torch.tensor(np.asarray(c["wcount"])))


def test_plain_forward_matches_pallas(case):
    c = case
    num_tiles = c["tstart"].shape[0]
    fwd_call, _ = jsb._make_stream_calls(num_tiles, c["grid_x"], 16,
                                         c["chunk"], c["stream"].shape[1],
                                         True)
    acc_j, logt_j, resid_j = fwd_call(c["tstart"], c["wcount"], c["stream"])
    stream, tstart, wcount = _torch_inputs(c)
    acc, logt, resid = sb.stream_blend_fwd_plain(stream, tstart, wcount,
                                                 c["grid_x"], 16, c["chunk"])
    np.testing.assert_allclose(np_of(acc), np_of(acc_j), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(np_of(logt), np_of(logt_j), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(np_of(resid)[..., 0], np_of(resid_j)[..., 0],
                               atol=3e-5, rtol=3e-5)
    np.testing.assert_array_equal(np_of(resid)[..., 1],
                                  np_of(resid_j)[..., 1])      # k_stop


def test_direct_blend_grad_matches_pallas(case):
    c = case
    num_tiles = c["tstart"].shape[0]
    rng = np.random.default_rng(1)
    wc = rng.standard_normal((num_tiles, 256, 3)).astype(np.float32)
    wd = rng.standard_normal((num_tiles, 256)).astype(np.float32)
    wt = rng.standard_normal((num_tiles, 256)).astype(np.float32)

    def jloss(s):
        out = jsb.blend_stream_direct(s, c["tstart"], c["wcount"],
                                      c["kept_al"], c["grid_x"], 16,
                                      chunk=c["chunk"], interpret=True)
        return (jnp.sum(out.color * wc) + jnp.sum(out.depth * wd)
                + jnp.sum(jnp.exp(out.log_t) * wt))

    g_j = np.asarray(jax.grad(jloss)(c["stream"]))
    stream, tstart, wcount = _torch_inputs(c)
    stream.requires_grad_()
    before = dict(gsl.LAUNCHES)
    out = sb.blend_stream_direct(stream, tstart, wcount,
                                 torch.tensor(np.asarray(c["kept_al"])),
                                 c["grid_x"], 16, chunk=c["chunk"])
    loss = ((out.color * torch.tensor(wc)).sum()
            + (out.depth * torch.tensor(wd)).sum()
            + (torch.exp(out.log_t) * torch.tensor(wt)).sum())
    loss.backward()
    assert gsl.LAUNCHES == before      # CPU tensors take the plain versions
    np.testing.assert_allclose(float(loss.detach()),
                               float(jloss(c["stream"])),
                               rtol=1e-5)
    g = np_of(stream.grad)
    kept_al = int(c["kept_al"])
    assert (g[:, kept_al:] == 0).all()
    assert (g[[6, 7, 12, 13, 14, 15]] == 0).all()
    np.testing.assert_allclose(g, g_j, atol=5e-3, rtol=1e-2)
    assert np.abs(g).max() > 0


def test_cuda_wrapper_rejects_bad_inputs(case):
    stream, tstart, wcount = _torch_inputs(case)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sb.stream_blend_fwd_cuda(stream, tstart, wcount, 6, 16, 32)
    with pytest.raises(ValueError, match="tile_size"):
        sb.stream_blend_fwd_cuda(stream, tstart, wcount, 6, 8, 32)
    with pytest.raises(ValueError, match="chunk"):
        sb.stream_blend_bwd_cuda(stream, tstart, wcount, None, None, None,
                                 None, 6, 16, 48)


EDGE_CHUNK = 256


@pytest.fixture(scope="module")
def edge():
    """edge_windows at chunk 256, as windows and laid into a stream, with
    seeded cotangents (the one on log_t still to be scaled by T)."""
    counts, geom, rgbd = edge_windows(EDGE_CHUNK)
    rng = np.random.default_rng(2)
    shape = (len(counts), 256)
    return dict(windows=(counts, geom, rgbd),
                stream=edge_stream(counts, geom, rgbd, EDGE_CHUNK),
                gacc=rng.standard_normal((shape[0], 4, 256)).astype(
                    np.float32),
                glogt=rng.standard_normal(shape + (1,)).astype(np.float32))


def _hold_forward(acc, logt, acc_j, logt_j, rgbd_max: float):
    """The plain K1's accum and log_t against the TPU K1's at 3e-5, except
    at "flipped" pixels: a pair whose inclusive log T lies within rounding
    of log(1e-4) is applied by one summation order only (cumsum, or the
    TPU's triangular matmul), and the last bits of the plain version's
    sums there vary between processes. Such a pixel's T differs by the
    pair's weight w = alpha T_before <= 1e-4 alpha / (1 - alpha), and each
    accum channel by w times the pair's value. The card tests account for
    the same pixels. Returns the mask of the other pixels."""
    lt, lt_j = np_of(logt)[..., 0], np_of(logt_j)[..., 0]
    eps = np.log(1e-4)
    flip = ((np.minimum(np.abs(lt - eps), np.abs(lt_j - eps)) <= 1e-4)
            & (np.abs(lt - lt_j) > 3e-5))
    assert flip.sum() <= 2
    keep = ~flip
    np.testing.assert_allclose(lt[keep], lt_j[keep], atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(np_of(acc) * keep[:, None],
                               np_of(acc_j) * keep[:, None], atol=3e-5,
                               rtol=3e-5)
    d_t = np.abs(np.exp(lt) - np.exp(lt_j))[flip]
    d_acc = np.abs(np_of(acc) - np_of(acc_j)).max(axis=1)[flip]
    assert (d_t <= 1e-4 * 0.99 / 0.01).all()
    assert (d_acc <= d_t * rgbd_max + 3e-5).all()
    return keep


def _plain_stream(edge):
    """The plain K1/K2 on the edge stream: forward outputs, and dstream
    for the fixture's cotangents."""
    ts = [torch.tensor(a) for a in edge["stream"]]
    acc, logt, resid = sb.stream_blend_fwd_plain(*ts, EDGE_GRID[0], 16,
                                                 EDGE_CHUNK)
    glogt = torch.tensor(edge["glogt"]) * torch.exp(logt)
    d = sb.stream_blend_bwd_plain(*ts, torch.tensor(edge["gacc"]), glogt,
                                  EDGE_GRID[0], 16, EDGE_CHUNK)
    return (acc, logt, resid), glogt, d


def test_plain_matches_pallas_at_edge_windows(edge):
    stream, tstart, wcount = edge["stream"]
    fwd_call, bwd_call = jsb._make_stream_calls(
        len(tstart), EDGE_GRID[0], 16, EDGE_CHUNK, stream.shape[1], True)
    acc_j, logt_j, resid_j = fwd_call(tstart, wcount, stream)
    (acc, logt, resid), glogt, d = _plain_stream(edge)
    keep = _hold_forward(acc, logt, acc_j, logt_j, float(stream[8:12].max()))
    np.testing.assert_allclose(np_of(resid)[..., 0][keep],
                               np_of(resid_j)[..., 0][keep], atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_array_equal(np_of(resid)[..., 1],
                                  np_of(resid_j)[..., 1])      # k_stop
    k_stop = np_of(resid)[:, 0, 1]
    # empty; saturated in its first chunk; full cap; 7 chunks + 8 lanes
    assert k_stop[1] == 0 and k_stop[7] == 1
    assert k_stop[2] == 8 and k_stop[6] == 8
    d_j = np.asarray(bwd_call(tstart, wcount, stream, edge["gacc"],
                              np_of(glogt), resid_j))
    # the TPU kernel writes whole chunks of each window up to its last
    # (zeros past k_stop) and leaves every other position unwritten
    n_chunks = -(-wcount // EDGE_CHUNK)
    pos = np.arange(stream.shape[1])[None, :]
    written = ((pos >= tstart[:, None])
               & (pos < (tstart + n_chunks * EDGE_CHUNK)[:, None])).any(0)
    d = np_of(d)
    np.testing.assert_allclose(d[:, written], d_j[:, written], atol=5e-3,
                               rtol=1e-2)
    assert (d[:, ~written] == 0).all() and np.abs(d).max() > 0


def test_plain_stream_matches_plain_pregathered(edge):
    """The plain K1/K2 on the edge stream and the plain K3/K4 on the same
    windows compute the same function."""
    counts, geom, rgbd = (torch.tensor(a) for a in edge["windows"])
    (acc, logt, resid), glogt, d = _plain_stream(edge)
    out_g = pb.pregathered_blend_fwd_plain(counts, geom, rgbd, EDGE_GRID[0],
                                           16, EDGE_CHUNK)
    for x, y in zip((acc, logt, resid), out_g):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    dgeom, drgbd = pb.pregathered_blend_bwd_plain(
        counts, geom, rgbd, torch.tensor(edge["gacc"]), glogt, EDGE_GRID[0],
        16, EDGE_CHUNK)
    num_tiles, _, cap = geom.shape
    blocks = d[:12, :num_tiles * cap].reshape(12, num_tiles, cap)
    torch.testing.assert_close(blocks[:8].transpose(0, 1), dgeom, atol=0,
                               rtol=0)
    torch.testing.assert_close(blocks[8:].transpose(0, 1), drgbd, atol=0,
                               rtol=0)
    assert (d[:, num_tiles * cap:] == 0).all() and (d[12:] == 0).all()


def test_drift_window_defeats_a_rebuilt_log_t():
    """drift_window laid into a stream. The plain K1 agrees with the TPU K1
    and applies each planted pixel's first three pairs and not the fourth
    (log_t lies within 1e-4 above log(1e-4)). The TPU K2 tells the applied
    pairs by log T rebuilt by subtraction from log_full through the ~4,000
    pairs walked after saturation, misses the last applied pair of some
    planted pixels, and so lies off the plain K2 (autograd of the forward)
    by more than the kernels' tolerance at their pairs. The window thus
    plants the case the port's K2/K4 answer with the forward's record of
    each pixel's last applied lane; test_torch_cuda.py holds them to the
    plain versions on it."""
    counts, geom, rgbd, planted = drift_window()
    stream, tstart, wcount = edge_stream(counts, geom, rgbd, 256)
    fwd_call, bwd_call = jsb._make_stream_calls(1, 1, 16, 256,
                                                stream.shape[1], True)
    acc_j, logt_j, resid_j = fwd_call(tstart, wcount, stream)
    ts = [torch.tensor(a) for a in (stream, tstart, wcount)]
    acc, logt, _ = sb.stream_blend_fwd_plain(*ts, 1, 16, 256)
    _hold_forward(acc, logt, acc_j, logt_j, float(stream[8:12].max()))
    above = np_of(logt)[0, planted[:, 0], 0] - np.log(1e-4)
    assert (above > 0).all() and (above < 1.1e-4).all()
    rng = np.random.default_rng(3)
    gacc = rng.standard_normal((1, 4, 256)).astype(np.float32)
    glogt = (rng.standard_normal((1, 256, 1)).astype(np.float32)
             * np.exp(np_of(logt)))
    d = np_of(sb.stream_blend_bwd_plain(*ts, torch.tensor(gacc),
                                        torch.tensor(glogt), 1, 16, 256))
    d_j = np.asarray(bwd_call(tstart, wcount, stream, gacc, glogt, resid_j))
    own = slice(0, 4 * len(planted))        # the planted pixels' own pairs
    off = (np.abs(d_j - d)[:12, own]
           / (5e-3 + 1e-2 * np.abs(d[:12, own])))
    assert off.max() > 1


def test_slot_order_pack_grad_matches_jax_core_bwd():
    """The pack gradient's reduction alone: the grad stream that the JAX
    ``_make_stream_core`` backward reduces (its K2 in interpret mode on the
    same inputs) through the port's ``slot_order_pack_grad`` against the
    pack cotangent of that core's VJP. Fast slots (fast_k 1) and slow
    segments both carry pairs. Tolerance: 1e-5 of the largest |gradient|
    (JAX takes the slow segments' sums as differences of a float32 running
    sum over the whole slow pool, the port of a float64 one)."""
    from gs_localization_tpu.raster.preprocess import preprocess as j_prep
    from gs_localization_tpu.raster.rasterize import compute_bins as j_bins
    from gs_localization_torch.raster.binning import StreamBins

    g = random_scene(np.random.default_rng(7), 150, sh_degree=1,
                     scale_range=(-3.0, -1.8))
    cam = make_camera(32, 32, fov=1.0)
    chunk, fast_k, grid_x = 64, 1, 2
    cfg = JConfig(max_pairs=1 << 14, max_render=1 << 14, fast_k=fast_k,
                  backend="pallas_interpret", pallas_chunk=chunk)
    prep = jax.jit(j_prep)(g, cam)      # eager JAX compiles every op
    pack = jnp.stack(
        [prep.means2d[:, 0], prep.means2d[:, 1], prep.conic[:, 0],
         prep.conic[:, 1], prep.conic[:, 2], prep.opacity,
         prep.valid.astype(jnp.float32), jnp.zeros_like(prep.opacity),
         prep.rgb[:, 0], prep.rgb[:, 1], prep.rgb[:, 2], prep.depths], axis=1)
    jb = jax.jit(lambda g_, c: j_bins(g_, c, cfg))(g, cam)
    p, num_tiles = pack.shape[0], int(jb.tstart.shape[0])
    mr_al, s = int(jb.gid_of_pos.shape[0]), int(jb.pos_by_slot.shape[0])
    starts = np.asarray(jb.slow_starts)
    assert starts[-1] > 0                       # some pairs are slow
    core = jsb._make_stream_core(num_tiles, grid_x, 16, chunk, fast_k, p,
                                 mr_al, s, True)
    ints = (jb.gid_of_pos, jb.pos_by_slot, jb.slow_starts, jb.order,
            jb.tstart, jb.walk_counts, jb.kept_al)
    rng = np.random.default_rng(9)
    gacc = jnp.asarray(rng.standard_normal((num_tiles, 4, 256)), jnp.float32)
    glogt = jnp.asarray(rng.standard_normal((num_tiles, 256, 1)), jnp.float32)
    dpack_j = jax.jit(lambda pk, ga, gl: jax.vjp(
        lambda x: core(x, *ints), pk)[1]((ga, gl))[0])(pack, gacc, glogt)

    tbins = StreamBins(**{f: torch.tensor(np.asarray(getattr(jb, f)))
                          for f in StreamBins._fields
                          if f not in ("align", "fast_k")},
                       align=chunk, fast_k=fast_k)
    stream_t = sb.assemble_stream(torch.tensor(np.asarray(pack)),
                                  tbins.gid_of_pos, chunk)
    fwd_call, bwd_call = jsb._make_stream_calls(num_tiles, grid_x, 16, chunk,
                                                stream_t.shape[1], True)
    st = jnp.asarray(stream_t.numpy())
    dstream = jax.jit(lambda ts, wc, st_, ga, gl: bwd_call(
        ts, wc, st_, ga, gl, fwd_call(ts, wc, st_)[2]))(
            jb.tstart, jb.walk_counts, st, gacc, glogt)
    dpack_t = np_of(sb.slot_order_pack_grad(torch.tensor(np.asarray(dstream)),
                                            tbins, 12))
    scale = float(np.abs(np.asarray(dpack_j)).max())
    assert scale > 0 and (dpack_t[:, 6:8] == 0).all()
    np.testing.assert_allclose(dpack_t, np.asarray(dpack_j), rtol=0,
                               atol=1e-5 * scale)
