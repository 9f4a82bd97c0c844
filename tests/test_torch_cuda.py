"""The port's CUDA kernels on the card, held against the plain PyTorch
versions and the CPU path on the same seeded inputs.

Every test here needs an NVIDIA card and skips without one. The file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import gs_localization_torch as gsl
from gs_localization_torch.core import sh as sh_lib
from gs_localization_torch.core.camera import Camera
from gs_localization_torch.core.gaussians import FIELDS, GaussianParams
from gs_localization_torch.loc import TrackingConfig, refine_pose
from gs_localization_torch.mapping import train as mtrain
from gs_localization_torch.raster import RasterizerConfig, rasterize
from gs_localization_torch.raster import binning
from gs_localization_torch.raster import pallas_blend as pb
from gs_localization_torch.raster import stream_blend as sb
from gs_localization_torch.raster.constants import LOG_T_EPS
from gs_localization_torch.raster.pose_mode import (
    _project_pairs, _project_stream, build_pair_pack, build_stream_pair_pack,
    render_pose_mode)
from binning_cases import EXPANSION_CASES, expansion_case
from blend_edges import EDGE_GRID, drift_window, edge_stream, edge_windows

pytestmark = pytest.mark.cuda

CASES = {
    # tiles of several chunks each
    "multi_chunk": dict(seed=0, n=500, spread=1.0, chunk=32, cap=512),
    # every tile single-chunk, some tiles empty (walk_count == 0)
    "single_chunk": dict(seed=4, n=40, spread=0.5, chunk=128, cap=128),
}
TRAINED = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
           "opacity")
# K3/K4 against their plain versions at the edge windows, as chip_smoke.py
# holds them at the training windows: accum
# (atol, rtol); log_t atol off the "flipped" pixels (a pair within rounding
# of log(1e-4) of LOG_T_EPS, applied by one summation order only), whose T
# and accum get their own bounds; gradients (atol, rtol) with the flipped
# pixels' cotangents zeroed
TOL_FWD = (1e-4, 1e-4)
TOL_LOGT = 1e-4
EPS_BAND = 1e-4
TOL_BWD = (5e-3, 1e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(seed: int, n: int, spread: float):
    """Random Gaussians in front of a camera at the origin, as numpy: the
    draws of ``tests/helpers.py::random_scene`` at SH degree 2."""
    rng = np.random.default_rng(seed)
    k = sh_lib.num_sh_coeffs(2)
    xyz = np.stack([rng.uniform(-spread, spread, n),
                    rng.uniform(-spread, spread, n),
                    rng.uniform(2.0, 6.0, n)], 1)
    fdc = sh_lib.rgb_to_sh_dc(rng.uniform(0.05, 0.95, (n, 3)))[:, None, :]
    frest = 0.1 * rng.standard_normal((n, k - 1, 3))
    scaling = rng.uniform(-3.5, -2.0, (n, 3))
    rot = rng.standard_normal((n, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return {"xyz": xyz, "features_dc": fdc, "features_rest": frest,
            "scaling": scaling, "rotation": rot,
            "opacity": rng.uniform(-1.0, 3.0, (n, 1)),
            "live": np.ones(n, bool)}


def _on(arrays, device):
    g = GaussianParams.from_numpy(arrays, 2, 2, device=device)
    fx = 96 / (2.0 * np.tan(0.5))
    cam = Camera.from_rt(np.eye(3), np.zeros(3), fx, fx, 96, 64,
                         device=device)
    return g, cam


@pytest.fixture(params=list(CASES))
def case(request, cuda_device):
    c = CASES[request.param]
    arrays = _scene(c["seed"], c["n"], c["spread"])
    cfg = RasterizerConfig(max_pairs=1 << 14, max_render=1 << 14, fast_k=1,
                           pallas_chunk=c["chunk"])
    g, cam = _on(arrays, cuda_device)
    pack = build_stream_pair_pack(g, cam, cfg)
    wc = pack.walk_counts.cpu().numpy()
    if request.param == "single_chunk":
        assert wc.max() <= c["chunk"] and (wc == 0).any()
    else:
        assert wc.max() > 2 * c["chunk"]
    with torch.no_grad():
        stream = _project_stream(pack.params, cam)
    return dict(arrays=arrays, cfg=cfg, pack=pack, stream=stream,
                chunk=c["chunk"], device=cuda_device,
                pre=cfg.replace(use_stream=False, max_per_tile=c["cap"]))


def test_kernels_match_plain(case):
    pack, chunk = case["pack"], case["chunk"]
    args = (case["stream"], pack.tstart, pack.walk_counts, 6, 16, chunk)
    before = dict(gsl.LAUNCHES)
    acc_k, logt_k, resid_k, walk_k = sb.stream_blend_fwd_cuda(*args)
    acc_p, logt_p, resid_p = sb.stream_blend_fwd_plain(*args)
    assert gsl.LAUNCHES["stream_fwd"] == before["stream_fwd"] + 1
    # sums in another order (sequential vs cumsum); log_t is held as
    # T = exp(log_t): a pair whose inclusive log T lies within rounding of
    # log(1e-4) is applied by one order and not the other
    torch.testing.assert_close(acc_k, acc_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(torch.exp(logt_k), torch.exp(logt_p),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(resid_k[..., 1], resid_p[..., 1])       # k_stop
    gen = torch.Generator().manual_seed(0)
    gacc = torch.randn(acc_k.shape, generator=gen).to(case["device"])
    glogt = (torch.randn(logt_k.shape, generator=gen).to(case["device"])
             * torch.exp(logt_k))
    d_k = sb.stream_blend_bwd_cuda(*args[:3], gacc, glogt, logt_k, walk_k,
                                   6, 16, chunk)
    d_p = sb.stream_blend_bwd_plain(*args[:3], gacc, glogt, 6, 16, chunk)
    torch.cuda.synchronize()
    assert gsl.LAUNCHES["stream_bwd"] == before["stream_bwd"] + 1
    # analytic reverse walk vs autograd of the forward, log T rebuilt by
    # subtraction from log_t: the JAX suite's Gaussian-gradient tolerance
    torch.testing.assert_close(d_k, d_p, atol=5e-3, rtol=1e-2)
    assert (d_k[[6, 7, 12, 13, 14, 15]] == 0).all()


def test_cuda_path_matches_cpu_path(case):
    cfg = case["cfg"]
    out = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        pack = build_stream_pair_pack(g, cam, cfg)
        tau = torch.zeros(6, device=dev, requires_grad=True)
        c, d, a = render_pose_mode(pack, cam.with_delta(tau), cfg)
        (c.sum() + 0.1 * d.sum() + 0.01 * a.sum()).backward()
        out.append([x.detach().cpu() for x in (c, d, a, tau.grad)])
        with torch.no_grad():
            full = rasterize(g, cam, cfg)
        torch.testing.assert_close(full.color, c.detach(), atol=1e-5,
                                   rtol=0)
    for x_k, x_p in zip(out[0][:3], out[1][:3]):
        torch.testing.assert_close(x_k, x_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(out[0][3], out[1][3], atol=1e-3, rtol=1e-3)


def test_refine_pose_cuda_matches_cpu(case):
    cfg = case["cfg"]
    tau = torch.tensor([0.01, -0.008, 0.012, 0.02, -0.015, 0.01])
    tcfg = TrackingConfig(num_iters=5, lr=1e-3, convergence=0.0,
                          rebin_every=10, pose_mode=True)
    res = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        with torch.no_grad():
            gt = rasterize(g, cam, cfg)
        mask = torch.ones(gt.color.shape[:2], dtype=torch.bool, device=dev)
        res.append(refine_pose(g, cam.with_delta(tau.to(dev)), gt.color,
                               mask, tcfg, cfg, gt_depth=gt.depth))
    assert res[0].num_iters == res[1].num_iters == 5
    torch.testing.assert_close(res[0].w2c.cpu(), res[1].w2c, atol=1e-4,
                               rtol=0)


def test_wrappers_reject_bad_cuda_inputs(case):
    pack, chunk, stream = case["pack"], case["chunk"], case["stream"]
    with pytest.raises(TypeError, match="tstart"):
        sb.stream_blend_fwd_cuda(stream, pack.tstart.long(), pack.walk_counts,
                                 6, 16, chunk)
    with pytest.raises(ValueError, match="contiguous"):
        sb.stream_blend_fwd_cuda(stream.T.contiguous().T, pack.tstart,
                                 pack.walk_counts, 6, 16, chunk)
    with pytest.raises(ValueError, match="on cpu"):
        sb.stream_blend_fwd_cuda(stream, pack.tstart.cpu(), pack.walk_counts,
                                 6, 16, chunk)


def test_gaussian_fields_round_trip(cuda_device):
    arrays = _scene(1, 16, 1.0)
    g = GaussianParams.from_numpy(arrays, 2, 2, device=cuda_device)
    back = g.to_numpy()
    for f in FIELDS:
        np.testing.assert_allclose(back[f], np.asarray(arrays[f],
                                                       back[f].dtype))


# ---- the pregathered layout: K3/K4 ------------------------------------------

def _hold_forward(out_k, out_p, rgbd_max: float, flips: bool):
    """A forward kernel's (accum, log_t, resid) against its plain version's:
    k_stop equal on every tile; accum and T at 1e-5 or, with ``flips``, at
    chip_smoke.py's tolerances with its accounting of the flipped pixels.
    Returns the mask of the pixels no pair flips (all ones without
    ``flips``)."""
    (acc_k, logt_k, resid_k), (acc_p, logt_p, resid_p) = out_k, out_p
    assert torch.equal(resid_k[..., 1], resid_p[..., 1])       # k_stop
    keep = torch.ones_like(logt_k[..., 0])
    if flips:
        d_lt = (logt_k - logt_p).abs()[..., 0]
        near = torch.minimum((logt_k - LOG_T_EPS).abs(),
                             (logt_p - LOG_T_EPS).abs())[..., 0] <= EPS_BAND
        keep = (~(near & (d_lt > TOL_LOGT))).float()
        assert float((d_lt * keep).max()) <= TOL_LOGT
        torch.testing.assert_close(acc_k * keep[:, None],
                                   acc_p * keep[:, None],
                                   atol=TOL_FWD[0], rtol=TOL_FWD[1])
        d_t = (torch.exp(logt_k) - torch.exp(logt_p)).abs()[..., 0]
        assert float((d_t * (1 - keep)).max()) <= 1e-4
        d_acc = (acc_k - acc_p).abs() * (1 - keep)[:, None]
        assert float(d_acc.max()) <= 1e-4 * rgbd_max
    else:
        # as K1: sums in another order, log_t held as T = exp(log_t)
        torch.testing.assert_close(acc_k, acc_p, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(torch.exp(logt_k), torch.exp(logt_p),
                                   atol=1e-5, rtol=1e-5)
    return keep


def _cotangents(acc_k, logt_k, keep):
    """Seeded cotangents of accum and log_t (through T = exp(log_t)), zero
    on the pixels ``keep`` leaves out."""
    gen = torch.Generator().manual_seed(0)
    gacc = torch.randn(acc_k.shape, generator=gen).to(acc_k.device)
    glogt = (torch.randn(logt_k.shape, generator=gen).to(acc_k.device)
             * torch.exp(logt_k))
    return gacc * keep[:, None], glogt * keep[..., None]


def _same(out_a, out_b) -> bool:
    """Two forward launches' outputs, their walks included, bit for bit."""
    (*ta, wa), (*tb, wb) = out_a, out_b
    return all(torch.equal(a, b) for a, b in zip(ta + list(wa), tb + list(wb)))


def hold_pregathered(counts, geom, rgbd, grid_x, chunk, flips=False):
    """K3 and K4 against their plain versions, k_stop equal on every tile,
    the tile order the card computed, the same bits from a second launch,
    and K4's lanes at or past each tile's walked end (and its valid and pad
    rows) exactly 0. The forward is held as K1 is (accum and T at 1e-5);
    with ``flips``, at chip_smoke.py's tolerances with its accounting of
    the flipped pixels. Returns K3's outputs."""
    args = (counts, geom, rgbd, grid_x, 16, chunk)
    before = dict(gsl.LAUNCHES)
    out_k = pb.pregathered_blend_fwd_cuda(*args)
    again = pb.pregathered_blend_fwd_cuda(*args)
    # the order the card computed: deepest first, ties in tile order
    assert torch.equal(out_k[3].order.cpu(),
                       pb.tile_order(counts.cpu(), geom.shape[2]))
    out_p = pb.pregathered_blend_fwd_plain(*args)
    assert gsl.LAUNCHES["pregathered_fwd"] == before["pregathered_fwd"] + 2
    assert _same(out_k, again)
    acc_k, logt_k, resid_k, walk_k = out_k
    keep = _hold_forward(out_k[:3], out_p, float(rgbd.abs().max()), flips)
    gacc, glogt = _cotangents(acc_k, logt_k, keep)
    d_k = pb.pregathered_blend_bwd_cuda(*args[:3], gacc, glogt, logt_k,
                                        walk_k, grid_x, 16, chunk)
    d_again = pb.pregathered_blend_bwd_cuda(*args[:3], gacc, glogt, logt_k,
                                            walk_k, grid_x, 16, chunk)
    d_p = pb.pregathered_blend_bwd_plain(*args[:3], gacc, glogt, grid_x, 16,
                                         chunk)
    torch.cuda.synchronize()
    assert gsl.LAUNCHES["pregathered_bwd"] == before["pregathered_bwd"] + 2
    assert all(torch.equal(a, b) for a, b in zip(d_k, d_again))
    for k, p in zip(d_k, d_p):
        torch.testing.assert_close(k, p, atol=TOL_BWD[0], rtol=TOL_BWD[1])
    # lanes past the count (real ids, summed by the gather adjoint) or past
    # the last visited chunk, and the valid and pad rows, are exactly zero
    cap = geom.shape[2]
    end = torch.minimum(counts.long().clamp(0, cap),
                        resid_k[:, 0, 1].long() * chunk)
    past = torch.arange(cap, device=geom.device)[None, :] >= end[:, None]
    assert all(bool((d.transpose(0, 1)[:, past] == 0).all()) for d in d_k)
    assert (d_k[0][:, 6:] == 0).all()
    return out_k


def test_pregathered_kernels_match_plain(case):
    g, cam = _on(case["arrays"], case["device"])
    pack = build_pair_pack(g, cam, case["pre"])
    assert not bool(pack.overflow)
    with torch.no_grad():
        geom, rgbd = _project_pairs(pack.params, cam)
    hold_pregathered(pack.counts, geom.contiguous(), rgbd.contiguous(), 6,
                     case["chunk"])
    # the edges of the piece walk, at the training chunk and at a chunk
    # that is not a multiple of the 64-lane piece
    for chunk in (256, 96):
        counts, geom_e, rgbd_e = (torch.tensor(a, device=case["device"])
                                  for a in edge_windows(chunk))
        out = hold_pregathered(counts, geom_e, rgbd_e, EDGE_GRID[0], chunk,
                               flips=True)
        k_stop = out[2][:, 0, 1]
        assert float(k_stop[7]) == 1 and float(k_stop[6]) == 8
        assert float(k_stop[2]) == 8 and float(k_stop[1]) == 0


# ---- the stream layout at the edge windows: K1/K2 ---------------------------

def _edge_inputs(chunk: int, device):
    """edge_windows(chunk) as (counts, geom, rgbd) and laid into a stream as
    (stream, tstart, walk_counts), on ``device``."""
    counts, geom, rgbd = edge_windows(chunk)
    stream, tstart, wcount = edge_stream(counts, geom, rgbd, chunk)
    return ([torch.tensor(a, device=device) for a in (counts, geom, rgbd)],
            [torch.tensor(a, device=device) for a in (stream, tstart, wcount)])


def hold_stream(stream, tstart, wcount, grid_x, chunk, flips=False):
    """K1/K2 held as hold_pregathered holds K3/K4: against the plain
    versions (with ``flips``, the flipped pixels accounted for), k_stop on
    every tile, the tile order the card computed, the same bits from a
    second launch, and dstream exactly 0 in rows 6, 7 and 12-15 and at
    every position outside the walked lanes. Returns K1's outputs."""
    args = (stream, tstart, wcount, grid_x, 16, chunk)
    before = dict(gsl.LAUNCHES)
    out_k = sb.stream_blend_fwd_cuda(*args)
    again = sb.stream_blend_fwd_cuda(*args)
    # the order the card computed: deepest first, ties in tile order
    assert torch.equal(out_k[3].order.cpu(), sb.tile_order(
        tstart.cpu(), wcount.cpu(), stream.shape[1], chunk))
    out_p = sb.stream_blend_fwd_plain(*args)
    assert gsl.LAUNCHES["stream_fwd"] == before["stream_fwd"] + 2
    assert _same(out_k, again)
    acc_k, logt_k, resid_k, walk_k = out_k
    keep = _hold_forward(out_k[:3], out_p, float(stream[8:12].abs().max()),
                         flips)
    gacc, glogt = _cotangents(acc_k, logt_k, keep)
    bargs = (*args[:3], gacc, glogt, logt_k, walk_k, *args[3:])
    d_k = sb.stream_blend_bwd_cuda(*bargs)
    d_again = sb.stream_blend_bwd_cuda(*bargs)
    d_p = sb.stream_blend_bwd_plain(*args[:3], gacc, glogt, *args[3:])
    torch.cuda.synchronize()
    assert gsl.LAUNCHES["stream_bwd"] == before["stream_bwd"] + 2
    assert torch.equal(d_k, d_again)
    torch.testing.assert_close(d_k, d_p, atol=TOL_BWD[0], rtol=TOL_BWD[1])
    # the walked lanes: [tstart, tstart + min(count, k_stop * chunk))
    k_stop = resid_k[:, 0, 1]
    end = tstart.long() + torch.minimum(wcount.long(), k_stop.long() * chunk)
    pos = torch.arange(stream.shape[1], device=stream.device)[None, :]
    walked = ((pos >= tstart[:, None]) & (pos < end[:, None])).any(0)
    assert (d_k[:, ~walked] == 0).all()
    assert (d_k[[6, 7, 12, 13, 14, 15]] == 0).all()
    assert (d_k[:, walked] != 0).any()
    return out_k


@pytest.mark.parametrize("chunk", (256, 96))
def test_stream_kernels_match_plain_at_edge_windows(cuda_device, chunk):
    """K1/K2 at the edge windows laid into a stream, held as K3/K4 are held
    there (hold_stream)."""
    _, (stream, tstart, wcount) = _edge_inputs(chunk, cuda_device)
    out = hold_stream(stream, tstart, wcount, EDGE_GRID[0], chunk, flips=True)
    k_stop = out[2][:, 0, 1]
    assert float(k_stop[7]) == 1 and float(k_stop[6]) == 8
    assert float(k_stop[2]) == 8 and float(k_stop[1]) == 0


def test_kernels_follow_their_forward_after_long_walks(cuda_device):
    """drift_window: pixels whose last applied pair lies within 1e-4 of
    log(1e-4) walk ~4,000 pairs past saturation, where log T rebuilt by
    subtraction through every walked pair misses that pair on about half
    of them (the TPU kernel's rule: test_torch_stream_blend.py holds its
    backward off the plain one there). K1/K3 record each planted pixel's
    last applied lane, and K2/K4, held to the plain versions in both
    layouts, follow that record."""
    counts, geom, rgbd, planted = drift_window()
    stream, tstart, wcount = (torch.tensor(a, device=cuda_device) for a in
                              edge_stream(counts, geom, rgbd, 256))
    counts, geom, rgbd = (torch.tensor(a, device=cuda_device)
                          for a in (counts, geom, rgbd))
    out = hold_pregathered(counts, geom, rgbd, 1, 256)
    assert torch.equal(out[3].last[0, planted[:, 0]].cpu(),
                       torch.tensor(planted[:, 1], dtype=torch.int32))
    out_s = hold_stream(stream, tstart, wcount, 1, 256)
    assert torch.equal(out_s[3].last, out[3].last)


@pytest.mark.parametrize("chunk", (256, 96))
def test_stream_kernels_equal_pregathered_kernels(cuda_device, chunk):
    """K1/K2 and K3/K4 run one forward and one backward body, so on the
    same windows (tile t's at stream position t * cap) they give the same
    bits: the forward's outputs and walks (K1's log T records, one row per
    stream chunk, are K3's (T, cap / chunk) records laid end to end), and
    the backward's gradients at every lane, zeros included."""
    (counts, geom, rgbd), (stream, tstart, wcount) = _edge_inputs(
        chunk, cuda_device)
    gx = EDGE_GRID[0]
    out_s = sb.stream_blend_fwd_cuda(stream, tstart, wcount, gx, 16, chunk)
    out_g = pb.pregathered_blend_fwd_cuda(counts, geom, rgbd, gx, 16, chunk)
    num_tiles, _, cap = geom.shape
    rec_s = out_s[3].chunk_logt
    assert all(torch.equal(a, b) for a, b in zip(out_s[:3], out_g[:3]))
    assert torch.equal(out_s[3].order, out_g[3].order)
    assert torch.equal(out_s[3].last, out_g[3].last)
    assert torch.equal(rec_s[:num_tiles * cap // chunk].reshape(
        out_g[3].chunk_logt.shape), out_g[3].chunk_logt)
    assert (rec_s[num_tiles * cap // chunk:] == 0).all()
    gacc, glogt = _cotangents(out_s[0], out_s[1],
                              torch.ones_like(out_s[1][..., 0]))
    d_s = sb.stream_blend_bwd_cuda(stream, tstart, wcount, gacc, glogt,
                                   out_s[1], out_s[3], gx, 16, chunk)
    dgeom, drgbd = pb.pregathered_blend_bwd_cuda(counts, geom, rgbd, gacc,
                                                 glogt, out_g[1], out_g[3],
                                                 gx, 16, chunk)
    torch.cuda.synchronize()
    blocks = d_s[:12, :num_tiles * cap].reshape(12, num_tiles, cap)
    assert torch.equal(blocks[:8].transpose(0, 1), dgeom)
    assert torch.equal(blocks[8:].transpose(0, 1), drgbd)
    assert (d_s[:, num_tiles * cap:] == 0).all() and (d_s[12:] == 0).all()


def test_pregathered_cuda_path_matches_cpu_path(case):
    """rasterize(use_stream=False) on the card and on the CPU: images, the
    Gaussian-parameter and the means2d_offset gradients."""
    cfg = case["pre"]
    out = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        params = {f: getattr(g, f).clone().requires_grad_() for f in TRAINED}
        off = torch.zeros((g.capacity, 2), device=dev, requires_grad=True)
        r = rasterize(g.replace(**params), cam, cfg, means2d_offset=off)
        (r.color.sum() + 0.1 * r.depth.sum() + 0.01 * r.alpha.sum()).backward()
        out.append(([x.detach().cpu() for x in (r.color, r.depth, r.alpha)],
                    [params[f].grad.cpu() for f in TRAINED] + [off.grad.cpu()]))
    for x_k, x_p in zip(out[0][0], out[1][0]):
        torch.testing.assert_close(x_k, x_p, atol=1e-5, rtol=0)
    for name, g_k, g_p in zip(TRAINED + ("means2d_offset",), out[0][1],
                              out[1][1]):
        scale = float(g_p.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(g_k / scale, g_p / scale, atol=5e-3,
                                   rtol=1e-2, msg=name)


@pytest.mark.parametrize("layout", ["pregathered", "stream"])
def test_train_step_cuda_matches_cpu(case, layout):
    """One train_step on the card and on the CPU, on the pregathered
    layout (K3/K4) and on the stream layout (K1/K2 and the slot-order
    pack gradient): the two devices sum in other orders, so tolerances,
    not bits."""
    cfg = case["pre"] if layout == "pregathered" else case["cfg"]
    tau = torch.tensor([0.01, -0.008, 0.012, 0.02, -0.015, 0.01])
    res = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        with torch.no_grad():
            gt = rasterize(g, cam.with_delta(tau.to(dev)), cfg)
        state = mtrain.init_training(g, mtrain.MapTrainConfig())
        gsl.reset_launches()
        state, aux = mtrain.train_step(state, cam, gt.color,
                                       mtrain.MapTrainConfig(), cfg,
                                       gt_depth=gt.depth)
        if dev.type == "cuda":
            k = "stream" if layout == "stream" else "pregathered"
            assert gsl.LAUNCHES[f"{k}_fwd"] == gsl.LAUNCHES[f"{k}_bwd"] == 1
        res.append((float(aux["total"]), state))
    (l_k, s_k), (l_p, s_p) = res
    assert l_k == pytest.approx(l_p, rel=1e-5)
    for name in TRAINED:
        # the first moment is 0.1 x the gradient after one step
        mu_k, mu_p = s_k.opt_state[name].mu.cpu(), s_p.opt_state[name].mu
        scale = max(float(mu_p.abs().max()), 1e-30)
        torch.testing.assert_close(mu_k / scale, mu_p / scale, atol=5e-3,
                                   rtol=1e-2, msg=name)
    torch.testing.assert_close(s_k.densify.denom.cpu(), s_p.densify.denom)


@pytest.mark.parametrize("layout", ["pregathered", "stream"])
def test_pseudo_view_step_cuda_matches_cpu(case, layout):
    """One ``train_step`` with the few-shot pseudo-view term on the card
    against the CPU from the same state: the pseudo camera's render and
    its backward launch the layout's kernels once more."""
    cfg = case["pre"] if layout == "pregathered" else case["cfg"]
    tau = torch.tensor([0.01, -0.008, 0.012, 0.02, -0.015, 0.01])
    tau_p = torch.tensor([-0.03, 0.02, 0.01, 0.03, 0.02, -0.02])
    res = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        pcam = cam.with_delta(tau_p.to(dev))
        with torch.no_grad():
            gt = rasterize(g, cam.with_delta(tau.to(dev)), cfg)
            prior = 1.0 / (0.1 + rasterize(g, pcam, cfg).color.mean(-1))
        state = mtrain.init_training(g, mtrain.MapTrainConfig())
        gsl.reset_launches()
        state, aux = mtrain.train_step(state, cam, gt.color,
                                       mtrain.MapTrainConfig(), cfg,
                                       gt_depth=gt.depth, pseudo_camera=pcam,
                                       pseudo_view_depth=prior)
        if dev.type == "cuda":
            k = "stream" if layout == "stream" else "pregathered"
            assert gsl.LAUNCHES[f"{k}_fwd"] == gsl.LAUNCHES[f"{k}_bwd"] == 2
        res.append((aux, state))
    (a_k, s_k), (a_p, s_p) = res
    for k in ("total", "pseudo_view"):
        assert float(a_k[k]) == pytest.approx(float(a_p[k]), rel=1e-5), k
    for name in TRAINED:
        mu_k, mu_p = s_k.opt_state[name].mu.cpu(), s_p.opt_state[name].mu
        scale = max(float(mu_p.abs().max()), 1e-30)
        torch.testing.assert_close(mu_k / scale, mu_p / scale, atol=5e-3,
                                   rtol=1e-2, msg=name)
    torch.testing.assert_close(s_k.densify.denom.cpu(), s_p.densify.denom)


@pytest.mark.parametrize("layout", ["pregathered", "stream"])
def test_batched_step_cuda_matches_cpu(case, layout):
    """``train_step_batched`` over 3 views on the card against the CPU:
    one forward and one backward launch per view."""
    cfg = case["pre"] if layout == "pregathered" else case["cfg"]
    taus = torch.tensor(np.random.default_rng(3).uniform(
        -0.02, 0.02, (3, 6)), dtype=torch.float32)
    res = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        cams = [cam.with_delta(t.to(dev)) for t in taus]
        with torch.no_grad():
            gts = torch.stack([rasterize(g, c.with_delta(taus[0].to(dev)),
                                         cfg).color for c in cams])
        state = mtrain.init_training(g, mtrain.MapTrainConfig())
        gsl.reset_launches()
        state, aux = mtrain.train_step_batched(
            state, cams, gts, mtrain.MapTrainConfig(), cfg)
        if dev.type == "cuda":
            k = "stream" if layout == "stream" else "pregathered"
            assert gsl.LAUNCHES[f"{k}_fwd"] == gsl.LAUNCHES[f"{k}_bwd"] == 3
        res.append((aux, state))
    (a_k, s_k), (a_p, s_p) = res
    assert float(a_k["total"]) == pytest.approx(float(a_p["total"]),
                                                rel=1e-5)
    assert int(a_k["max_tile_count"]) == int(a_p["max_tile_count"])
    for name in TRAINED:
        mu_k, mu_p = s_k.opt_state[name].mu.cpu(), s_p.opt_state[name].mu
        scale = max(float(mu_p.abs().max()), 1e-30)
        torch.testing.assert_close(mu_k / scale, mu_p / scale, atol=5e-3,
                                   rtol=1e-2, msg=name)
    torch.testing.assert_close(s_k.densify.denom.cpu(), s_p.densify.denom)


def test_oracle_and_n_touched_cuda_match_cpu(case):
    """render_oracle and rasterize(return_n_touched=True) on the card
    against the CPU. Both are plain PyTorch on either device (no hand
    kernel: the JAX functions are ``lax.scan``s): images to 1e-5; the
    touched-pixel counts equal. (A count can differ only where a pair's
    alpha or inclusive log T lies within a few float32 ULPs of its
    threshold: ``chip_smoke.py``'s n_touched phase measured none on these
    two scenes, and one pixel of one Gaussian in 100,000 at the bench
    scene, whose alpha lay 2 ULPs above 1/255 on the card and 6 below on
    the CPU.)"""
    from gs_localization_torch.raster.oracle import render_oracle

    cfg = case["pre"].replace(chunk=32)
    outs = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        with torch.no_grad():
            o = render_oracle(g, cam, bg=torch.tensor([0.2, 0.1, 0.3],
                                                      device=dev))
            r = rasterize(g, cam, cfg, return_n_touched=True)
        outs.append(([x.cpu() for x in o], r.n_touched.cpu(),
                     r.color.cpu()))
    (o_k, n_k, c_k), (o_p, n_p, c_p) = outs
    for x_k, x_p in zip(o_k, o_p):
        torch.testing.assert_close(x_k, x_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-5, rtol=0)
    assert n_k.dtype == torch.int32 and int(n_p.max()) > 0
    assert torch.equal(n_k, n_p)


def _blobs(rng, h: int, w: int, n: int = 300) -> np.ndarray:
    """A grayscale image of Gaussian blobs in [0, 1] (float32)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w))
    for y0, x0, a, s in zip(rng.uniform(8, h - 8, n), rng.uniform(8, w - 8, n),
                            rng.uniform(0.3, 1.0, n), rng.uniform(1.5, 5, n)):
        img += a * np.exp(-((yy - y0) ** 2 + (xx - x0) ** 2) / (2 * s * s))
    return (img / img.max()).astype(np.float32)


def test_harris_and_sift_cuda_match_cpu(cuda_device):
    """The SfM extractors on the card against the CPU: Harris (shifted-add
    filters, the same bits) slot for slot; SIFT, whose histograms are
    scatter-adds (atomics on the card), by the share of keypoints at the
    same position with the same orientation and a descriptor within
    cosine 0.9999."""
    from gs_localization_torch.sfm.features import extract_harris_features
    from gs_localization_torch.sfm.sift import extract_sift

    img = _blobs(np.random.default_rng(3), 240, 320)
    fc = extract_harris_features(img, device="cpu")
    fg = extract_harris_features(img, device=cuda_device)
    kc, kg = fc.keypoints.numpy(), fg.keypoints.cpu().numpy()
    valid = fc.scores.numpy() > 0
    assert valid.sum() > 100
    same = np.all(kc == kg, axis=1)
    assert same[valid].mean() >= 0.99
    np.testing.assert_allclose(fg.scores.cpu().numpy()[same],
                               fc.scores.numpy()[same], rtol=1e-5)
    np.testing.assert_allclose(fg.descriptors.cpu().numpy()[same],
                               fc.descriptors.numpy()[same], atol=1e-5)
    sc = extract_sift(img, device="cpu")
    sg = extract_sift(img, device=cuda_device)
    valid = sc.scores.numpy() > 0
    assert valid.sum() > 50
    pos = np.abs(sg.keypoints.cpu().numpy() - sc.keypoints.numpy()).max(1) \
        <= 1e-3
    ori = sg.orientations.cpu().numpy() == sc.orientations.numpy()
    cos = np.sum(sg.descriptors.cpu().numpy() * sc.descriptors.numpy(), 1)
    share = (pos & ori & (cos >= 0.9999))[valid].mean()
    assert share >= 0.95, (pos[valid].mean(), ori[valid].mean())


def test_bundle_adjust_cuda_matches_cpu(cuda_device):
    """bundle_adjust_np (15 LM steps) on the card against the CPU: 5
    cameras on an arc perturbed by 0.015-rad tangents, 150 points moved by
    4 cm, 0.3 px noise. Only camera 0 is fixed, so the scale of the
    solution is free: translations and points move along that gauge with
    the CG's rounding (the gathers' adjoints are atomics on the card). The
    card's camera centres and points are brought onto the CPU's by one
    similarity (Umeyama) before they are compared, within 1 mm: past the
    gauge the 15-step float32 solution still sits in a flat valley whose
    costs agree far below the cost tolerance (the card read 0.24 mm for
    the centres and 0.31 mm for the points). Costs, rotations and
    reprojections are compared as they come."""
    from gs_localization_torch.core.se3 import se3_exp
    from gs_localization_torch.sfm.bundle_adjust import bundle_adjust_np
    from gs_localization_torch.sfm.evaluate import umeyama_alignment

    rng = np.random.default_rng(0)
    K = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]])
    X = np.stack([rng.uniform(-2.5, 2.5, 150), rng.uniform(-1.8, 1.8, 150),
                  rng.uniform(5.0, 9.0, 150)], 1)
    w2c = np.tile(np.eye(4), (5, 1, 1))
    for c in range(5):
        a = (c - 2.5) * 0.08
        w2c[c, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        w2c[c, :3, 3] = [-0.6 * c + 2.0, 0.05 * c, 0.05 * c]
    cam_idx = np.repeat(np.arange(5), 150)
    pt_idx = np.tile(np.arange(150), 5)

    def project(w, x):
        Xc = np.einsum("eij,ej->ei", w[cam_idx, :3, :3], x[pt_idx]) \
            + w[cam_idx, :3, 3]
        return Xc[:, :2] / Xc[:, 2:] * 520.0 + [320, 240]

    uv = project(w2c, X) + 0.3 * rng.standard_normal((750, 2))
    tau = torch.tensor(0.015 * rng.standard_normal((5, 6)),
                       dtype=torch.float32)
    w2c0 = se3_exp(tau).numpy() @ w2c
    w2c0[0] = w2c[0]
    args = (w2c0, np.tile(K[None], (5, 1, 1)),
            X + 0.04 * rng.standard_normal(X.shape), cam_idx, pt_idx, uv)
    wc, xc, c0c, cc = bundle_adjust_np(*args, device="cpu")
    wg, xg, c0g, cg = bundle_adjust_np(*args, device=cuda_device)
    np.testing.assert_allclose(c0g, c0c, rtol=1e-5)
    np.testing.assert_allclose(cg, cc, rtol=1e-3)
    assert cg < 0.02 * c0g
    np.testing.assert_allclose(wg[:, :3, :3], wc[:, :3, :3], atol=1e-4)
    d_px = np.abs(project(wg, xg) - project(wc, xc)).max()
    assert d_px < 0.05, d_px

    def centres(w):
        return -np.einsum("cji,cj->ci", w[:, :3, :3], w[:, :3, 3])

    src = np.concatenate([centres(wg), xg])
    s, R, t = umeyama_alignment(src, np.concatenate([centres(wc), xc]))
    aligned = s * src @ R.T + t
    d_cam = np.abs(aligned[:5] - centres(wc)).max()
    d_pts = np.abs(aligned[5:] - xc).max()
    print(f"BA card vs CPU: gauge scale {s:.7f}, aligned camera centres "
          f"{d_cam:.3g}, points {d_pts:.3g} apart at most")
    assert d_cam < 1e-3, d_cam
    assert d_pts < 1e-3, d_pts


def _sharp_superpoint(device):
    """SuperPoint at PyTorch's default init (seed 0), its detector logits
    scaled by 100 so that scores are peaked and few responses tie."""
    from gs_localization_torch.sfm.superpoint import SuperPointNet

    torch.manual_seed(0)
    net = SuperPointNet("cpu")
    with torch.no_grad():
        net.convPb.weight.mul_(100.0)
        net.convPb.bias.mul_(100.0)
    return net.to(device)


def test_superpoint_cuda_matches_cpu_with_tf32_on(cuda_device):
    """The runner's own process leaves cuDNN's TF32 on (PyTorch's default);
    the net holds float32 itself, so the card's score map is the CPU's
    within 1e-5 (TF32 would move these peaked scores by ~1e-2), >= 0.99 of
    the CPU's keypoints are among the card's (cuDNN's summation order may
    move near-ties, and one keypoint admitted or not shifts every later
    slot, so pixels are compared as sets), and the flags come back as
    they were."""
    from gs_localization_torch.sfm.superpoint import extract_superpoint

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (480, 640)).astype(np.float32)
    net_c, net_g = _sharp_superpoint("cpu"), _sharp_superpoint(cuda_device)
    img_g = torch.tensor(img, device=cuda_device)
    cpu = extract_superpoint(net_c, torch.tensor(img), 4096, 3)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = extract_superpoint(net_g, img_g, 4096, 3)
        with torch.no_grad():
            d_map = float((net_g(img_g)[0].cpu()
                           - net_c(torch.tensor(img))[0]).abs().max())
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = old
    valid = cpu.scores.numpy() > 0
    ref = {tuple(p) for p in cpu.keypoints.numpy()[valid]}
    got = {tuple(p) for p in card.keypoints.cpu().numpy()}
    assert int((card.scores > 0).sum()) == len(ref) > 1000
    assert len(ref & got) >= 0.99 * len(ref)
    assert d_map <= 1e-5, d_map


def test_networks_cuda_match_cpu(cuda_device):
    """SuperGlue (256 keypoints, sinkhorn 5), NetVLAD (128x160) and both
    depth priors' estimate_depth (at reduced MiDaS depth) on the card
    against the CPU, from the same weights."""
    from gs_localization_torch.ops import dpt, midas
    from gs_localization_torch.sfm import netvlad
    from gs_localization_torch.sfm.superglue import (SuperGlueNet,
                                                     superglue_match)

    rng = np.random.default_rng(1)
    torch.manual_seed(0)
    sg = SuperGlueNet("cpu")
    kp = [torch.tensor(rng.uniform(0, 640, (256, 2)), dtype=torch.float32)
          for _ in range(2)]
    sc = [torch.tensor(rng.uniform(0.1, 1, 256), dtype=torch.float32)
          for _ in range(2)]
    de = [torch.nn.functional.normalize(torch.randn(256, 256), dim=1)
          for _ in range(2)]
    args = (kp[0], sc[0], de[0], kp[1], sc[1], de[1], 640, 480, 640, 480)
    rc = superglue_match(sg, *args, sinkhorn_iters=5)
    rg = superglue_match(sg.to(cuda_device), *[
        a.to(cuda_device) if isinstance(a, torch.Tensor) else a
        for a in args], sinkhorn_iters=5)
    np.testing.assert_allclose(rg.matching_scores0.cpu().numpy(),
                               rc.matching_scores0.numpy(), atol=1e-4)
    img = rng.uniform(0, 1, (128, 160, 3)).astype(np.float32)
    nv_p = netvlad.init_params(np.random.default_rng(2))
    dc = netvlad.netvlad_descriptor(netvlad.NetVLAD(nv_p, "cpu"),
                                    torch.tensor(img))
    dg = netvlad.netvlad_descriptor(netvlad.NetVLAD(nv_p, cuda_device),
                                    torch.tensor(img, device=cuda_device))
    np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(), rtol=2e-3,
                               atol=2e-5)
    for mod, p in ((dpt, dpt.init_params(np.random.default_rng(3))),
                   (midas, midas.init_params(np.random.default_rng(4),
                                             stage_blocks=(1, 1, 1, 1)))):
        cls = mod.DPT if mod is dpt else mod.MiDaS
        ec = mod.estimate_depth(cls(p, "cpu"), torch.tensor(img), 128, 160)
        eg = mod.estimate_depth(cls(p, cuda_device),
                                torch.tensor(img, device=cuda_device),
                                128, 160)
        scale = float(ec.abs().max())
        np.testing.assert_allclose(eg.cpu().numpy() / scale,
                                   ec.numpy() / scale, atol=5e-4)


def _rgb_blobs(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([_blobs(rng, h, w, 400) for _ in range(3)], -1)


def _write_and_load(name, wdir, device):
    from gs_localization_torch.sfm import weights

    path = weights.write_random(name, str(wdir), seed=0)
    return weights.load(name, path, device="cpu"), weights.load(
        name, path, device=device)


def test_hloc_extractors_cuda_match_cpu(cuda_device, tmp_path):
    """r2d2, d2net-ss and disk at 240x320 from ``write_random``'s
    checkpoints: the dense outputs within 1e-4 of their scale, the keypoint
    counts within 1 % and >= 0.99 of the CPU's keypoints within 1e-3 px of
    one of the card's (near-ties in the NMS or at the top-k cut move later
    slots, so keypoints are compared as sets; D2-Net's are sub-pixel)."""
    from gs_localization_torch.sfm.d2net import dense_features
    from gs_localization_torch.sfm.disk import unet_forward
    from gs_localization_torch.sfm.r2d2 import r2d2_forward
    from gs_localization_torch.sfm.registry import get_extractor

    img = torch.tensor(_rgb_blobs(5, 240, 320))
    for conf, name, dense in (("r2d2", "r2d2", r2d2_forward),
                              ("d2net-ss", "d2net", dense_features),
                              ("disk", "disk", unet_forward)):
        net_c, net_g = _write_and_load(name, tmp_path, cuda_device)
        fc = get_extractor(conf, params=net_c, num_keypoints=2048)(img)
        fg = get_extractor(conf, params=net_g, num_keypoints=2048)(
            img.to(cuda_device))
        with torch.no_grad(), gsl.float32_exact():
            oc, og = dense(net_c, img), dense(net_g, img.to(cuda_device))
        oc, og = (oc, og) if isinstance(oc, tuple) else ((oc,), (og,))
        for a, b in zip(oc, og):
            scale = float(a.abs().max())
            assert float((b.cpu() - a).abs().max()) <= 1e-4 * scale, conf
        ref = fc.keypoints.numpy()[fc.scores.numpy() > 0]
        got = fg.keypoints.cpu().numpy()
        near = np.abs(ref[:, None] - got[None]).max(-1).min(1) <= 1e-3
        n_g = int((fg.scores > 0).sum())
        assert len(ref) > 100 and abs(n_g - len(ref)) <= 0.01 * len(ref), conf
        assert near.mean() >= 0.99, conf


def test_hloc_matchers_cuda_match_cpu(cuda_device):
    """LightGlue (512 keypoints a side, PyTorch's default init) and LoFTR
    (``chip_smoke.sharp_loftr_params``, census matching, on two shifted
    240x320 views, 256 slots) on the card against the CPU: the same
    matches on >= 0.99 of the rows / cells, scores within 1e-4, LoFTR's
    sub-pixel keypoints within 0.05 px."""
    from chip_smoke import sharp_loftr_params
    from gs_localization_torch.sfm.features import rgb_to_gray
    from gs_localization_torch.sfm.lightglue import (LightGlueNet,
                                                     lightglue_match)
    from gs_localization_torch.sfm.loftr import (loftr_from_jax_params,
                                                 loftr_match)

    rng = np.random.default_rng(6)
    torch.manual_seed(0)
    lg = LightGlueNet("cpu")
    kp = [torch.tensor(rng.uniform(0, 480, (512, 2)), dtype=torch.float32)
          for _ in range(2)]
    de = [torch.nn.functional.normalize(torch.randn(512, 256), dim=1)
          for _ in range(2)]
    args = (kp[0], de[0], kp[1], de[1], 640, 480, 640, 480)
    rc = lightglue_match(lg, *args, match_threshold=0.0)
    rg = lightglue_match(lg.to(cuda_device), *[
        a.to(cuda_device) if isinstance(a, torch.Tensor) else a
        for a in args], match_threshold=0.0)
    assert float((rg.matches0.cpu() == rc.matches0).float().mean()) >= 0.99
    np.testing.assert_allclose(rg.matching_scores0.cpu().numpy(),
                               rc.matching_scores0.numpy(), atol=1e-4)

    big = _rgb_blobs(7, 256, 336)
    views = [torch.tensor(big[:240, :320]), torch.tensor(big[5:245, 3:323])]
    gray = [rgb_to_gray(v) for v in views]
    params = sharp_loftr_params(0)
    out = []
    for dev in ("cpu", cuda_device):
        net = loftr_from_jax_params(params, dev)
        m = loftr_match(net, *[g.to(dev) for g in gray], max_matches=256)
        k0, k1, sc = (a.cpu().numpy() for a in m)
        out.append({tuple(c): (p, s) for c, p, s in zip(k1, k0, sc)
                    if s > 0})
    cells_c, cells_g = out
    common = cells_c.keys() & cells_g.keys()
    assert len(cells_c) > 50 and len(common) >= 0.99 * len(cells_c)
    for c in common:
        assert np.abs(cells_g[c][0] - cells_c[c][0]).max() <= 0.05
        assert abs(cells_g[c][1] - cells_c[c][1]) <= 1e-4


def test_hloc_global_descriptors_cuda_match_cpu(cuda_device):
    """DIR (resnet18 with a PCA whitening), OpenIBL and EigenPlaces
    (resnet18) at PyTorch's default init on a 128x160 image: the card's
    descriptor within 1e-4 of the CPU's largest entry."""
    from gs_localization_torch.sfm.dir import (DirNet, dir_descriptor,
                                               load_pca_from_sklearn)
    from gs_localization_torch.sfm.eigenplaces import (
        EigenPlacesNet, eigenplaces_descriptor)
    from gs_localization_torch.sfm.openibl import (OpenIBLNet,
                                                   openibl_descriptor)

    class PCA:
        rng = np.random.default_rng(8)
        mean_ = 0.01 * rng.standard_normal(256).astype(np.float32)
        components_ = np.linalg.qr(rng.standard_normal((256, 256)))[0].T
        explained_variance_ = np.linspace(2.0, 0.1, 256).astype(np.float32)

    img = torch.tensor(_rgb_blobs(9, 128, 160))
    torch.manual_seed(0)
    pca = load_pca_from_sklearn(PCA)
    for make, fn in (
            (lambda: DirNet("resnet18", 256, "cpu"), dir_descriptor),
            (lambda: OpenIBLNet("cpu"), openibl_descriptor),
            (lambda: EigenPlacesNet("resnet18", 256, "cpu"),
             eigenplaces_descriptor)):
        net = make()
        if isinstance(net, DirNet):
            net.set_pca(pca)
        dc = fn(net, img)
        net = net.to(cuda_device)
        if isinstance(net, DirNet):
            net.set_pca(pca)
        dg = fn(net, img.to(cuda_device))
        assert bool(torch.isfinite(dg).all())
        assert float((dg.cpu() - dc).abs().max()) <= 1e-4 * float(
            dc.abs().max())


# ---- the id-matrix blend, reproducible stream training, a 1-rank NCCL group --

def test_blend_tiles_cuda_matches_plain_at_a_tile_run(case):
    """``blend.blend_tiles`` on the card (the windows gathered, K3/K4 with
    the run's first tile ``tile0`` = 2) against its plain version on the
    same inputs (K3's plain forward at that tile0) and against the CPU
    path (the scan): images, and the gradients of a seeded loss in every
    blend input."""
    from gs_localization_torch.raster import blend as tblend
    from gs_localization_torch.raster.preprocess import preprocess
    from gs_localization_torch.raster.rasterize import bin_gaussians_for

    cfg, chunk = case["pre"], case["chunk"]
    lo, hi = 2, 20                                   # tiles of the 6 x 4 grid
    outs = []
    for dev in (case["device"], torch.device("cpu")):
        g, cam = _on(case["arrays"], dev)
        with torch.no_grad():
            prep = preprocess(g, cam)
            bins = bin_gaussians_for(prep, cam, cfg)
        fields = [x.detach().clone().requires_grad_() for x in (
            prep.means2d, prep.conic, prep.rgb, prep.opacity, prep.depths)]
        pix = tblend.tile_pixel_coords(6, 4, 16, dev)[lo:hi]
        before = dict(gsl.LAUNCHES)
        out = tblend.blend_tiles(bins.tile_gid[lo:hi], bins.tile_mask[lo:hi],
                                 *fields, 6, 4, 16, chunk=32, pix=pix,
                                 pallas_chunk=chunk)
        gen = torch.Generator().manual_seed(3)
        w = [torch.randn(x.shape, generator=gen).to(dev)
             for x in (out.color, out.depth, out.log_t)]
        loss = ((out.color * w[0]).sum() + (out.depth * w[1]).sum()
                + (torch.exp(out.log_t) * w[2]).sum())
        grads = torch.autograd.grad(loss, fields)
        if dev.type == "cuda":
            assert gsl.LAUNCHES["pregathered_fwd"] == \
                before["pregathered_fwd"] + 1
            assert gsl.LAUNCHES["pregathered_bwd"] == \
                before["pregathered_bwd"] + 1
            geom, rgbd = pb.gather_windows(bins.tile_gid[lo:hi], *(
                f.detach() for f in fields))
            counts = bins.tile_mask[lo:hi].sum(1, dtype=torch.int32)
            acc_p, logt_p, _ = pb.pregathered_blend_fwd_plain(
                counts, geom, rgbd, 6, 16, min(chunk, geom.shape[2]),
                tile0=lo)
            torch.testing.assert_close(out.color.detach(),
                                       acc_p[:, :3].transpose(1, 2),
                                       atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(torch.exp(out.log_t.detach()),
                                       torch.exp(logt_p[..., 0]), atol=1e-5,
                                       rtol=1e-5)
        outs.append(([x.detach().cpu() for x in out], [
            x.cpu() for x in grads]))
    (img_k, gr_k), (img_p, gr_p) = outs
    torch.testing.assert_close(img_k[0], img_p[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(img_k[1], img_p[1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(torch.exp(img_k[2]), torch.exp(img_p[2]),
                               atol=1e-5, rtol=1e-5)
    for name, a, b in zip(("means2d", "conic", "rgb", "opacity", "depths"),
                          gr_k, gr_p):
        scale = float(b.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(a / scale, b / scale, atol=5e-3,
                                   rtol=1e-2, msg=name)


def test_stream_training_is_bit_reproducible(case):
    """Twenty stream ``train_step``s (K1/K2 and the slot-order pack
    gradient, no atomics) run twice from one state give bit-equal
    parameters and Adam moments."""
    cfg = case["cfg"]
    g, cam = _on(case["arrays"], case["device"])
    rng = np.random.default_rng(5)
    views = []
    with torch.no_grad():
        for _ in range(4):
            c = cam.with_delta(torch.tensor(
                0.02 * rng.standard_normal(6), dtype=torch.float32,
                device=case["device"]))
            gt = rasterize(g, c, cfg)
            views.append((c, gt.color, gt.depth))
    mcfg = mtrain.MapTrainConfig()

    def run():
        state = mtrain.init_training(g, mcfg)
        for k in range(20):
            c, im, dp = views[k % len(views)]
            state, _ = mtrain.train_step(state, c, im, mcfg, cfg,
                                         gt_depth=dp)
        return state

    a, b = run(), run()
    for name in TRAINED:
        assert torch.equal(getattr(a.gaussians, name),
                           getattr(b.gaussians, name)), name
        assert torch.equal(a.opt_state[name].mu, b.opt_state[name].mu), name
    assert not torch.equal(a.gaussians.xyz, g.xyz)


def test_one_rank_nccl_group_matches_unsharded(case, tmp_path):
    """A world-size-1 NCCL group on the card: ``dp_train_grads`` over 2
    cameras and ``rasterize_tile_sharded`` against the unsharded port (the
    collectives run; one rank's mean is the mean)."""
    import torch.distributed as dist
    from gs_localization_torch.mapping import losses
    from gs_localization_torch.parallel import dp, runtime
    from gs_localization_torch.parallel.tile_shard import (
        rasterize_tile_sharded)

    cfg = case["pre"]
    g, cam = _on(case["arrays"], case["device"])
    dist.init_process_group("nccl",
                            init_method=runtime.local_rendezvous(tmp_path),
                            world_size=1, rank=0)
    try:
        mesh = runtime.global_mesh(("data",))
        assert mesh.group("data") is not None
        cams = [cam, cam.with_delta(torch.tensor(
            [0.01, 0.0, -0.01, 0.02, 0.0, 0.01], device=case["device"]))]
        imgs = torch.rand((2, 64, 96, 3), generator=torch.Generator()
                          .manual_seed(0)).to(case["device"])
        loss, grads = dp.dp_train_grads(mesh, g, cams, imgs, cfg)
        ref_l, ref_g = [], []
        for c, im in zip(cams, imgs):
            p = {k: getattr(g, k).detach().requires_grad_() for k in TRAINED}
            out = rasterize(g.replace(**p), c, cfg)
            loss_i = losses.training_loss(out.color, im)[0]
            ref_l.append(loss_i.detach())
            ref_g.append(torch.autograd.grad(loss_i, [p[k] for k in TRAINED]))
        assert float(loss) == pytest.approx(float(sum(ref_l) / 2), rel=1e-6)
        for i, name in enumerate(TRAINED):
            torch.testing.assert_close(grads[name],
                                       (ref_g[0][i] + ref_g[1][i]) / 2,
                                       atol=1e-6, rtol=1e-5, msg=name)
        tmesh = runtime.global_mesh(("tile",))
        out_s = rasterize_tile_sharded(tmesh, g, cam, cfg)
        with torch.no_grad():
            out_r = rasterize(g, cam, cfg)
        torch.testing.assert_close(out_s.color, out_r.color, atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(out_s.depth, out_r.depth, atol=1e-4,
                                   rtol=0)
    finally:
        runtime.shutdown_runtime()


# ---------------------------------------------------------------------------
# binning: the two segment-expansion kernels (csrc/binning.cu)
# ---------------------------------------------------------------------------

BIN_FIELDS = {
    "stream": ("order", "rank_of_pos", "gid_of_pos", "pos_by_slot",
               "slow_starts", "tstart", "walk_counts", "tile_counts", "kept",
               "kept_al", "num_rendered", "overflow", "tile_overflow",
               "max_tile_count"),
    "ids": ("tile_gid", "tile_mask", "tile_counts", "num_rendered",
            "overflow", "tile_overflow", "max_tile_count"),
}
# name -> (scene, width x height, RasterizerConfig fields)
BIN_CASES = {
    "bench_640x480_sh3": ("bench3", (640, 480, 585.0),
                          dict(max_pairs=1 << 21, max_render=1 << 21)),
    "bench_1024x576_sh1": ("bench1", (1024, 576, 893.25),
                           dict(max_pairs=1 << 21, max_render=1 << 21)),
    "slow_heavy": ("slow_heavy", (64, 48, None),
                   dict(max_pairs=1 << 15, max_render=1 << 15, fast_k=1,
                        pallas_chunk=32, max_per_tile=256)),
    "truncation": ("slow_heavy", (64, 48, None),
                   dict(max_pairs=1 << 15, max_render=64, fast_k=1,
                        pallas_chunk=32, max_per_tile=256)),
    "pool_overflow": ("slow_heavy", (64, 48, None),
                      dict(max_pairs=16, max_render=1 << 15, fast_k=1,
                           pallas_chunk=32, max_per_tile=256)),
    "empty_tiles": ("sparse", (96, 64, None),
                    dict(max_pairs=1 << 14, max_render=1 << 14, fast_k=1,
                         pallas_chunk=128, max_per_tile=128)),
}


def _bin_scene(name: str) -> dict:
    """numpy Gaussians: the bench map (chip_smoke.py's recipe, 100,000
    Gaussians) at SH 3 or 1, a slow-path-heavy scene of wide splats, or a
    sparse one that leaves tiles empty."""
    if name.startswith("bench"):
        deg = int(name[-1])
        rng = np.random.default_rng(0)
        n = 100_000
        xyz = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2.0, 2.0, n),
                        rng.uniform(2.0, 9.0, n)], 1)
        fdc = sh_lib.rgb_to_sh_dc(rng.uniform(0.05, 0.95, (n, 3)))[:, None]
        frest = 0.05 * rng.standard_normal((n, sh_lib.num_sh_coeffs(deg) - 1,
                                            3))
        return {"xyz": xyz, "features_dc": fdc, "features_rest": frest,
                "scaling": rng.uniform(-4.5, -3.0, (n, 3)),
                "rotation": np.tile([[1.0, 0, 0, 0]], (n, 1)),
                "opacity": rng.uniform(-1.0, 2.5, (n, 1)),
                "live": np.ones(n, bool), "deg": deg}
    if name == "slow_heavy":
        arrays = _scene(3, 120, 1.0)
        arrays["scaling"] = np.random.default_rng(3).uniform(-2.5, -1.2,
                                                             (120, 3))
    else:
        arrays = _scene(4, 40, 0.5)
    return {**arrays, "deg": 2}


def _bin_prep(case: str, device):
    """The case's preprocessed map (computed on the CPU, so that both
    devices bin the same floats), its grid and its config."""
    from gs_localization_torch.raster.preprocess import Preprocessed, preprocess

    scene, (w, h, fx), fields = BIN_CASES[case]
    arrays = _bin_scene(scene)
    deg = arrays.pop("deg")
    g = GaussianParams.from_numpy(arrays, deg, deg, device="cpu")
    fx = fx or w / (2.0 * np.tan(0.5))
    cam = Camera.from_rt(np.eye(3), np.zeros(3), fx, fx, w, h, device="cpu")
    with torch.no_grad():
        prep = preprocess(g, cam)
    cfg = RasterizerConfig(**fields)
    return (prep, Preprocessed(*(x.to(device) for x in prep)), cam, cfg)


@pytest.mark.parametrize("name", list(BIN_CASES))
def test_binning_cuda_matches_cpu(cuda_device, name):
    """``bin_stream`` and ``bin_gaussians`` on the card (the two binning
    kernels) equal the CPU path (scatter-max and ``cummax``) in every
    integer of every field."""
    from gs_localization_torch.raster.rasterize import (bin_gaussians_for,
                                                        bin_stream_for)

    prep_cpu, prep_k, cam, cfg = _bin_prep(name, cuda_device)
    for layout, fn in (("stream", bin_stream_for), ("ids", bin_gaussians_for)):
        k, p = fn(prep_k, cam, cfg), fn(prep_cpu, cam, cfg)
        for field in BIN_FIELDS[layout]:
            a, b = getattr(k, field), getattr(p, field)
            assert a.is_cuda and a.dtype == b.dtype, (layout, field)
            assert torch.equal(a.cpu(), b), (layout, field)
    sb_cpu = bin_stream_for(prep_cpu, cam, cfg)
    if name == "truncation":
        assert bool(sb_cpu.tile_overflow) and int(sb_cpu.kept) == 64
    if name == "pool_overflow":
        assert bool(sb_cpu.overflow)
    if name == "empty_tiles":
        assert (sb_cpu.tile_counts == 0).any()
    if name == "slow_heavy":
        assert int(sb_cpu.slow_starts[-1]) > int(sb_cpu.kept) // 2


@pytest.mark.parametrize("name", list(EXPANSION_CASES))
def test_binning_kernels_match_plain_at_edges(cuda_device, name):
    """The kernels behind ``slot_owner`` and ``place_stream`` against their
    plain versions at ``binning_cases``' edges: zero-length segments,
    starts past the pool, tiles clamped to mr - 1, kept < mr, ap >= mr_al,
    mr = 0."""
    c = expansion_case(name)
    starts = torch.from_numpy(c["starts"])
    np.testing.assert_array_equal(
        binning.slot_owner_cuda(starts.to(cuda_device), c["p"],
                                c["max_pairs"]).cpu().numpy(),
        binning.slot_owner_plain(starts, c["p"], c["max_pairs"]).numpy())
    names = ("keys_sorted", "slot_of_pos", "order", "tstart_pos",
             "astart_all", "kept")
    args = [torch.from_numpy(np.asarray(c[k])) for k in names]
    tail = (c["mr"], c["mr_al"], c["rank_size"])
    got = binning.place_stream_cuda(*(a.to(cuda_device) for a in args), *tail)
    for g, w in zip(got, binning.place_stream_plain(*args, *tail)):
        assert torch.equal(g.cpu(), w)


def test_bin_stream_waits_for_nothing(cuda_device):
    """``bin_stream`` and ``bin_gaussians`` on the card make no
    synchronising call (no mask index, no read to the host)."""
    from gs_localization_torch.raster.rasterize import (bin_gaussians_for,
                                                        bin_stream_for)

    _, prep, cam, cfg = _bin_prep("bench_640x480_sh3", cuda_device)
    bin_stream_for(prep, cam, cfg)          # build and load the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bin_stream_for(prep, cam, cfg)
        bin_gaussians_for(prep, cam, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_binning_launch_counts(cuda_device):
    """Each ``bin_stream`` launches both binning kernels once, each
    ``bin_gaussians`` the owner kernel once, and nothing else."""
    from gs_localization_torch.raster.rasterize import (bin_gaussians_for,
                                                        bin_stream_for)

    _, prep, cam, cfg = _bin_prep("slow_heavy", cuda_device)
    before = dict(gsl.LAUNCHES)
    for _ in range(3):
        bin_stream_for(prep, cam, cfg)
    bin_gaussians_for(prep, cam, cfg)
    delta = {k: gsl.LAUNCHES[k] - before[k] for k in before}
    assert delta == {"stream_fwd": 0, "stream_bwd": 0, "pregathered_fwd": 0,
                     "pregathered_bwd": 0, "bin_owner": 4, "bin_place": 3}
