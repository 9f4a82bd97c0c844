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
from gs_localization_torch.raster import pallas_blend as pb
from gs_localization_torch.raster import stream_blend as sb
from gs_localization_torch.raster.constants import LOG_T_EPS
from gs_localization_torch.raster.pose_mode import (
    _project_pairs, _project_stream, build_pair_pack, build_stream_pair_pack,
    render_pose_mode)
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
    bits: the forward's outputs and walks, and the backward's gradients at
    every lane, zeros included."""
    (counts, geom, rgbd), (stream, tstart, wcount) = _edge_inputs(
        chunk, cuda_device)
    gx = EDGE_GRID[0]
    out_s = sb.stream_blend_fwd_cuda(stream, tstart, wcount, gx, 16, chunk)
    out_g = pb.pregathered_blend_fwd_cuda(counts, geom, rgbd, gx, 16, chunk)
    assert _same(out_s, out_g)
    gacc, glogt = _cotangents(out_s[0], out_s[1],
                              torch.ones_like(out_s[1][..., 0]))
    d_s = sb.stream_blend_bwd_cuda(stream, tstart, wcount, gacc, glogt,
                                   out_s[1], out_s[3], gx, 16, chunk)
    dgeom, drgbd = pb.pregathered_blend_bwd_cuda(counts, geom, rgbd, gacc,
                                                 glogt, out_g[1], out_g[3],
                                                 gx, 16, chunk)
    torch.cuda.synchronize()
    num_tiles, _, cap = geom.shape
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
    layout (K3/K4) and on the stream layout (K1/K2 and the gather's
    ``index_add_`` adjoint, whose atomic sums vary in order: tolerances,
    not bits)."""
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


def test_oracle_and_n_touched_cuda_match_cpu(case):
    """render_oracle and rasterize(return_n_touched=True) on the card
    against the CPU. Both are plain PyTorch on either device (no hand
    kernel: the JAX functions are ``lax.scan``s): images to 1e-5; the
    touched-pixel counts equal but for Gaussians whose alpha or T test
    sits within the card's and the CPU's ``exp`` rounding of its threshold
    (at most 1 in 1,000 Gaussians, by at most 2 pixels)."""
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
    d = (n_k.long() - n_p.long()).abs()
    assert int(d.max()) <= 2 and int((d > 0).sum()) <= max(
        1, n_p.numel() // 1000)
