#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gs_localization_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the environment (torch, CUDA, the card's name and power limit);
2. builds the hand-written CUDA kernels from ``gs_localization_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the same inputs:
   at the bench scene (640x480, 100k Gaussians at SH degree 3, fast_k=1,
   chunk 256, max_pairs = max_render = 2^19) and at a small scene whose
   tiles are all single-chunk, one of them empty;
4. checks the CUDA path against the plain CPU path on the small scene
   (images and the camera-tangent gradient);
5. drives the main path: 4 perturbed queries through ``localize_queries``
   in pose mode (50 iterations, lr 1e-3, rebin every 10), with the launch
   counters set to 0 just before and read just after, and requires every
   query's final pose error below its initial one;
6. times each kernel at the bench shapes (median of 25 runs, CUDA events)
   beside its plain version and its bound (this run's walked work over the
   H100's fp32 and HBM peaks);
7. splits a refinement iteration into the rebin and the render, loss and
   backward, and profiles one 20-iteration refinement (torch.profiler: the
   device's busy share and the device time by kernel).

Prints one JSON line of kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Exits non-zero at once when there is no CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

W, H = 640, 480
N_GAUSS = 100_000
MAX_PAIRS = 1 << 19
MAX_RENDER = 1 << 19
CHUNK = 256
N_QUERIES = 4
N_ITERS = 50
N_TIMED = 25

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_FP32 = 67e12     # FLOP/s on the CUDA cores
PEAK_HBM = 3.35e12    # bytes/s
# float operations per (pixel, pair), read off csrc/stream_blend.cu, with
# exp and log counted as one operation each and compares not counted:
# gate_of() on every walked slot (2 sub, 6 mul, 1 add, 1 mul, 1 sub, 1 min,
# 1 exp, 1 mul); then, where the pair passes the gate, the forward's blend
# (min, sub, log, add, exp, mul, 4 fma, add) and the backward's adjoint
# (alpha, log, log T, exp, w, 4 fma for wbar, labar, abar, dpow, dopa, the
# five geometry terms, 4 colour terms, the suffix fma). The warp reductions
# of the backward are not counted, so the bound is a lower bound.
OPS_GATE = 14
OPS_FWD_IN = 15
OPS_BWD_IN = 46

# K1 vs plain: sums in another order (sequential vs cumsum) and the same
# expf; K2 vs plain: analytic reverse walk vs autograd of the forward, with
# log T rebuilt by subtraction.
TOL_FWD = (1e-4, 1e-4)    # accum (atol, rtol)
TOL_LOGT = 1e-4           # log_t atol, on pixels no pair flips (below)
EPS_BAND = 1e-4           # log T this close to LOG_T_EPS may flip a pair
TOL_BWD = (5e-3, 1e-2)
TOL_IMG = 1e-5            # CUDA vs CPU images, small scene
TOL_GRAD = (1e-3, 1e-3)   # camera-tangent gradient (atol, rtol)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_scene(device):
    """bench.py's synthetic scene, recipe copied (numpy default_rng(0))."""
    from gs_localization_torch.core import sh as sh_lib
    from gs_localization_torch.core.gaussians import GaussianParams

    rng = np.random.default_rng(0)
    n = N_GAUSS
    xyz = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2.0, 2.0, n),
                    rng.uniform(2.0, 9.0, n)], 1).astype(np.float32)
    k = sh_lib.num_sh_coeffs(3)
    return GaussianParams.from_arrays(
        xyz=xyz,
        features_dc=sh_lib.rgb_to_sh_dc(
            rng.uniform(0.05, 0.95, (n, 3))).astype(np.float32)[:, None, :],
        features_rest=0.05 * rng.standard_normal((n, k - 1, 3)).astype(
            np.float32),
        scaling=rng.uniform(-4.5, -3.0, (n, 3)).astype(np.float32),
        rotation=np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
        opacity=rng.uniform(-1.0, 2.5, (n, 1)).astype(np.float32),
        sh_degree=3, device=device)


def small_scene(device):
    """200 Gaussians on 96x64: every tile single-chunk, the top-left tile
    empty."""
    from gs_localization_torch.core import sh as sh_lib
    from gs_localization_torch.core.gaussians import GaussianParams

    rng = np.random.default_rng(1)
    n = 200
    xyz = np.stack([rng.uniform(-0.2, 1.2, n), rng.uniform(-0.2, 0.8, n),
                    rng.uniform(2.5, 6.0, n)], 1).astype(np.float32)
    k = sh_lib.num_sh_coeffs(1)
    rot = rng.standard_normal((n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return GaussianParams.from_arrays(
        xyz=xyz,
        features_dc=sh_lib.rgb_to_sh_dc(
            rng.uniform(0.05, 0.95, (n, 3))).astype(np.float32)[:, None, :],
        features_rest=0.1 * rng.standard_normal((n, k - 1, 3)).astype(
            np.float32),
        scaling=rng.uniform(-3.5, -2.5, (n, 3)).astype(np.float32),
        rotation=rot,
        opacity=rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32),
        sh_degree=1, device=device)


def close_err(a, b, atol: float, rtol: float):
    """(max |a-b|, max |a-b| / (atol + rtol |b|)): within tolerance iff the
    second is <= 1."""
    import torch

    d = torch.abs(a.double() - b.double())
    return float(d.max()), float((d / (atol + rtol * b.double().abs())).max())


def compare_kernels(label, stream_t, pack, grid_x, seed):
    """K1 and K2 against their plain versions on one stream; returns the max
    abs errors and the walked work."""
    import torch
    from gs_localization_torch.raster import stream_blend as sb
    from gs_localization_torch.raster.constants import LOG_T_EPS

    args = (stream_t, pack.tstart, pack.walk_counts)
    acc_k, logt_k, resid_k = sb.stream_blend_fwd_cuda(*args, grid_x, 16, CHUNK)
    acc_p, logt_p, resid_p = sb.stream_blend_fwd_plain(*args, grid_x, 16,
                                                       CHUNK)
    torch.cuda.synchronize()
    # A pair whose inclusive log T lies within rounding of LOG_T_EPS is
    # applied by one summation order (sequential) and not by the other
    # (cumsum). That moves the pixel's log T by the pair's log(1 - alpha),
    # its T by at most 1e-4 * alpha and its accum by at most 1e-4 * alpha *
    # |rgbd|. Such "flipped" pixels (one of the two log T within EPS_BAND of
    # LOG_T_EPS) are counted and held to those bounds; every other pixel is
    # held to TOL_LOGT and TOL_FWD.
    d_lt = (logt_k - logt_p).abs()[..., 0]                  # (T, 256)
    near = torch.minimum((logt_k - LOG_T_EPS).abs(),
                         (logt_p - LOG_T_EPS).abs())[..., 0] <= EPS_BAND
    flip = near & (d_lt > TOL_LOGT)
    n_flip = int(flip.sum())
    e_lt = float(torch.where(flip, 0.0, d_lt).max())
    d_t = (torch.exp(logt_k) - torch.exp(logt_p)).abs()[..., 0]
    e_t_flip = float(torch.where(flip, d_t, 0.0).max())
    d_acc = torch.abs(acc_k.double() - acc_p.double())
    lim_acc = TOL_FWD[0] + TOL_FWD[1] * acc_p.double().abs()
    n_acc = float(torch.where(flip[:, None, :], 0.0, d_acc / lim_acc).max())
    rgbd_max = float(stream_t[8:12].abs().max())
    e_acc_flip = float(torch.where(flip[:, None, :], d_acc, 0.0).max())
    e_acc = float(d_acc.max())
    kstop_k, kstop_p = resid_k[:, 0, 1], resid_p[:, 0, 1]
    k_diff = int((kstop_k != kstop_p).sum())
    print(f"[{label}] K1 vs plain: accum max|d| {e_acc:.3e} (tol atol "
          f"{TOL_FWD[0]} rtol {TOL_FWD[1]}, max normalized {n_acc:.3f}); "
          f"log_t max|d| {e_lt:.3e} (tol atol {TOL_LOGT}) on all but "
          f"{n_flip} flipped pixels, whose T max|d| {e_t_flip:.3e} (tol "
          f"1e-4) and accum max|d| {e_acc_flip:.3e} (tol "
          f"{1e-4 * rgbd_max:.3e}); k_stop differs on {k_diff} tiles")
    check(n_acc <= 1 and e_lt <= TOL_LOGT and e_t_flip <= 1e-4
          and e_acc_flip <= 1e-4 * rgbd_max and k_diff == 0,
          f"[{label}] K1 disagrees with its plain version")
    e_fwd = max(e_acc, float(d_lt.max()))     # flipped pixels included

    # cotangents as a loss on the images gives them: random on accum, and
    # on log_t through T = exp(log_t)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    num_tiles = pack.tstart.shape[0]
    gacc = torch.randn((num_tiles, 4, 256), generator=gen).cuda()
    glogt = torch.randn((num_tiles, 256, 1), generator=gen).cuda() \
        * torch.exp(logt_k)
    d_k = sb.stream_blend_bwd_cuda(*args, gacc, glogt, resid_k, grid_x, 16,
                                   CHUNK)
    d_p = sb.stream_blend_bwd_plain(*args, gacc, glogt, grid_x, 16, CHUNK)
    torch.cuda.synchronize()
    e_d, n_d = close_err(d_k, d_p, *TOL_BWD)
    print(f"[{label}] K2 vs plain: dstream max|d| {e_d:.3e} (tol atol "
          f"{TOL_BWD[0]} rtol {TOL_BWD[1]}, max normalized {n_d:.3f})")
    check(n_d <= 1, f"[{label}] K2 disagrees with its plain version")
    check(bool(torch.isfinite(d_k).all()), f"[{label}] K2 not finite")
    return e_fwd, e_d, (gacc, glogt, resid_k)


def walked_work(stream_t, pack, resid, grid_x: int):
    """What this run's data makes the kernels do: walked chunks, walked pair
    slots, (pixel, pair) products that pass the gate, and the bytes each
    kernel must move (each input read once, each output written once)."""
    import torch
    from gs_localization_torch.raster import stream_blend as sb

    num_tiles = pack.tstart.shape[0]
    k_stop = resid[:, 0, 1].long()
    start, count = sb._window(pack.tstart, pack.walk_counts,
                              stream_t.shape[1], CHUNK)
    walked = torch.minimum(count, k_stop * CHUNK)
    tiles = torch.arange(num_tiles, device=stream_t.device)
    lanes = torch.arange(CHUNK, device=stream_t.device)
    gated = 0
    with torch.no_grad():
        for lo, hi in sb._blocks(num_tiles, 256, CHUNK):
            win, _ = sb._gather_windows(stream_t, start[lo:hi],
                                        walked[lo:hi], CHUNK)
            px, py = sb._pixel_coords(tiles[lo:hi], grid_x, 16)
            for k in range(win.shape[2] // CHUNK):
                lane_ok = (k * CHUNK + lanes)[None, :] < walked[lo:hi, None]
                alpha = sb._chunk_alpha(win[:, :, k * CHUNK:(k + 1) * CHUNK],
                                        px, py, lane_ok)
                gated += int((alpha > 0).sum())
    chunks = int(k_stop.sum())
    slots = int(walked.sum())
    stream_read = slots * 12 * 4
    tile_io = num_tiles * 256 * 7 * 4          # accum + log_t + resid
    fwd_bytes = stream_read + num_tiles * 8 + tile_io
    bwd_bytes = stream_read + num_tiles * 8 + tile_io \
        + 16 * stream_t.shape[1] * 4
    return dict(chunks=chunks, slots=slots, gated=gated,
                fwd_ops=slots * 256 * OPS_GATE + gated * OPS_FWD_IN,
                bwd_ops=slots * 256 * OPS_GATE + gated * OPS_BWD_IN,
                fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes)


def time_ms(fn, n: int = N_TIMED) -> float:
    """Median over n runs of one call, CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def profile_refine(refine) -> None:
    """One refinement under torch.profiler: the device's busy share of the
    wall time and the device time by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    refine()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iters = refine().num_iters
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print("profile: the profiler saw no device activity; device busy "
              "share not measured")
        return
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.end - e.time_range.start,
                               n + 1)
    print(f"profile ({iters} iterations, under the profiler): wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}%), {len(spans)} device activities")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"profile:   {us / 1e3:9.3f} ms {n:6d}x  {name[:90]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import gs_localization_torch as gsl
    from gs_localization_torch import _kernels
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.loc import (
        TrackingConfig, refine_pose, tracking_loss)
    from gs_localization_torch.pipelines.localize import (
        LocalizePipelineConfig, QuerySpec, localize_queries)
    from gs_localization_torch.raster import RasterizerConfig, rasterize
    from gs_localization_torch.raster import stream_blend as sb
    from gs_localization_torch.raster.pose_mode import (
        _project_stream, build_stream_pair_pack, render_pose_mode)
    from gs_localization_torch.sfm.evaluate import pose_errors

    t_start = time.perf_counter()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {kind}")
    print(f"nvidia-smi: {smi}")

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({'cached' if built is None else 'nvcc'})")

    cfg = RasterizerConfig(max_pairs=MAX_PAIRS, max_per_tile=1024,
                           max_render=MAX_RENDER, fast_k=1,
                           pallas_chunk=CHUNK)
    dev = torch.device("cuda")

    # ---- kernels vs plain, bench scene ---------------------------------
    g = bench_scene(dev)
    cam = Camera.from_rt(np.eye(3), np.zeros(3), 520.0, 520.0, W, H,
                         device=dev)
    grid_x = -(-W // 16)
    pack = build_stream_pair_pack(g, cam, cfg)
    check(not bool(pack.overflow), "bench pack overflow")
    with torch.no_grad():
        stream_t = _project_stream(pack.params, cam)
    print(f"bench stream: {tuple(stream_t.shape)}, kept_al "
          f"{int(pack.kept_al)}, tiles {pack.tstart.shape[0]}, max walk "
          f"{int(pack.walk_counts.max())}")
    err_fwd, err_bwd, (gacc, glogt, resid) = compare_kernels(
        "bench", stream_t, pack, grid_x, seed=0)

    # ---- kernels vs plain, small single-chunk scene --------------------
    gs = small_scene(dev)
    cam_s = Camera.from_rt(np.eye(3), np.zeros(3), 60.0, 60.0, 96, 64,
                           device=dev)
    cfg_s = cfg.replace(max_pairs=1 << 14, max_render=1 << 14)
    pack_s = build_stream_pair_pack(gs, cam_s, cfg_s)
    counts_s = pack_s.walk_counts
    print(f"small stream: max walk {int(counts_s.max())}, empty tiles "
          f"{int((counts_s == 0).sum())}")
    check(int(counts_s.max()) <= CHUNK and int((counts_s == 0).sum()) > 0,
          "small scene is not single-chunk with an empty tile")
    with torch.no_grad():
        stream_s = _project_stream(pack_s.params, cam_s)
    e1, e2, _ = compare_kernels("small", stream_s, pack_s, -(-96 // 16),
                                seed=1)
    err_fwd, err_bwd = max(err_fwd, e1), max(err_bwd, e2)

    # ---- CUDA path vs CPU path, small scene -----------------------------
    gs_cpu = gs.replace(**{f: getattr(gs, f).cpu() for f in
                           ("xyz", "features_dc", "features_rest", "scaling",
                            "rotation", "opacity", "live")})
    cam_cpu = cam_s.replace(w2c=cam_s.w2c.cpu(), fx=cam_s.fx.cpu(),
                            fy=cam_s.fy.cpu(), cx=cam_s.cx.cpu(),
                            cy=cam_s.cy.cpu())
    grads = []
    for gg, cc in ((gs, cam_s), (gs_cpu, cam_cpu)):
        pk = build_stream_pair_pack(gg, cc, cfg_s)
        tau = torch.zeros(6, device=cc.device, requires_grad=True)
        c, d, a = render_pose_mode(pk, cc.with_delta(tau), cfg_s)
        (c.sum() + 0.1 * d.sum() + 0.01 * a.sum()).backward()
        grads.append((c.detach().cpu(), d.detach().cpu(), a.detach().cpu(),
                      tau.grad.cpu()))
    (c1, d1, a1, t1), (c2, d2, a2, t2) = grads
    img_err = max(float((c1 - c2).abs().max()), float((d1 - d2).abs().max()),
                  float((a1 - a2).abs().max()))
    _, n_grad = close_err(t1, t2, *TOL_GRAD)
    print(f"small scene CUDA vs CPU: images max|d| {img_err:.3e} (tol "
          f"{TOL_IMG}); tangent grad max normalized {n_grad:.3f}")
    check(img_err <= TOL_IMG and n_grad <= 1,
          "CUDA path disagrees with the CPU path")
    check(all(bool(torch.isfinite(x).all()) for x in (c1, d1, a1, t1)),
          "non-finite render")

    # ---- main path: localize 4 perturbed queries ------------------------
    with torch.no_grad():
        gt = rasterize(g, cam, cfg)
    gt_img = gt.color.cpu().numpy()
    gt_dep = gt.depth.cpu().numpy()
    check(gt_img.shape == (H, W, 3) and np.isfinite(gt_img).all(),
          "bad ground-truth render")
    rng = np.random.default_rng(7)
    gt_w2c = cam.w2c.cpu().numpy()
    queries, init = [], []
    for q in range(N_QUERIES):
        tau = rng.uniform(0.01, 0.02, 6) * rng.choice([-1.0, 1.0], 6)
        cam_q = cam.with_delta(torch.tensor(tau, dtype=torch.float32,
                                            device=dev))
        w = cam_q.w2c.cpu().numpy()
        init.append(pose_errors(w[:3, :3], w[:3, 3], gt_w2c[:3, :3],
                                gt_w2c[:3, 3]))
        queries.append(QuerySpec(name=f"q{q}", camera=cam_q, image=gt_img,
                                 depth=gt_dep, gt_w2c=gt_w2c))
    # convergence=0: every query runs all N_ITERS iterations, so the launch
    # counts must equal N_QUERIES * N_ITERS exactly
    tcfg = TrackingConfig(num_iters=N_ITERS, lr=1e-3, rebin_every=10,
                          pose_mode=True, convergence=0.0)
    pcfg = LocalizePipelineConfig(batch_size=N_QUERIES, tracking=tcfg)
    logs = []
    torch.cuda.synchronize()
    gsl.reset_launches()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    results, metrics = localize_queries(g, queries, pcfg, cfg,
                                        log_fn=logs.append)
    ev1.record()
    ev1.synchronize()
    launches = dict(gsl.LAUNCHES)
    iters = N_QUERIES * N_ITERS
    ms_iter = ev0.elapsed_time(ev1) / iters
    for line in logs:
        print(f"localize: {line}")
    for q, (e0t, e0r) in zip(queries, init):
        w = results[q.name]
        check(np.isfinite(w).all(), f"{q.name}: non-finite pose")
        e1t, e1r = pose_errors(w[:3, :3], w[:3, 3], gt_w2c[:3, :3],
                               gt_w2c[:3, 3])
        print(f"{q.name}: trans {e0t * 100:.3f} -> {e1t * 100:.3f} cm, "
              f"rot {e0r:.4f} -> {e1r:.4f} deg")
        check(e1t < e0t and e1r < e0r, f"{q.name}: error did not decrease")
    print(f"refinement: {iters} iterations, {ms_iter:.3f} ms/iteration "
          f"(CUDA events around localize_queries); metrics {metrics}")
    print(f"main-path launches: {launches}")
    check(launches["stream_fwd"] == iters and launches["stream_bwd"] == iters,
          f"launch counts {launches} != {iters} iterations")

    # ---- timing at the bench shapes --------------------------------------
    args = (stream_t, pack.tstart, pack.walk_counts)
    k1_ms = time_ms(lambda: sb.stream_blend_fwd_cuda(*args, grid_x, 16, CHUNK))
    k1p_ms = time_ms(lambda: sb.stream_blend_fwd_plain(*args, grid_x, 16,
                                                       CHUNK))
    k2_ms = time_ms(lambda: sb.stream_blend_bwd_cuda(
        *args, gacc, glogt, resid, grid_x, 16, CHUNK))
    k2p_ms = time_ms(lambda: sb.stream_blend_bwd_plain(
        *args, gacc, glogt, grid_x, 16, CHUNK))
    work = walked_work(stream_t, pack, resid, grid_x)
    print(f"walked: {work['chunks']} chunks, {work['slots']} pair slots x "
          f"256 pixels, {work['gated']} (pixel, pair) products pass the "
          f"gate; K1 {k1_ms:.4f} ms (plain {k1p_ms:.3f}), K2 {k2_ms:.4f} ms "
          f"(plain {k2p_ms:.3f})")

    # ---- where a refinement iteration's time goes ------------------------
    q0 = queries[0]
    img0 = torch.tensor(q0.image, device=dev)
    dep0 = torch.tensor(q0.depth, device=dev)
    mask0 = torch.ones(img0.shape[:2], dtype=torch.bool, device=dev)
    rebin_ms = time_ms(lambda: build_stream_pair_pack(g, q0.camera, cfg), 5)
    pack0 = build_stream_pair_pack(g, q0.camera, cfg)

    def one_step():
        tau = torch.zeros(6, device=dev, requires_grad=True)
        ab = torch.zeros(2, device=dev, requires_grad=True)
        c, d, a = render_pose_mode(pack0, q0.camera.with_delta(tau), cfg)
        loss = tracking_loss(c, d, a, ab, img0, mask0, tcfg, gt_depth=dep0)
        torch.autograd.grad(loss, (tau, ab))

    step_ms = time_ms(one_step, 10)
    print(f"breakdown: rebin (preprocess + bin_stream + gather) "
          f"{rebin_ms:.3f} ms, once per {tcfg.rebin_every} iterations; "
          f"render + loss + backward {step_ms:.3f} ms, of which K1 "
          f"{k1_ms:.3f} and K2 {k2_ms:.3f}")
    profile_refine(lambda: refine_pose(
        g, q0.camera, img0, mask0, tcfg.replace(num_iters=20), cfg,
        gt_depth=dep0))

    def entry(name, replaces, n_launch, err, ms, plain_ms, byts, ops):
        t_bytes, t_ops = byts / PEAK_HBM * 1e3, ops / PEAK_FP32 * 1e3
        return {"name": name, "route": "cuda",
                "source": "gs_localization_torch/csrc/stream_blend.cu",
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None}

    kernels = [
        entry("stream_fwd", "gs_localization_tpu/raster/stream_blend.py:85",
              launches["stream_fwd"], err_fwd, k1_ms, k1p_ms,
              work["fwd_bytes"], work["fwd_ops"]),
        entry("stream_bwd", "gs_localization_tpu/raster/stream_blend.py:161",
              launches["stream_bwd"], err_bwd, k2_ms, k2p_ms,
              work["bwd_bytes"], work["bwd_ops"]),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
