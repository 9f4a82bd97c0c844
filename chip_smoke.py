#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gs_localization_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the environment (torch, CUDA, the card's name and power limit);
2. builds the hand-written CUDA kernels from ``gs_localization_torch/csrc``
   and prints, for each of K1-K4, the CTAs per SM, registers per thread,
   shared memory per CTA and spill bytes that the CUDA runtime reports;
3. holds each kernel against its plain PyTorch version on the same inputs:
   K1/K2 (stream blend) at the bench scene (640x480, 100k Gaussians at SH
   degree 3, fast_k=1, chunk 256, max_pairs = max_render = 2^19) and at a
   small scene whose tiles are all single-chunk, one of them empty; K3/K4
   (pregathered blend) on the same two scenes binned by ``bin_gaussians``
   at ``max_per_tile`` = the probed max tile count rounded up to 256, and
   at the shapes of the paths that run them: the training windows (the
   initial and the trained map at the deepest training view, at the
   training run's ``max_per_tile``) and a PairPack's windows; at both
   training windows also the distance of K4 and of the float32 plain K4
   from the float64 plain K4; and K1/K2 on the bench stream against K3/K4
   on windows cut out of that stream (one body serves both layouts, so the
   same bits are expected); and the binning kernels (``csrc/binning.cu``:
   the slow pool's slot owners and the stream's aligned placement) at the
   bench scene at 640x480 and 1024x576 at the benchmark's capacities
   (2^21 pairs, fast_k 8, align 256: int32 sort keys) and at the
   ``mip360-localize`` cell's map, camera and capacities (3 M Gaussians
   at 1237x822, 2^24 pairs: int64 sort keys), exactly, with
   ``bin_stream``'s whole result on the card against the CPU, timed
   beside their plain versions on the card (the scatter-max and
   ``cummax`` they replaced); and K1/K2 on that cell's stream (about
   2,000 pairs a tile, a partial tile column), timed beside their bounds;
   and pose mode's projection P1 and its adjoint P2
   (``csrc/pose_project.cu``) at the bench stream and that cell's stream
   (about 7.9 M live positions of 17.8 M), at a pose off the pack's: P1
   against ``_project_core`` (the same bits expected), P2 against the
   plain adjoint and itself, timed beside their byte bounds, the plain
   forward and its autograd backward, with their launches and occupancy;
   and the refinement's pose algebra A1/A2, V1/V2 and S1
   (``csrc/pose_algebra.cu``) against their plain versions at the bench
   camera, each timed beside its plain version, and one iteration's pose
   algebra both ways;
4. checks the CUDA path against the plain CPU path on the small scene
   (pose-mode images and the camera-tangent gradient, on the stream pack
   and on the PairPack);
5. localization path: 4 perturbed queries through ``localize_queries`` in
   pose mode on the stream layout (K1/K2; 50 iterations, lr 1e-3, rebin
   every 10), with the launch counters set to 0 just before and read just
   after, and every query's final pose error below its initial one; here
   and on every later refinement path (the PairPack, the scene runner's
   localize stage, all stages, the learned front end, the hloc confs) the
   pose algebra's launches are checked against the path's iterations (A1
   twice an iteration, A2 and S1 once, V1/V2 once on the stream layout)
   and reported under ``binning`` as ``pose algebra launches``;
6. layout cross-check at full width: ``rasterize`` + ``training_loss`` of a
   ``from_pcd`` map on the stream layout (K1/K2) and on the pregathered
   layout (K3/K4): images, losses and the gradients of every trainable
   field and of ``means2d_offset``;
7. training path: ``train_map`` for 300 iterations on ``use_stream=False``
   (K3/K4) from ``from_pcd`` of the bench map's points, on 8 of 10 views
   the bench map renders (colour and depth), 2 held out; densify rounds at
   100, 200 and 300; loss, held-out PSNR, densify reports, the PLY
   snapshot and the exact K3/K4 launch counts are checked;
8. pose mode's PairPack: 2 perturbed queries through ``localize_queries``
   on ``use_stream=False`` (K3/K4), 50 iterations each;
9. times each kernel (the median of 25 single calls, the kernels line's
   ``ms``, and the device time per call over 25 calls back to back, its
   ``device_ms``; CUDA events) beside its plain
   version (median of 5 single calls) and its bound (this run's walked
   work: its bytes over the HBM peak, its instructions over the H100's
   fp32 and special-function issue rates): K1/K2 at the bench shapes,
   K3/K4 at the training windows (and, beside K1/K2, at the bench
   windows), with the card's SM clock read before and after;
10. scene runner: writes a raw 7-Scenes layout at 640x480 under
   ``build/`` (8 training frames in seq-01, 4 test frames in seq-02,
   colour and 16-bit millimetre depth PNGs rendered from the bench map,
   the split files, ``sparse_dslam/0`` with the true poses), stands in for
   the sfm stage (``sfm_points.npz`` with the bench map's means and DC
   colours, ``results_dense.txt`` with the test poses moved by 2.5 cm and
   1 degree) and runs ``gs_localization_torch.pipelines.run_scene.main``
   with ``--preset seven_scenes`` and its defaults (the stream layout):
   prepare (8 / 4 images), train 300 iterations (K1/K2 launched, K3/K4
   not; the logged held-out PSNR above the initial map's; the PLY
   reloads) and localize (4 poses in results.txt, metrics.json, the
   median error falls); before training, K1/K2 through ``blend_stream``
   on the initial map's pack at its first training view against the plain
   versions (``[scene-train] K1/K2 vs plain``); ms per training step on
   both layouts from that map, and ms per localization iteration;
11. n_touched: ``count_touched`` on the card against the CPU at the card
   test's two scenes and the bench scene, and for each Gaussian whose
   count differs the deciding value of each differing pixel decision and
   its margin from the threshold it crossed, in float32 ULPs;
12. few-shot training: ``train_map`` for 300 iterations on the stream
   layout (K1/K2) with a depth estimator (1 / (0.1 + luminance)) on the
   training scene of step 7: 21 pseudo cameras, a pseudo view every 20
   iterations inside (10, 290); the estimator's calls, the exact K1/K2
   launch counts (K1 = iterations + 2 x pseudo steps + held-out renders,
   K2 = iterations + pseudo steps, K3/K4 none), finite pseudo-view losses
   and the held-out PSNR above the initial map's; ms per step with and
   without a pseudo view; one pseudo-term ``train_step`` on the card
   against the CPU (small scene, both layouts); ``train_step_batched`` of
   4 training views against the mean single-view gradient; one viewer
   frame (a JPEG, rendered by K1); and whether the native image loader
   built, with its decodes against PIL;
13. scene runner, all stages: a fresh copy of step 10's layout with no sfm
   files, and one ``run_scene.main`` call ``--stage all --iterations 300``
   with its defaults (Harris, ``--use-depth``, the stream layout): the sfm
   stage builds the point model and the init poses on the card (at least
   one query by PnP), train and localize follow; the launch counts of the
   call are exact (K1 = steps + held-out renders + localize iterations,
   K2 = steps + localize iterations, no K3/K4) and metrics.json is finite;
   from the PLY the card's train stage wrote and the card's
   ``results_dense.txt``, the query whose error rose the most over its
   init is localized again on the CPU (``--stage localize --device cpu``,
   the plain versions): its pose within 1 mm / 0.1 deg of the card's and
   its iterations within ``LOC_ITERS_APART`` of the card's;
   the sfm stage's wall time split into extraction, matching,
   triangulation and PnP; the sfm stage again on the CPU into another
   ``--out``, held against the card (keypoints, points, methods, init
   poses); Harris and SIFT ms per 640x480 image, SIFT card vs CPU on one
   view; ``incremental_mapping`` of the synthetic scene of
   ``tests/test_incremental_sfm.py`` card vs CPU (its bundle
   adjustments at ``MAP_BA_ITERS`` / ``MAP_FINAL_BA_ITERS`` LM steps); ms
   per ``bundle_adjust_np`` call of ``BA_TIMED_ITERS`` LM steps;
14. the learned front end: random-weight checkpoints from a seed at the
   official shapes, names and formats (``superpoint_v1.pth``,
   ``superglue_outdoor.pth`` with its residual branches at 0 and a sharp
   final projection so that pairs match, ``Pitts30K_struct.mat``,
   ``dpt_hybrid-midas-501f0c75.pt``, and ``midas_v21-f6b98070.pt`` in a
   folder of its own), read back through ``weights.load`` on the card and
   on the CPU; each network at full width on the card against the CPU
   (SuperPoint at 640x480 with superpoint_aachen's 4,096 keypoints and NMS
   3, SuperGlue on two 1,024-keypoint sets at sinkhorn 5 and 50, NetVLAD
   at 640x480, DPT_Hybrid's and MiDaS's ``estimate_depth`` at 480x640) and
   its median ms per call; one ``run_scene.main`` call ``--stage all
   --iterations 50 --weights-dir`` on a fresh layout of step 10's views:
   every "weights: ... enabled" line, an init pose and a method for every
   test image, the few-shot branch with one DPT call per pseudo step, the
   exact K1/K2 launches (K1 = steps + 2 x pseudo steps + held-out renders
   + localize iterations, K2 = steps + pseudo steps + localize
   iterations, no K3/K4), a finite metrics.json, the sfm stage's time
   split; then the sfm stage again on the CPU, held against the card
   (keypoints, points, methods, init poses);
15. the rest of hloc's learned confs: checkpoints from a seed at the
   official shapes, names and formats (``write_random``'s superpoint,
   d2net, r2d2, disk, dir, openibl and eigenplaces rows;
   ``superpoint_lightglue.pth`` with its residual branches at 0 and a
   sharp final projection, and ``outdoor_ds.ckpt`` reduced to census
   matching, so that pairs match: ``sharp_lightglue``,
   ``sharp_loftr_params``), read back through ``weights.load`` on the card
   and on the CPU, DIR with a PCA whitening made from a seed; each conf
   through the registry at full width on the card against the CPU and its
   median ms per call (r2d2, d2net-ss and disk at 640x480 with 5,000
   keypoints, lightglue on two 2,048-keypoint superpoint_max sets, loftr
   on two 640x480 views at 512 slots, dir, openibl and eigenplaces at
   640x480); on a fresh layout of step 10's views, ``build_point_model``
   and the localizers with superpoint_max + lightglue + dir (the sparse
   front end) and with loftr + eigenplaces (the dense one), on the card
   and again on the CPU (points within 2 %, the same methods, init poses
   within 5 cm / 1 deg); the sparse front end's ``results_dense.txt`` and
   ``sfm_points.npz`` as the sfm stage writes them, then ``run_scene
   --stage train --iterations 50`` from its points and ``--stage
   localize`` from both front ends' initial poses, with the exact K1/K2
   launches of the three runs (K1 = steps + held-out renders + localize
   iterations, K2 = steps + localize iterations, no K3/K4) and finite
   metrics.json files; the phase's own time;
16. the repaired faults: 20 stream ``train_step``s from the initial map run
   twice from one state give bit-equal parameters (the slot-order pack
   gradient, no atomics), and the pack gradient's reduction beside
   ``index_add_`` on one stream step's grad stream (device ms of each,
   their difference); the scene phase times a stream step with either;
   the float64 yardstick lines at the training windows read K4 after its
   log T records;
17. multi-device (one card), the bench scene at the training phase's
   ``max_per_tile``: a world-size-1 NCCL group runs ``dp_train_grads`` (2
   cameras, stream), ``shard_queries_refine`` (4 queries, 50 iterations,
   pose mode), ``rasterize_tile_sharded`` (images and gradients),
   ``rasterize_gauss_sharded`` and ``gauss_sharded_loss_and_grads``, each
   equal to the unsharded port; ms per refinement iteration per rank and
   per DP step; ``blend_tiles`` on the card at the tile-sharded path's two
   ranks' slices (tile0 = 0 and 600) against K3/K4's plain versions at
   the same tile0, images and the gradients in every blend input; and,
   started once the NCCL timings are taken and run alongside the rest,
   two processes sharing cuda:0 over gloo run ``python -m
   gs_localization_torch.parallel.dryrun`` and (``chip_smoke.py
   --md-rank``) the tile-sharded (30 tile rows over 2 ranks) and
   Gaussian-sharded (100,000 / 2) renders, equal to the unsharded render
   bit for bit; the phase's launches join the kernels line.

Prints one JSON line of kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Exits non-zero at once when there is no CUDA device. ``--md-rank``
(with ``--md-init``, ``--md-out`` and ``--md-max-per-tile``) runs one of
step 17's gloo ranks; run with no arguments, the script needs one card.
Every process group meets through a store file of its own
(``runtime.local_rendezvous``), never a port picked ahead of time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

W, H = 640, 480
N_GAUSS = 100_000
MAX_PAIRS = 1 << 19
MAX_RENDER = 1 << 19
CHUNK = 256
N_QUERIES = 4
N_ITERS = 50
N_TIMED = 25
# single calls of each plain version in the timing phase (40-450 ms each on
# the card and host-bound: 5 give their median, in less of the script's time)
N_PLAIN_TIMED = 5
N_VIEWS, N_TEST_VIEWS = 10, 2
N_TRAIN = 300
N_PAIR_QUERIES = 2
# the scene runner's 7-Scenes layout: frames of seq-01 train, of seq-02 test
N_SCENE_TRAIN, N_SCENE_TEST = 8, 4
SCENE_ITERS = 300
# few-shot training: a pseudo view every FS_INTERVAL iterations strictly
# inside FS_WINDOW, 14 of the N_TRAIN iterations
FS_INTERVAL, FS_WINDOW = 20, (10, 290)
# the learned front end's --stage all run: its train iterations (50 hold 2
# pseudo steps, each with its DPT call)
LEARNED_ITERS = 50
# the hloc confs' sfm runs: the pair window and retrieval depth of
# SfmInitConfig (1 and 1 hold the CPU rerun's LightGlue and LoFTR calls to
# 10 and 13 mapping pairs and one pair a query, and still place all 4
# queries by PnP), and the train iterations
HLOC_WINDOW, HLOC_RETRIEVAL, HLOC_ITERS = 1, 1, 50
# a localize on the card and on the CPU may stop apart by this many
# iterations: the stop tests the norm of Adam's step against the preset's
# convergence (1e-4), a value rounded differently on each device, and each
# step past it moves the pose by less than 1e-4 m and rad, so 2 such steps
# stay well inside the 1 mm / 0.1 deg gate on the poses
LOC_ITERS_APART = 2
# the all-stages phase's incremental mapper (card vs CPU): LM steps of its
# periodic and final bundle adjustments (the mapper's defaults are 10 and
# 25); every image registers, from the same initial pair, to the defaults'
# final cost (602.5 on the CPU) in half their time
MAP_BA_ITERS, MAP_FINAL_BA_ITERS = 5, 12
# LM steps of the one timed bundle_adjust_np call on each device (the
# solver's default is 15); the time per LM step is printed beside it
BA_TIMED_ITERS = 5
# the scene-scale binning and K1/K2 cases: the mip360-localize cell's
# configuration, its map drawn from this seed
SCENE_CONFIG = "gsbench/configs/mip360-rgb.json"
SCENE_SEED = 0

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_FP32 = 67e12     # FLOP/s on the CUDA cores, a fused multiply-add as 2
PEAK_HBM = 3.35e12    # bytes/s
# The blend is not made of multiply-add pairs, so its bound counts issued
# instructions: fp32 ones (fma, mul, add, min alike) at half the FLOP rate,
# and exp, log and reciprocal on the special-function units, which have 16
# lanes per SM to the 128 fp32 lanes. The two pipes run side by side, so
# the bound is the larger of the two times.
FP32_ISSUE = PEAK_FP32 / 2       # fp32 instructions/s
SFU_ISSUE = FP32_ISSUE / 8       # special-function instructions/s
# Instructions per (pixel, pair), read off csrc/blend_common.cuh, as
# (fp32, sfu). Each exp, log and division counts one sfu instruction and
# nothing for its range reduction or refinement, and compares are not
# counted, so the bound is a lower bound. gate_of_pair() runs on every walked
# slot (2 sub, 6 mul, add, mul, sub, min; exp; mul); where the pair passes
# the gate, the forward's blend (min, sub, add, mul, 4 fma, add; log, exp)
# and the backward's adjoint (min, 2 sub, mul, 4 fma, add, 3 for abar, 2
# mul, 14 for the five geometry terms, 4 colour mul, the suffix fma (a
# float64 one, counted as one), and
# the 10 adds that fold the pair's gradients over the pixels; log, exp,
# reciprocal). K1/K2 and K3/K4 share these walks.
INS_GATE = (13, 1)
INS_FWD_IN = (9, 2)
INS_BWD_IN = (43, 3)

# forward kernel vs plain: sums in another order (sequential vs cumsum) and
# the same expf; backward kernel vs plain: analytic reverse walk vs
# autograd of the forward, with log T rebuilt by subtraction.
TOL_FWD = (1e-4, 1e-4)    # accum (atol, rtol)
TOL_LOGT = 1e-4           # log_t atol, on pixels no pair flips (below)
EPS_BAND = 1e-4           # log T this close to LOG_T_EPS may flip a pair
TOL_BWD = (5e-3, 1e-2)
FLIP_BWD = 1e-4           # a flipped pixel's share of its row's gradients
TOL_IMG = 1e-5            # CUDA vs CPU images, small scene
TOL_GRAD = (1e-3, 1e-3)   # camera-tangent gradient (atol, rtol)
# P1 vs _project_core (the same ops in the same order; atol, rtol), P2 vs
# the plain adjoint (float32 terms in another order, both summed in
# float64; atol as a share of the largest gradient, rtol)
TOL_PROJ = (1e-5, 1e-5)
TOL_ADJ = (1e-6, 1e-4)
# the pose of the projection phase: the pack's camera moved by this tangent
PROJ_TAU = (0.01, -0.008, 0.012, 0.02, -0.015, 0.01)
# stream vs pregathered layout on one map: the same pairs in the same order
# per tile; gradients reach the Gaussians through different gather
# adjoints (index_put with atomics, in another order)
TOL_LAYOUT_IMG = 3e-5
TOL_LAYOUT_LOSS = 1e-5    # rtol
TOL_LAYOUT_GRAD = (5e-3, 1e-2)   # on each field divided by its max |grad|
TOL_PLY = 1e-5            # a map reloaded from its PLY renders the same
# K1/K2 vs K3/K4 on the same windows: one forward and one backward body
# serve both layouts, so the same bits are expected
TOL_SAME = 1e-6

ROOT = Path(__file__).resolve().parent
TRAINABLE = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
             "opacity")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}")
    yield
    print(f"== {name}: {time.perf_counter() - t0:.1f} s")


def smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def round_up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


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


def training_views(cam):
    """The training scene's N_VIEWS cameras: ``cam`` and N_VIEWS - 1
    copies moved by 0.03 rad and 0.1 m in seeded random directions."""
    rng_v = np.random.default_rng(11)
    return [cam] + [perturbed(cam, rng_v, 0.03, 0.1)
                    for _ in range(N_VIEWS - 1)]


def initial_map(g, pipe, device):
    """The map train_map starts from: ``from_pcd`` of g's points with its
    DC colours. Returns (points, colors, map)."""
    from gs_localization_torch.core import sh as sh_lib
    from gs_localization_torch.core.gaussians import GaussianParams

    points = g.xyz.cpu().numpy()
    colors = np.clip(sh_lib.sh_dc_to_rgb(
        g.features_dc[:, 0].cpu().numpy()), 0.0, 1.0)
    g0 = GaussianParams.from_pcd(
        points, colors, sh_degree=pipe.sh_degree,
        capacity=max(int(len(points) * pipe.capacity_multiplier), 1024),
        device=device)
    return points, colors, g0


def probe_training(g0, cams):
    """The capacities training needs: a probe of g0 over the training
    cameras, x1.5 headroom. Returns (raster config, max tile count, max
    pairs, index of the camera with the deepest tile)."""
    from gs_localization_torch.raster import RasterizerConfig
    from gs_localization_torch.raster.rasterize import compute_bins

    probe_cfg = RasterizerConfig(max_pairs=1 << 23, max_per_tile=256,
                                 pallas_chunk=CHUNK, use_stream=False)
    mtc, nrend, deep = 0, 0, 0
    for i, c in enumerate(cams):
        b = compute_bins(g0, c, probe_cfg)
        check(not bool(b.overflow), "training probe overflow")
        if int(b.max_tile_count) > mtc:
            mtc, deep = int(b.max_tile_count), i
        nrend = max(nrend, int(b.num_rendered))
    train_cfg = RasterizerConfig(
        max_pairs=round_up(1.5 * nrend, 1024),
        max_per_tile=round_up(1.5 * mtc, 256), pallas_chunk=CHUNK,
        use_stream=False)
    return train_cfg, mtc, nrend, deep


def bench_windows(g, cam, cfg):
    """K3's inputs on the bench scene: bin_gaussians at max_per_tile = the
    probed max tile count rounded up to 256. Returns (bins, geom, rgbd,
    max tile count, pairs emitted)."""
    from gs_localization_torch.raster.rasterize import compute_bins

    probe = compute_bins(g, cam, cfg.replace(use_stream=False,
                                             max_per_tile=4096))
    mtc = int(probe.max_tile_count)
    cfg_pre = cfg.replace(use_stream=False,
                          max_per_tile=max(256, round_up(mtc, 256)))
    bins, geom, rgbd = pregathered_inputs(g, cam, cfg_pre)
    check(not bool(bins.overflow) and not bool(bins.tile_overflow),
          "bench bin_gaussians overflow")
    return bins, geom, rgbd, mtc, int(probe.num_rendered)


def close_err(a, b, atol: float, rtol: float):
    """(max |a-b|, max |a-b| / (atol + rtol |b|)): within tolerance iff the
    second is <= 1."""
    import torch

    d = torch.abs(a.double() - b.double())
    if d.numel() == 0:
        return 0.0, 0.0
    return float(d.max()), float((d / (atol + rtol * b.double().abs())).max())


def flipped(logt_a, logt_b):
    """(T, 256) pixels on which a pair is applied by one of two walks
    only: one log T within EPS_BAND of LOG_T_EPS, and the two apart by more
    than TOL_LOGT."""
    import torch
    from gs_localization_torch.raster.constants import LOG_T_EPS

    a, b = logt_a.double()[..., 0], logt_b.double()[..., 0]
    near = torch.minimum((a - LOG_T_EPS).abs(),
                         (b - LOG_T_EPS).abs()) <= EPS_BAND
    return near & ((a - b).abs() > TOL_LOGT)


def check_forward(label, kname, out_k, out_p, rgbd_max: float) -> float:
    """A forward kernel's (accum, log_t, resid, walk) against its plain
    version's (accum, log_t, resid).

    A pair whose inclusive log T lies within rounding of LOG_T_EPS is
    applied by one summation order (sequential) and not by the other
    (cumsum). That moves the pixel's log T by the pair's log(1 - alpha), its
    T by at most 1e-4 * alpha and its accum by at most 1e-4 * alpha *
    |rgbd|. Such "flipped" pixels (one of the two log T within EPS_BAND of
    LOG_T_EPS) are counted and held to those bounds; every other pixel is
    held to TOL_LOGT and TOL_FWD. A kernel output without ``resid`` (None:
    ``blend_tiles`` returns images only) skips the k_stop comparison.
    Returns the max abs error, flipped pixels included."""
    import torch

    acc_k, logt_k, resid_k = out_k[:3]
    acc_p, logt_p, resid_p = out_p
    torch.cuda.synchronize()
    d_lt = (logt_k - logt_p).abs()[..., 0]                  # (T, 256)
    flip = flipped(logt_k, logt_p)
    n_flip = int(flip.sum())
    e_lt = float(torch.where(flip, 0.0, d_lt).max())
    d_t = (torch.exp(logt_k) - torch.exp(logt_p)).abs()[..., 0]
    e_t_flip = float(torch.where(flip, d_t, 0.0).max())
    d_acc = torch.abs(acc_k.double() - acc_p.double())
    lim_acc = TOL_FWD[0] + TOL_FWD[1] * acc_p.double().abs()
    n_acc = float(torch.where(flip[:, None, :], 0.0, d_acc / lim_acc).max())
    e_acc_flip = float(torch.where(flip[:, None, :], d_acc, 0.0).max())
    e_acc = float(d_acc.max())
    if resid_k is None:
        k_diff, k_note = 0, "k_stop not compared (images only)"
    else:
        k_diff = int((resid_k[:, 0, 1] != resid_p[:, 0, 1]).sum())
        k_note = f"k_stop differs on {k_diff} tiles"
    print(f"[{label}] {kname} vs plain: accum max|d| {e_acc:.3e} (tol atol "
          f"{TOL_FWD[0]} rtol {TOL_FWD[1]}, max normalized {n_acc:.3f}); "
          f"log_t max|d| {e_lt:.3e} (tol atol {TOL_LOGT}) on all but "
          f"{n_flip} flipped pixels, whose T max|d| {e_t_flip:.3e} (tol "
          f"1e-4) and accum max|d| {e_acc_flip:.3e} (tol "
          f"{1e-4 * rgbd_max:.3e}); {k_note}")
    check(n_acc <= 1 and e_lt <= TOL_LOGT and e_t_flip <= 1e-4
          and e_acc_flip <= 1e-4 * rgbd_max and k_diff == 0,
          f"[{label}] {kname} disagrees with its plain version")
    return max(e_acc, float(d_lt.max())), flip


def check_backward(label, kname, bwd, gacc, glogt, flip):
    """A backward kernel against its plain version. ``bwd(gacc, glogt)``
    gives [(kernel, plain), ...], one pair per output.

    A flipped pixel (check_forward) applies a pair at T ~ 1e-4 in one walk
    and not in the other, so its gradient terms differ by about 1e-4 of
    their size. With the flipped pixels' cotangents zeroed, every element
    is held to TOL_BWD; with the full cotangents, to TOL_BWD plus FLIP_BWD
    times the largest |plain| of its row (of its tile, for K4). Returns the
    full cotangents' max abs error and kernel outputs."""
    import torch

    n_flip = int(flip.sum())
    full = bwd(gacc, glogt)
    keep = (~flip).float()
    strict = full if n_flip == 0 else bwd(gacc * keep[:, None, :],
                                          glogt * keep[:, :, None])
    torch.cuda.synchronize()
    errs, n_strict, n_full, worst = [], 0.0, 0.0, ""
    for o, ((k, p), (k0, p0)) in enumerate(zip(full, strict)):
        n_strict = max(n_strict, close_err(k0, p0, *TOL_BWD)[1])
        d = torch.abs(k.double() - p.double())
        pa = p.double().abs()
        rmax = pa.amax(dim=-1, keepdim=True)
        lim = TOL_BWD[0] + TOL_BWD[1] * pa + FLIP_BWD * rmax
        errs.append(float(d.max()))
        n = d / lim
        if float(n.max()) > n_full:
            n_full = float(n.max())
            at = np.unravel_index(int(n.argmax()), tuple(n.shape))
            flips = (f", {int(flip[at[0]].sum())} flipped pixels in tile "
                     f"{at[0]}" if k.dim() == 3 else "")
            worst = (f"; worst with them: output {o} at {tuple(map(int, at))}"
                     f", kernel {float(k[at]):.4e}, plain {float(p[at]):.4e}"
                     f", row max {float(rmax[at[:-1]].squeeze()):.4e}{flips}")
    print(f"[{label}] {kname} vs plain: max|d| "
          f"{', '.join(f'{e:.3e}' for e in errs)} (full cotangents); max "
          f"normalized {n_strict:.3f} with the {n_flip} flipped pixels' "
          f"cotangents zeroed (tol atol {TOL_BWD[0]} rtol {TOL_BWD[1]}), "
          f"{n_full:.3f} with them (+ {FLIP_BWD} x row max){worst}")
    check(n_strict <= 1 and n_full <= 1,
          f"[{label}] {kname} disagrees with its plain version")
    check(all(bool(torch.isfinite(k).all()) for k, _ in full),
          f"[{label}] {kname} not finite")
    return max(errs), [k for k, _ in full]


def cotangents(acc_k, logt_k, seed: int):
    """What a loss on the images gives: random on accum, and on log_t
    through T = exp(log_t)."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    gacc = torch.randn(acc_k.shape, generator=gen).cuda()
    glogt = torch.randn(logt_k.shape, generator=gen).cuda() * torch.exp(logt_k)
    return gacc, glogt


def compare_kernels(label, stream_t, pack, grid_x, seed):
    """K1 and K2 against their plain versions on one stream; returns the max
    abs errors, the cotangents and K1's outputs."""
    from gs_localization_torch.raster import stream_blend as sb

    args = (stream_t, pack.tstart, pack.walk_counts)
    out_k = sb.stream_blend_fwd_cuda(*args, grid_x, 16, CHUNK)
    out_p = sb.stream_blend_fwd_plain(*args, grid_x, 16, CHUNK)
    e_fwd, flip = check_forward(label, "K1", out_k, out_p,
                                float(stream_t[8:12].abs().max()))
    gacc, glogt = cotangents(out_k[0], out_k[1], seed)
    e_d, _ = check_backward(label, "K2 (dstream)", lambda ga, gl: [(
        sb.stream_blend_bwd_cuda(*args, ga, gl, out_k[1], out_k[3], grid_x,
                                 16, CHUNK),
        sb.stream_blend_bwd_plain(*args, ga, gl, grid_x, 16, CHUNK))],
        gacc, glogt, flip)
    return e_fwd, e_d, (gacc, glogt, out_k)


def hold_stream_vs_pregathered(stream_t, pack, grid_x: int, seed: int):
    """K1/K2 on a stream against K3/K4 on windows cut out of it (tile t's
    window: stream lanes from its start, the cap the longest walk rounded
    up to the chunk): the same pairs in the same order through one forward
    and one backward body. The forward's outputs and walks, and K2's sums
    at each tile's walked lanes against K4's, are held to TOL_SAME."""
    import torch
    from gs_localization_torch.raster import pallas_blend as pb
    from gs_localization_torch.raster import stream_blend as sb

    mrpad = stream_t.shape[1]
    start, count = sb._window(pack.tstart, pack.walk_counts, mrpad, CHUNK)
    cap = max(CHUNK, round_up(int(count.max()), CHUNK))
    lanes = torch.arange(cap, device=stream_t.device)
    pos = torch.clamp_max(start[:, None] + lanes, mrpad - 1)     # (T, cap)
    win = stream_t[:12, pos]                                     # (12, T, cap)
    counts = count.to(torch.int32)
    geom = win[:8].transpose(0, 1).contiguous()
    rgbd = win[8:].transpose(0, 1).contiguous()
    args = (stream_t, pack.tstart, pack.walk_counts)
    out_s = sb.stream_blend_fwd_cuda(*args, grid_x, 16, CHUNK)
    out_g = pb.pregathered_blend_fwd_cuda(counts, geom, rgbd, grid_x, 16,
                                          CHUNK)
    gacc, glogt = cotangents(out_s[0], out_s[1], seed)
    d_s = sb.stream_blend_bwd_cuda(*args, gacc, glogt, out_s[1], out_s[3],
                                   grid_x, 16, CHUNK)
    dgeom, drgbd = pb.pregathered_blend_bwd_cuda(
        counts, geom, rgbd, gacc, glogt, out_g[1], out_g[3], grid_x, 16,
        CHUNK)
    torch.cuda.synchronize()
    # K1's log T records sit at each chunk's stream position, K3's at
    # (tile, chunk): held at the chunks each tile walked
    k_stop = out_s[2][:, 0, 1].long()
    chunks = torch.arange(cap // CHUNK, device=stream_t.device)
    rows = torch.clamp_max(start[:, None] // CHUNK + chunks,
                           out_s[3].chunk_logt.shape[0] - 1)     # (T, cap/C)
    at_k = (chunks[None, :] < k_stop[:, None])[..., None]
    rec_s = torch.where(at_k, out_s[3].chunk_logt[rows], 0.0)
    rec_g = torch.where(at_k, out_g[3].chunk_logt, 0.0)
    pairs = list(zip([*out_s[:3], *out_s[3][:2], rec_s],
                     [*out_g[:3], *out_g[3][:2], rec_g]))
    same_fwd = all(torch.equal(a, b) for a, b in pairs)
    e_fwd = max(float((a - b).abs().max()) for a, b in pairs)
    walked = torch.minimum(count, out_s[2][:, 0, 1].long() * CHUNK)
    at = (lanes[None, :] < walked[:, None])[None]                # (1, T, cap)
    d_g = torch.cat([dgeom, drgbd], dim=1).transpose(0, 1)       # (12, T, cap)
    d_w = torch.where(at, d_s[:12, pos], 0.0)
    same_bwd = torch.equal(d_w, torch.where(at, d_g, 0.0))
    e_bwd = float((d_w - torch.where(at, d_g, 0.0)).abs().max())
    print(f"[bench] K1 vs K3 on windows cut from the stream (cap {cap}): "
          f"bitwise {same_fwd}, max|d| {e_fwd:.3e}; K2 vs K4 at the "
          f"{int(walked.sum())} walked lanes: bitwise {same_bwd}, max|d| "
          f"{e_bwd:.3e} (tol {TOL_SAME})")
    check(e_fwd <= TOL_SAME and e_bwd <= TOL_SAME,
          "the stream and pregathered kernels disagree on the same windows")


def pregathered_inputs(g, cam, cfg):
    """The training path's K3 inputs: bin_gaussians at cfg, then the
    packed gather of blend_tiles_pallas."""
    import torch
    from gs_localization_torch.raster.pallas_blend import gather_windows
    from gs_localization_torch.raster.preprocess import preprocess
    from gs_localization_torch.raster.rasterize import bin_gaussians_for

    with torch.no_grad():
        prep = preprocess(g, cam, tile_size=16)
        bins = bin_gaussians_for(prep, cam, cfg)
        geom, rgbd = gather_windows(bins.tile_gid, prep.means2d, prep.conic,
                                    prep.rgb, prep.opacity, prep.depths)
    return bins, geom, rgbd


def yardstick64(label, args, grid_x, chunk, out_k, out_p, gacc, glogt,
                at_most_f32=False):
    """K4 and the float32 plain K4 held against the float64 plain K4, with
    the cotangents zeroed on pixels that a pair flips between any two of K3,
    the float32 and the float64 plain forward: which of the two float32
    walks (the kernel's, or autograd's cumsum) is nearer. With
    ``at_most_f32``, K4 must be no farther than the float32 plain K4."""
    import torch
    from gs_localization_torch.raster import pallas_blend as pb

    f64 = torch.float64
    out_64 = pb.pregathered_blend_fwd_plain(*args, grid_x, 16, chunk,
                                            dtype=f64)
    flip = (flipped(out_k[1], out_p[1]) | flipped(out_k[1], out_64[1])
            | flipped(out_p[1], out_64[1]))
    keep = (~flip).float()
    ga, gl = gacc * keep[:, None, :], glogt * keep[:, :, None]
    d_k = pb.pregathered_blend_bwd_cuda(*args, ga, gl, out_k[1], out_k[3],
                                        grid_x, 16, chunk)
    d_32 = pb.pregathered_blend_bwd_plain(*args, ga, gl, grid_x, 16, chunk)
    d_64 = pb.pregathered_blend_bwd_plain(*args, ga, gl, grid_x, 16, chunk,
                                          dtype=f64)
    torch.cuda.synchronize()

    def dist(xs, refs):
        errs = [close_err(x, r, *TOL_BWD) for x, r in zip(xs, refs)]
        return max(e[0] for e in errs), max(e[1] for e in errs)

    (e_k, n_k), (e_32, n_32), (e_k32, n_k32) = (
        dist(d_k, d_64), dist(d_32, d_64), dist(d_k, d_32))
    print(f"[{label}] float64 yardstick (cotangents zeroed on "
          f"{int(flip.sum())} pixels flipped between any two of K3, plain "
          f"f32, plain f64): K4 vs plain f64 max|d| {e_k:.3e}, max "
          f"normalized {n_k:.4e}; plain f32 vs plain f64 {e_32:.3e}, "
          f"{n_32:.4e}; K4 vs plain f32 {e_k32:.3e}, {n_k32:.4e} (tol atol "
          f"{TOL_BWD[0]} rtol {TOL_BWD[1]})")
    check(n_k32 <= 1, f"[{label}] K4 disagrees with its plain version")
    check(not at_most_f32 or n_k <= n_32,
          f"[{label}] K4 is farther from the float64 plain K4 than the "
          "float32 plain K4")


def compare_pregathered(label, counts, geom, rgbd, grid_x, seed,
                        yardstick=False, at_most_f32=False):
    """K3 and K4 against their plain versions on one set of windows, and
    K4's lanes past each count exactly 0 (and, with ``yardstick``, both
    against the float64 plain version); returns the max abs errors, the
    cotangents and K3's outputs."""
    import torch
    from gs_localization_torch.raster import pallas_blend as pb

    chunk = min(CHUNK, geom.shape[2])
    args = (counts, geom, rgbd)
    out_k = pb.pregathered_blend_fwd_cuda(*args, grid_x, 16, chunk)
    out_p = pb.pregathered_blend_fwd_plain(*args, grid_x, 16, chunk)
    e_fwd, flip = check_forward(label, "K3", out_k, out_p,
                                float(rgbd.abs().max()))
    gacc, glogt = cotangents(out_k[0], out_k[1], seed)
    e_bwd, dk = check_backward(label, "K4 (dgeom, drgbd)", lambda ga, gl: list(
        zip(pb.pregathered_blend_bwd_cuda(*args, ga, gl, out_k[1], out_k[3],
                                          grid_x, 16, chunk),
            pb.pregathered_blend_bwd_plain(*args, ga, gl, grid_x, 16, chunk))),
        gacc, glogt, flip)
    past = (torch.arange(geom.shape[2], device=geom.device)[None, :]
            >= counts[:, None].long())
    n_past = int(past.sum())
    nz_past = sum(int((d.transpose(0, 1)[:, past] != 0).sum()) for d in dk)
    print(f"[{label}] K4: {nz_past} nonzero of {n_past} lanes past the "
          f"counts (must be 0)")
    check(nz_past == 0 and int((dk[0][:, 6:] != 0).sum()) == 0,
          f"[{label}] K4 wrote lanes past the count or the valid/pad rows")
    if yardstick:
        yardstick64(label, args, grid_x, chunk, out_k, out_p, gacc, glogt,
                    at_most_f32)
    return e_fwd, e_bwd, (gacc, glogt, out_k)


def gated_products(windows, walked, grid_x: int, chunk: int) -> int:
    """(pixel, pair) products that pass the gate over the walked lanes;
    ``windows(lo, hi)`` gives the (12+, B, K*chunk) rows of tiles lo..hi."""
    import torch
    from gs_localization_torch.raster import stream_blend as sb

    num_tiles = walked.shape[0]
    tiles = torch.arange(num_tiles, device=walked.device)
    lanes = torch.arange(chunk, device=walked.device)
    gated = 0
    with torch.no_grad():
        for lo, hi in sb._blocks(num_tiles, 256, chunk):
            win = windows(lo, hi)
            px, py = sb._pixel_coords(tiles[lo:hi], grid_x, 16)
            for k in range(win.shape[2] // chunk):
                lane_ok = (k * chunk + lanes)[None, :] < walked[lo:hi, None]
                alpha = sb._chunk_alpha(win[:, :, k * chunk:(k + 1) * chunk],
                                        px, py, lane_ok)
                gated += int((alpha > 0).sum())
    return gated


def work_of(chunks: int, slots: int, gated: int, fwd_bytes: int,
            bwd_bytes: int) -> dict:
    """The walked work and each kernel's least time for it: bytes over the
    HBM rate, instructions over their issue rates (seconds)."""
    def ins(inner):
        return tuple(slots * 256 * g + gated * i
                     for g, i in zip(INS_GATE, inner))

    fwd_ins, bwd_ins = ins(INS_FWD_IN), ins(INS_BWD_IN)
    return dict(chunks=chunks, slots=slots, gated=gated,
                fwd_ins=fwd_ins, bwd_ins=bwd_ins,
                fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes,
                fwd_ops_s=max(fwd_ins[0] / FP32_ISSUE, fwd_ins[1] / SFU_ISSUE),
                bwd_ops_s=max(bwd_ins[0] / FP32_ISSUE, bwd_ins[1] / SFU_ISSUE))


def walked_work(stream_t, pack, resid, grid_x: int):
    """What this run's data makes K1/K2 do: walked chunks, walked pair
    slots, (pixel, pair) products that pass the gate, and the bytes each
    kernel must move (each input read once, each output written once)."""
    import torch
    from gs_localization_torch.raster import stream_blend as sb

    num_tiles = pack.tstart.shape[0]
    k_stop = resid[:, 0, 1].long()
    start, count = sb._window(pack.tstart, pack.walk_counts,
                              stream_t.shape[1], CHUNK)
    walked = torch.minimum(count, k_stop * CHUNK)
    gated = gated_products(
        lambda lo, hi: sb._gather_windows(stream_t, start[lo:hi],
                                          walked[lo:hi], CHUNK)[0],
        walked, grid_x, CHUNK)
    slots = int(walked.sum())
    stream_read = slots * 12 * 4
    tile_io = num_tiles * 256 * 7 * 4          # accum + log_t + resid
    records = int(k_stop.sum()) * 256 * 4      # log T at each walked chunk
    return work_of(int(k_stop.sum()), slots, gated,
                   stream_read + num_tiles * 8 + tile_io + records,
                   stream_read + num_tiles * 8 + tile_io + records
                   + 16 * stream_t.shape[1] * 4)


def pregathered_work(counts, geom, rgbd, resid, grid_x: int):
    """What this run's data makes K3/K4 do, as walked_work: walked slots =
    sum over tiles of min(count, k_stop * chunk); K4's bytes include its
    whole (T, 12, cap) output."""
    import torch

    num_tiles, _, cap = geom.shape
    chunk = min(CHUNK, cap)
    k_stop = resid[:, 0, 1].long()
    walked = torch.minimum(torch.clamp(counts.long(), 0, cap), k_stop * chunk)
    gated = gated_products(
        lambda lo, hi: torch.cat([geom[lo:hi], rgbd[lo:hi]],
                                 dim=1).transpose(0, 1),
        walked, grid_x, chunk)
    slots = int(walked.sum())
    tile_io = num_tiles * 256 * 7 * 4          # accum + log_t + resid
    records = int(k_stop.sum()) * 256 * 4      # log T at each walked chunk
    read = slots * 12 * 4 + num_tiles * 4
    return work_of(int(k_stop.sum()), slots, gated, read + tile_io + records,
                   read + tile_io + records + num_tiles * 12 * cap * 4)


BLEND_KERNELS = ("stream_fwd", "stream_bwd", "pregathered_fwd",
                 "pregathered_bwd")
POSE_ALGEBRA = ("se3_apply_fwd", "se3_apply_bwd", "pose_vectors_fwd",
                "pose_vectors_bwd", "refine_adam")


def blend_launches(launches: dict) -> dict:
    """K1-K4's counts of a launch tally (the binning kernels launch once per
    binning, which the phases do not count ahead)."""
    return {k: launches[k] for k in BLEND_KERNELS}


def pose_algebra_launches(label: str, launches: dict, iters: int,
                          stream: bool = True) -> dict:
    """A path's launches of the refinement's pose algebra, checked against
    its ``iters`` refinement iterations: A1 twice an iteration (the
    tangent, the retraction), A2 and S1 once, and V1/V2 once on the stream
    layout (the ``PairPack``'s projection reads the camera itself)."""
    got = {k: launches[k] for k in POSE_ALGEBRA}
    v = iters if stream else 0
    want = {"se3_apply_fwd": 2 * iters, "se3_apply_bwd": iters,
            "pose_vectors_fwd": v, "pose_vectors_bwd": v,
            "refine_adam": iters}
    check(iters > 0 and got == want,
          f"{label}: pose-algebra launches {got} != {want} ({iters} "
          f"refinement iterations)")
    return got


def scene_case(dev):
    """The ``mip360-localize`` cell's map (drawn from SCENE_SEED by the
    benchmark's recipe, ``gsbench/configs/mip360-rgb.json``: 3,000,000
    Gaussians at SH 1), its camera at the bench pose (1237x822, fx 1000:
    a partial tile column) and its capacities (2^24 pairs). Returns (map,
    camera, config)."""
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.raster import RasterizerConfig
    from gsbench import registry, scene

    spec = json.loads((ROOT / SCENE_CONFIG).read_text())
    g = registry.driver("localize")._program_map(
        scene.make_map(spec["map"], SCENE_SEED, dev))
    s = spec["sensor"]
    cam = Camera.from_rt(np.eye(3), np.zeros(3), s["fx"], s["fy"],
                         s["width"], s["height"], cx=s["cx"], cy=s["cy"],
                         device=dev)
    return g, cam, RasterizerConfig(**spec["raster"])


def binning_kernels(g, dev, scene) -> dict:
    """``csrc/binning.cu``'s kernels at the bench map, 640x480 and
    1024x576, at the benchmark's capacities (``RasterizerConfig`` defaults
    but ``max_pairs`` 2^21: int32 sort keys), and at ``scene``
    (``scene_case``: 4,056 tiles x 2^22 ranks pass int32, so the keys are
    int64 and the placement is ``gsl_bin_place64``): ``bin_stream`` on the
    card against the CPU in every field, each kernel on the inputs
    ``bin_stream`` gave it against its plain version on the card and on
    the CPU (exact); the kernels' device time per call and median single
    call, the plain versions' (the scatter-max and ``cummax`` the kernels
    replaced, mask waits included) and the whole ``bin_stream``'s single
    call, beside each kernel's byte bound (the placement's counts the key's
    own width)."""
    import torch
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.raster import RasterizerConfig, binning
    from gs_localization_torch.raster.preprocess import (Preprocessed,
                                                         preprocess)
    from gs_localization_torch.raster.rasterize import bin_stream_for

    bench_cfg = RasterizerConfig(max_pairs=1 << 21)
    cases = [(label, g, Camera.from_rt(np.eye(3), np.zeros(3), fx, fx, w, h,
                                       device=dev), bench_cfg, torch.int32)
             for label, (w, h, fx) in (("640x480", (640, 480, 585.0)),
                                       ("1024x576", (1024, 576, 893.25)))]
    cases.append(("scene 1237x822", *scene, torch.int64))
    result = {}
    for label, gm, cam, cfg, key_dtype in cases:
        with torch.no_grad():
            prep = preprocess(gm, cam)
        seen = {}

        def spy(name, fn):
            def wrapped(*a):
                seen[name] = a
                return fn(*a)
            return wrapped

        real = binning.slot_owner, binning.place_stream
        binning.slot_owner = spy("owner", real[0])
        binning.place_stream = spy("place", real[1])
        try:
            bins = bin_stream_for(prep, cam, cfg)
        finally:
            binning.slot_owner, binning.place_stream = real
        bins_cpu = bin_stream_for(Preprocessed(*(x.cpu() for x in prep)),
                                  cam, cfg)
        for f in binning.StreamBins._fields:
            a, b = getattr(bins, f), getattr(bins_cpu, f)
            if torch.is_tensor(a):
                check(a.is_cuda and torch.equal(a.cpu(), b),
                      f"[binning {label}] bin_stream {f}: card != CPU")
        del bins_cpu
        own, pl = seen["owner"], seen["place"]
        check(pl[0].dtype == key_dtype,
              f"[binning {label}] sort keys {pl[0].dtype}, not {key_dtype}")
        p, max_pairs = own[1], own[2]
        mr, kept = pl[6], int(pl[5])
        key_bytes = pl[0].element_size()
        bound = {"owner": 4 * (max_pairs + p + 1) / PEAK_HBM * 1e3,
                 "place": ((12 + key_bytes) * mr + 12 * kept) / PEAK_HBM
                 * 1e3}
        row = {}
        for name, kern, plain, args in (
                ("owner", binning.slot_owner_cuda, binning.slot_owner_plain,
                 own),
                ("place", binning.place_stream_cuda,
                 binning.place_stream_plain, pl)):
            on_cpu = tuple(x.cpu() if torch.is_tensor(x) else x for x in args)
            got, ref, ref_cpu = (kern(*args), plain(*args), plain(*on_cpu))
            if name == "owner":
                got, ref, ref_cpu = (got,), (ref,), (ref_cpu,)
            check(all(torch.equal(x, y) and torch.equal(y.cpu(), z)
                      for x, y, z in zip(got, ref, ref_cpu)),
                  f"[binning {label}] {name} kernel != plain")
            del got, ref, ref_cpu
            row[name] = dict(
                device_ms=device_ms(lambda: kern(*args)),
                ms=time_ms(lambda: kern(*args)),
                plain_ms=time_ms(lambda: plain(*args), N_PLAIN_TIMED),
                bound_ms=bound[name])
        row["bin_stream_ms"] = time_ms(lambda: bin_stream_for(prep, cam, cfg),
                                       N_PLAIN_TIMED)
        row["shape"] = dict(p=p, max_pairs=max_pairs, slots=int(pl[0].numel()),
                            mr=mr, kept=kept, tiles=int(pl[3].numel()),
                            key=str(pl[0].dtype))
        print(f"[binning {label}] bin_stream card == CPU in every field; "
              f"owner and placement == plain (card and CPU); "
              f"{json.dumps(row)}")
        result[label] = row
        del bins, prep, seen, own, pl
        torch.cuda.empty_cache()
    return result


def scene_blend(g, cam, cfg) -> dict:
    """K1 and K2 against their plain versions on the ``mip360-localize``
    cell's stream (``scene_case``: about 2,000 pairs a tile over 4,056
    tiles, the last tile column 5 pixels wide), with each kernel's device
    time per call and median single call beside its bound for this
    stream's walked work."""
    import torch
    from gs_localization_torch.raster import stream_blend as sb
    from gs_localization_torch.raster.pose_mode import (
        _project_stream, build_stream_pair_pack)

    grid_x = -(-cam.width // 16)
    pack = build_stream_pair_pack(g, cam, cfg)
    check(not bool(pack.overflow), "scene pack overflow")
    with torch.no_grad():
        stream_t = _project_stream(pack.params, pack.kept_al, cam)
    counts = pack.walk_counts
    shape = dict(slots=int(stream_t.shape[1]), kept_al=int(pack.kept_al),
                 tiles=int(counts.shape[0]), max_walk=int(counts.max()),
                 mean_walk=float(counts.float().mean()))
    print(f"scene stream: {shape}")
    err_k1, err_k2, (gacc, glogt, fwd) = compare_kernels(
        "scene", stream_t, pack, grid_x, seed=9)
    args = (stream_t, pack.tstart, pack.walk_counts)
    wk = walked_work(stream_t, pack, fwd[2], grid_x)
    row = {"shape": shape, "walked": {k: wk[k] for k in
                                      ("chunks", "slots", "gated")}}
    for name, fn, err, ops_s, byts in (
            ("K1", lambda: sb.stream_blend_fwd_cuda(*args, grid_x, 16,
                                                    CHUNK),
             err_k1, wk["fwd_ops_s"], wk["fwd_bytes"]),
            ("K2", lambda: sb.stream_blend_bwd_cuda(
                *args, gacc, glogt, fwd[1], fwd[3], grid_x, 16, CHUNK),
             err_k2, wk["bwd_ops_s"], wk["bwd_bytes"])):
        row[name] = dict(max_abs_err=err, device_ms=device_ms(fn),
                         ms=time_ms(fn),
                         bound_ms=max(ops_s, byts / PEAK_HBM) * 1e3)
    print(f"[scene] K1/K2 == plain; {json.dumps(row)}")
    return row


def pose_projection(label: str, pack, cam) -> dict:
    """P1 and P2 (``csrc/pose_project.cu``) against their plain versions on
    a stream pack, at the pack's camera moved by ``PROJ_TAU`` (as inside a
    rebin window): P1 against ``_project_core`` at every live position
    (valid equal off the near cull's rounding band), zero past
    ``kept_al``; P2 against the plain adjoint (``_project_adjoint``), two
    calls the same bits. Times each kernel (device ms per call and the
    median single call) beside its byte bound and the plain versions: the
    autograd-enabled ``_project_stream_plain`` forward and its autograd
    backward (what P1/P2 replace on the card), and the plain adjoint; the
    median single call of the whole CUDA path (``_project_stream``: the
    camera vectors, ``Camera.projection`` included, and P1); the
    launches of one forward and backward through ``render_pose_mode``'s
    path, and each kernel's occupancy."""
    import torch
    import gs_localization_torch as gsl
    from gs_localization_torch import _kernels
    from gs_localization_torch.raster import pose_mode as pm

    dev = pack.params.device
    tau = torch.tensor(PROJ_TAU, device=dev, requires_grad=True)
    cam_q = cam.with_delta(tau.detach())
    pose, intr = pm.camera_vectors(cam_q)
    args = (pack.params, pack.kept_al, pose, intr)
    size = (cam.width, cam.height)
    n, kept = pack.params.shape[1], int(pack.kept_al)
    out = pm.pose_project_fwd_cuda(*args, *size, 0.2)
    with torch.no_grad():
        plain = pm._project_stream_plain(pack.params, cam_q)
    rows = [r for r in range(16) if r != 6]
    err_f = close_err(out[rows, :kept], plain[rows, :kept], *TOL_PROJ)
    vz = plain[11, :kept]
    clear = (vz - 0.2).abs() > 1e-5 * torch.clamp_min(vz.abs(), 1.0)
    valid_off = int((out[6, :kept] != plain[6, :kept])[clear].sum())
    valid_band = int((out[6, :kept] != plain[6, :kept])[~clear].sum())
    same_bits = bool(torch.equal(out[:, :kept], plain[:, :kept]))
    check(err_f[1] <= 1.0, f"[{label}] P1 != plain: {err_f}")
    check(valid_off == 0, f"[{label}] P1 valid != plain at {valid_off}")
    check(bool((out[:, kept:] == 0).all()), f"[{label}] P1 past kept_al")
    del plain
    gen = torch.Generator().manual_seed(5)
    dstream = torch.randn(out.shape, generator=gen).to(dev)
    dstream[:, kept:] = 0.0
    g1 = pm.pose_project_bwd_cuda(*args, dstream, *size)
    g2 = pm.pose_project_bwd_cuda(*args, dstream, *size)
    want = pm._project_adjoint(pack.params, pack.kept_al, cam_q, dstream)
    err_b = close_err(g1, want, TOL_ADJ[0] * float(want.abs().max()),
                      TOL_ADJ[1])
    check(bool(torch.equal(g1, g2)), f"[{label}] P2 calls differ")
    check(err_b[1] <= 1.0, f"[{label}] P2 != plain adjoint: {err_b}")
    torch.cuda.synchronize()
    before = dict(gsl.LAUNCHES)
    s = pm._project_stream(pack.params, pack.kept_al, cam.with_delta(tau))
    (s * dstream).sum().backward()
    torch.cuda.synchronize()
    launches = {k: gsl.LAUNCHES[k] - before[k] for k in before
                if gsl.LAUNCHES[k] != before[k]}
    check(launches == {"pose_project_fwd": 1, "pose_project_bwd": 1,
                       "se3_apply_fwd": 1, "se3_apply_bwd": 1,
                       "pose_vectors_fwd": 1, "pose_vectors_bwd": 1},
          f"[{label}] launches of one projection: {launches}")

    def plain_fwd():
        return pm._project_stream_plain(pack.params, cam.with_delta(tau))

    s_plain = plain_fwd()
    info = _kernels.kernel_info()
    live_bytes = 4 * (14 + 16)
    row = {
        "shape": dict(slots=n, kept_al=kept),
        "P1": dict(max_abs_err=err_f[0], same_bits=same_bits,
                   valid_in_band=valid_band,
                   device_ms=device_ms(lambda: pm.pose_project_fwd_cuda(
                       *args, *size, 0.2)),
                   ms=time_ms(lambda: pm.pose_project_fwd_cuda(
                       *args, *size, 0.2)),
                   bound_ms=(live_bytes * kept + 64 * (n - kept)) / PEAK_HBM
                   * 1e3,
                   plain_ms=time_ms(plain_fwd, N_PLAIN_TIMED),
                   path_ms=time_ms(lambda: pm._project_stream(
                       pack.params, pack.kept_al, cam.with_delta(tau))),
                   occupancy=info["P1 pose_project_fwd"]),
        "P2": dict(max_abs_err=err_b[0], max_abs=float(want.abs().max()),
                   device_ms=device_ms(lambda: pm.pose_project_bwd_cuda(
                       *args, dstream, *size)),
                   ms=time_ms(lambda: pm.pose_project_bwd_cuda(
                       *args, dstream, *size)),
                   bound_ms=4 * 15 * kept / PEAK_HBM * 1e3,
                   plain_ms=time_ms(lambda: torch.autograd.grad(
                       s_plain, tau, dstream, retain_graph=True),
                       N_PLAIN_TIMED),
                   plain_adjoint_ms=time_ms(lambda: pm._project_adjoint(
                       pack.params, pack.kept_al, cam_q, dstream),
                       N_PLAIN_TIMED),
                   occupancy=info["P2 pose_project_bwd"]),
        "launches": launches}
    print(f"[{label}] P1 == plain (bits equal on the live prefix: "
          f"{same_bits}), P2 == plain adjoint, two P2 calls equal; "
          f"{json.dumps(row)}")
    del s_plain, out, dstream
    torch.cuda.empty_cache()
    return row


def pose_algebra(cam) -> dict:
    """A1/A2, V1/V2 and S1 (``csrc/pose_algebra.cu``) against their plain
    versions at ``cam`` moved by ``PROJ_TAU``: A1 and V1 within 2 float32
    ulps of the terms' magnitude, A2, V2 and S1 within 1e-6 of the largest
    entry. Times each kernel (device ms per call back to back, enqueued
    ahead; the median single call; host us per call over calls back to
    back) beside its plain version on the card, and the host time of one
    iteration's pose algebra both ways: the tangent into the camera
    vectors, their backward, the Adam step and the retraction."""
    import torch
    from gs_localization_torch.core import se3
    from gs_localization_torch.loc import refine
    from gs_localization_torch.raster import pose_mode as pm

    dev = cam.device
    tau = torch.tensor(PROJ_TAU, device=dev)
    w2c = cam.w2c
    cam_q = cam.with_delta(tau)
    gen = torch.Generator().manual_seed(7)
    g44 = torch.randn((4, 4), generator=gen).to(dev)
    gpose = torch.randn(24, generator=gen).to(dev)
    g6, g2 = (torch.randn(n, generator=gen).to(dev) * 1e-3 for n in (6, 2))
    state = [torch.zeros(n, device=dev) for n in (6, 6, 2, 2, 2)]

    def ulps(got, want, scale) -> float:
        scale = scale.float().abs()
        ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
            - scale
        return float(((got - want).abs() / ulp).max())

    def rel(got, want) -> float:
        return float((got - want).abs().max() / want.abs().max())

    a1 = se3.apply_delta_fwd_cuda(tau, w2c)
    terms = se3.se3_exp(tau.double()).abs() @ w2c.double().abs()
    err = {"A1_ulps": ulps(a1, se3.se3_exp(tau) @ w2c, terms)}
    pose, intr = pm.pose_vectors_fwd_cuda(cam_q)
    pose_p, intr_p = pm._camera_vectors_plain(cam_q)
    fp = cam_q.projection.double().abs() @ cam_q.w2c.double().abs()
    scale = torch.cat([cam_q.w2c[:3].double().abs(), fp[0:2], fp[3:4]])
    err["V1_ulps"] = max(ulps(pose, pose_p, scale.reshape(24)),
                         ulps(intr, intr_p, intr_p))
    err["A2_rel"] = max(rel(k, p) for k, p in zip(
        se3.apply_delta_bwd_cuda(tau, w2c, g44),
        se3._apply_delta_adjoint(tau, w2c, g44)))
    err["V2_rel"] = rel(pm.pose_vectors_bwd_cuda(cam_q, gpose),
                        pm._camera_vectors_adjoint(cam_q, gpose))
    kern, plain = [x.clone() for x in state], [x.clone() for x in state]
    out_k = refine.refine_adam_cuda(g6, g2, *kern, 3.0, 1e-3)
    out_p = refine.refine_adam_plain(g6, g2, *plain, 3.0, 1e-3)
    err["S1_rel"] = max(rel(k, p) for k, p in zip(kern + list(out_k),
                                                  plain + list(out_p)))
    check(err["A1_ulps"] <= 2 and err["V1_ulps"] <= 2,
          f"A1/V1 != plain: {err}")
    check(max(err["A2_rel"], err["V2_rel"], err["S1_rel"]) <= 1e-6,
          f"A2/V2/S1 != plain: {err}")

    def host_us(fn, n: int = 200) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    def plain_bwd(fwd, x, g):
        def run():
            xx = x.detach().requires_grad_()
            torch.autograd.grad(fwd(xx), xx, g)
        return run

    a1_plain = lambda: se3.se3_exp(tau) @ w2c  # noqa: E731
    calls = {
        "A1": (lambda: se3.apply_delta_fwd_cuda(tau, w2c), a1_plain),
        "A2": (lambda: se3.apply_delta_bwd_cuda(tau, w2c, g44),
               plain_bwd(lambda t: se3.se3_exp(t) @ w2c, tau, g44)),
        "V1": (lambda: pm.pose_vectors_fwd_cuda(cam_q),
               lambda: pm._camera_vectors_plain(cam_q)),
        "V2": (lambda: pm.pose_vectors_bwd_cuda(cam_q, gpose),
               plain_bwd(lambda w: pm._camera_vectors_plain(
                   cam_q.replace(w2c=w))[0], cam_q.w2c, gpose)),
        "S1": (lambda: refine.refine_adam_cuda(g6, g2, *kern, 3.0, 1e-3),
               lambda: refine.refine_adam_plain(g6, g2, *plain, 3.0, 1e-3)),
    }

    row = {"errors": err}
    for name, (k_fn, p_fn) in calls.items():
        row[name] = dict(device_ms=device_ms(k_fn, 200, queued=True),
                         ms=time_ms(k_fn),
                         host_us=host_us(k_fn), plain_ms=time_ms(p_fn),
                         plain_host_us=host_us(p_fn))

    def iteration(kernels: bool):
        def run():
            t = torch.zeros(6, device=dev, requires_grad=True)
            if kernels:
                p, _ = pm.camera_vectors(cam.with_delta(t))
            else:
                p, _ = pm._camera_vectors_plain(
                    cam.replace(w2c=se3.se3_exp(t) @ w2c))
            (gt,) = torch.autograd.grad(p, t, gpose)
            step = refine.refine_adam if kernels else refine.refine_adam_plain
            upd6, norm = step(gt, g2, *state, 3.0, 1e-3)
            if kernels:
                se3.apply_delta(upd6, w2c)
            else:
                se3.se3_exp(upd6) @ w2c
        return run

    row["iteration"] = dict(host_us=host_us(iteration(True)),
                            plain_host_us=host_us(iteration(False)))
    print(f"[pose algebra] A1/V1 within 2 ulps, A2/V2/S1 within 1e-6 of "
          f"plain; {json.dumps(row)}")
    return row


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


def device_ms(fn, n: int = N_TIMED, queued: bool = False) -> float:
    """Device time per call: CUDA events around n calls made back to back
    after a warm-up, so that the host's enqueue overlaps the card's work.
    ``queued``: the card first spins for ~25 ms, so that calls whose host
    side is slower than their kernel are all enqueued before the first
    event runs and the events time the kernels alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def perturbed(cam, rng, rot: float, trans: float):
    """cam moved by a tangent of the given rotation (rad) and translation
    (m) magnitudes in random directions."""
    import torch

    def unit():
        v = rng.standard_normal(3)
        return v / np.linalg.norm(v)

    tau = np.concatenate([trans * unit(), rot * unit()])
    return cam.with_delta(torch.tensor(tau, dtype=torch.float32,
                                       device=cam.device))


class Tee:
    """A text stream that keeps what is written, with the time of each
    write (after ``sync()``, when given, so that a line's time includes the
    device work enqueued before it), and passes it on."""

    def __init__(self, out, sync=None):
        self.out, self.parts, self.stamps, self.sync = out, [], [], sync

    def write(self, text):
        if self.sync is not None:
            self.sync()
        self.parts.append(text)
        self.stamps.append((time.perf_counter(), text))
        return self.out.write(text)

    def time_of(self, needle: str) -> float:
        """The time of the first write that contains needle."""
        hits = [t for t, text in self.stamps if needle in text]
        check(bool(hits), f"no log line contains {needle!r}")
        return hits[0]

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def write_png(path, img, depth: bool) -> None:
    """8-bit RGB colour, or 16-bit millimetre depth, as 7-Scenes stores
    them."""
    from PIL import Image

    if depth:
        arr = np.clip(np.round(img * 1000.0), 0, 65535).astype(np.uint16)
    else:
        arr = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(path)


def write_seven_scenes(root: Path, g, views, cfg):
    """A raw 7-Scenes layout of the views at their width: colour and depth
    PNGs rendered from g (the first N_SCENE_TRAIN in seq-01, the rest in
    seq-02), TrainSplit.txt / TestSplit.txt, and sparse_dslam/0 with the
    true poses and no points. Returns {flat image name: w2c (float64)}."""
    import torch
    from gs_localization_torch.core.camera import rotmat_to_quat
    from gs_localization_torch.data.colmap import (
        ColmapCamera, ColmapImage, write_colmap_model_text)
    from gs_localization_torch.raster import rasterize

    poses, images = {}, {}
    for i, v in enumerate(views):
        seq, k = (("seq-01", i) if i < N_SCENE_TRAIN
                  else ("seq-02", i - N_SCENE_TRAIN))
        (root / seq).mkdir(parents=True, exist_ok=True)
        with torch.no_grad():
            r = rasterize(g, v, cfg)
        check(not bool(r.overflow) and not bool(r.tile_overflow),
              "scene view render overflow")
        write_png(root / seq / f"frame-{k:06d}.color.png",
                  r.color.cpu().numpy(), depth=False)
        write_png(root / seq / f"frame-{k:06d}.depth.png",
                  r.depth.cpu().numpy(), depth=True)
        w2c = v.w2c.cpu().numpy().astype(np.float64)
        name = f"{seq}-frame-{k:06d}-color.png"
        images[i + 1] = ColmapImage(i + 1, rotmat_to_quat(w2c[:3, :3]),
                                    w2c[:3, 3], 1, name, np.zeros((0, 2)),
                                    np.zeros((0,), np.int64))
        poses[name] = w2c
    (root / "TrainSplit.txt").write_text("sequence1\n")
    (root / "TestSplit.txt").write_text("sequence2\n")
    v0 = views[0]
    cams = {1: ColmapCamera(1, "PINHOLE", v0.width, v0.height, np.array(
        [float(v0.fx), float(v0.fy), float(v0.cx), float(v0.cy)]))}
    write_colmap_model_text(str(root / "sparse_dslam" / "0"), cams, images,
                            {})
    return poses


def scene_pack_check(label, g0, cam, rcfg, grid_x, seed):
    """K1/K2 through ``blend_stream`` on g0's pack at cam against the plain
    versions: K1 vs plain on the assembled stream (check_forward), then the
    pack gradient, i.e. K2 and the gather's adjoint (``index_add_``,
    atomics), against the plain K2 and autograd of the same gather, for
    one set of cotangents (check_backward, rows = the 12 pack rows).
    Returns the max abs errors."""
    import torch
    from gs_localization_torch.raster import stream_blend as sb
    from gs_localization_torch.raster.preprocess import preprocess
    from gs_localization_torch.raster.rasterize import (bin_stream_for,
                                                        stream_pack)

    with torch.no_grad():
        prep = preprocess(g0, cam)
        pack = stream_pack(prep, prep.means2d)
        sbins = bin_stream_for(prep, cam, rcfg)
        stream_t = sb.assemble_stream(pack, sbins.gid_of_pos, CHUNK)
    check(not bool(sbins.overflow) and not bool(sbins.tile_overflow),
          f"[{label}] bin_stream overflow")
    args = (stream_t, sbins.tstart, sbins.walk_counts)
    out_k = sb.stream_blend_fwd_cuda(*args, grid_x, 16, CHUNK)
    out_p = sb.stream_blend_fwd_plain(*args, grid_x, 16, CHUNK)
    e_fwd, flip = check_forward(label, "K1", out_k, out_p,
                                float(stream_t[8:12].abs().max()))
    gacc, glogt = cotangents(out_k[0], out_k[1], seed)
    pos_ok = (torch.arange(stream_t.shape[1], device=stream_t.device)
              < sbins.kept_al)[None, :]

    def grads(ga, gl):
        pk = pack.clone().requires_grad_()
        out = sb.blend_stream(pk, sbins, grid_x, 16, chunk=CHUNK)
        d_k, = torch.autograd.grad(
            (out.color, out.depth, out.log_t), (pk,),
            (ga[:, :3].transpose(1, 2), ga[:, 3], gl[..., 0]))
        pp = pack.clone().requires_grad_()
        st = sb.assemble_stream(pp, sbins.gid_of_pos, CHUNK)
        dst = sb.stream_blend_bwd_plain(*args, ga, gl, grid_x, 16, CHUNK)
        d_p, = torch.autograd.grad(st, (pp,), torch.where(pos_ok, dst, 0.0))
        return [(d_k.T.contiguous(), d_p.T.contiguous())]

    e_bwd, _ = check_backward(label, "K1/K2 pack gradient", grads, gacc,
                              glogt, flip)
    print(f"[{label}] K1/K2 vs plain: through blend_stream on the initial "
          f"map's pack ({pack.shape[0]} Gaussians, {int(sbins.kept_al)} "
          f"stream lanes, {int(flip.sum())} flipped pixels): forward max|d| "
          f"{e_fwd:.3e}, pack gradient max|d| {e_bwd:.3e} (tol atol "
          f"{TOL_BWD[0]} rtol {TOL_BWD[1]}, flip accounting as K2's)")
    return e_fwd, e_bwd


def localize_checked(label, g, queries, init, gt_w2c, pcfg, cfg):
    """localize_queries with the launch counters set to 0 just before and
    read just after; every query's error must fall. Returns (launches,
    ms/iteration, logs)."""
    import torch
    import gs_localization_torch as gsl
    from gs_localization_torch.pipelines.localize import localize_queries
    from gs_localization_torch.sfm.evaluate import pose_errors

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
    iters = len(queries) * pcfg.tracking.num_iters
    for line in logs:
        print(f"{label}: {line}")
    for q, (e0t, e0r) in zip(queries, init):
        w = results[q.name]
        check(np.isfinite(w).all(), f"{label} {q.name}: non-finite pose")
        e1t, e1r = pose_errors(w[:3, :3], w[:3, 3], gt_w2c[:3, :3],
                               gt_w2c[:3, 3])
        print(f"{label} {q.name}: trans {e0t * 100:.3f} -> {e1t * 100:.3f} "
              f"cm, rot {e0r:.4f} -> {e1r:.4f} deg")
        check(e1t < e0t and e1r < e0r,
              f"{label} {q.name}: error did not decrease")
    ms = ev0.elapsed_time(ev1) / iters
    print(f"{label}: {iters} iterations, {ms:.3f} ms/iteration (CUDA events "
          f"around localize_queries); metrics {metrics}")
    print(f"{label} launches: {launches}")
    return launches, ms, logs


def synthetic_sfm_scene(rng, n_cams=8, n_pts=300, noise_px=0.4,
                        outlier_frac=0.05, width=640, height=480):
    """``tests/test_incremental_sfm.py``'s synthetic scene, the same draws:
    cameras on an arc looking at a point cloud, pairwise matches with pixel
    noise and a share of wrong associations. Returns (X, w2c, K, keypoints,
    matches)."""
    K = np.array([[520.0, 0, width / 2], [0, 520.0, height / 2], [0, 0, 1]])
    X = np.stack([rng.uniform(-2.5, 2.5, n_pts),
                  rng.uniform(-1.8, 1.8, n_pts),
                  rng.uniform(5.0, 9.0, n_pts)], 1)
    w2c = np.tile(np.eye(4), (n_cams, 1, 1))
    for c in range(n_cams):
        ang = (c - n_cams / 2) * 0.08
        w2c[c, :3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                          [-np.sin(ang), 0, np.cos(ang)]]
        w2c[c, :3, 3] = np.array([-0.6 * c + 2.0, 0.05 * c, 0.05 * c])
    kps, vis_ids = [], []
    for c in range(n_cams):
        Xc = X @ w2c[c, :3, :3].T + w2c[c, :3, 3]
        uv = np.stack([K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2],
                       K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]], 1)
        ok = (Xc[:, 2] > 0.2) & (uv[:, 0] >= 0) & (uv[:, 0] < width) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < height)
        ids = np.nonzero(ok)[0]
        kps.append((uv[ids] + noise_px * rng.standard_normal(
            (len(ids), 2))).astype(np.float64))
        vis_ids.append(ids)
    matches = {}
    for i in range(n_cams):
        for j in range(i + 1, min(i + 4, n_cams)):
            common, ia, ja = np.intersect1d(vis_ids[i], vis_ids[j],
                                            return_indices=True)
            if len(common) < 8:
                continue
            m = np.stack([ia, ja], 1)
            n_out = int(outlier_frac * len(m))
            if n_out:
                rows = rng.choice(len(m), n_out, replace=False)
                m[rows, 1] = rng.integers(0, len(vis_ids[j]), n_out)
            matches[(i, j)] = m
    return X, w2c, K, kps, matches


def query_methods(log: str) -> dict:
    """{query name: method} from the sfm stage's ``name: method (n inl)``
    lines."""
    return dict(re.findall(r"^(\S+\.png): (\w+) \(\d+ inl\)$", log,
                           re.MULTILINE))


def all_stages(g, cam, cfg, dev) -> dict:
    """The scene runner's four stages in one call, the sfm stage on the
    card (see the module docstring, step 13). Returns the call's launch
    counts."""
    import torch
    import gs_localization_torch as gsl
    from gs_localization_torch.core.camera import (quat_to_rotmat,
                                                   rotmat_to_quat)
    from gs_localization_torch.data.scene import load_image
    from gs_localization_torch.pipelines import localize as ploc
    from gs_localization_torch.pipelines import run_scene
    from gs_localization_torch.sfm.bundle_adjust import bundle_adjust_np
    from gs_localization_torch.sfm.features import (extract_harris_features,
                                                    rgb_to_gray)
    from gs_localization_torch.sfm.incremental import incremental_mapping
    from gs_localization_torch.sfm.io import (read_pose_results,
                                              write_pose_results)
    from gs_localization_torch.sfm.sift import extract_sift
    from gs_localization_torch.sfm.evaluate import pose_errors

    cpu = torch.device("cpu")
    smi = smi_line()
    scene_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_all_",
                                      dir=ROOT / "build"))
    batch = ploc.refine_poses_batch
    try:
        # the scene phase's layout, the same views, and no sfm files
        root = scene_dir / "chess"
        rng_s = np.random.default_rng(13)
        views = [cam] + [perturbed(cam, rng_s, 0.03, 0.1) for _ in
                         range(N_SCENE_TRAIN + N_SCENE_TEST - 1)]
        true_w2c = write_seven_scenes(root, g, views, cfg)
        test_names = list(true_w2c)[N_SCENE_TRAIN:]
        out = root / "output_tpu"
        check(not out.exists(), "the layout holds sfm files")
        # each refine_poses_batch call's iterations per query
        # (RefineResult.num_iters)
        loc_calls = []

        def counted(*a, **kw):
            res = batch(*a, **kw)
            loc_calls.append(list(res.num_iters))
            return res

        ploc.refine_poses_batch = counted
        tee = Tee(sys.stdout, sync=torch.cuda.synchronize)
        torch.cuda.synchronize()
        gsl.reset_launches()
        with contextlib.redirect_stdout(tee):
            done = run_scene.main(["--scene", str(root), "--preset",
                                   "seven_scenes", "--stage", "all",
                                   "--iterations", str(SCENE_ITERS)])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = dict(gsl.LAUNCHES)
        ploc.refine_poses_batch = batch
        log = tee.text()

        # the sfm stage's outputs and its time split
        mapped, poses = done["sfm"]
        n_pts = int(mapped.valid.sum())
        cloud = np.load(out / "sfm_points.npz")
        check((out / "results_dense.txt").exists()
              and len(cloud["points"]) == n_pts >= 1,
              f"the sfm stage wrote {len(cloud['points'])} points")
        check(sorted(read_pose_results(str(out / "results_dense.txt")))
              == sorted(test_names), "results_dense.txt misses queries")
        methods = query_methods(log)
        check(sorted(methods) == sorted(test_names)
              and "pnp" in methods.values(),
              f"no query took PnP: {methods}")
        t_sfm = tee.time_of("=== stage: sfm")
        t_ext = tee.time_of("extracted features for")
        t_match = tee.time_of("matched ")
        t_tri = tee.time_of("depth-corrected;")
        t_pnp = max(tee.time_of(f"{n}: ") for n in test_names)
        t_train = tee.time_of("=== stage: train")
        t_loc = tee.time_of("=== stage: localize")
        print(f"[all] sfm stage {t_train - t_sfm:.3f} s: extraction "
              f"{t_ext - t_sfm:.3f} s (scene and image loading, 8 tiny-image "
              f"descriptors, retrieval, 8 Harris extractions), matching "
              f"{t_match - t_ext:.3f} s, triangulation {t_tri - t_match:.3f} s "
              f"(verification, tracks, DLT, depth correction), PnP "
              f"{t_pnp - t_tri:.3f} s (colours, then per query: image, "
              f"extraction, retrieval, matching, PnP-RANSAC), writing "
              f"{t_train - t_pnp:.3f} s; {n_pts} sfm points ({smi})")
        init_err = {}
        for name in test_names:
            q, t = poses[name]
            R = quat_to_rotmat(torch.tensor(q)).numpy()
            gt_w = true_w2c[name]
            init_err[name] = pose_errors(R, t, gt_w[:3, :3], gt_w[:3, 3])
            print(f"[all] {name}: {methods[name]}, initial error "
                  f"{init_err[name][0] * 100:.3f} cm / "
                  f"{init_err[name][1]:.4f} deg ({smi})")

        # exact launch counts: train steps and held-out renders, then one
        # forward and one backward per localize iteration; no K3/K4
        n_held = min(8, N_SCENE_TEST)
        n_loc = int(sum(map(sum, loc_calls)))
        want = {"stream_fwd": SCENE_ITERS + n_held + n_loc,
                "stream_bwd": SCENE_ITERS + n_loc, "pregathered_fwd": 0,
                "pregathered_bwd": 0}
        print(f"[all] launches {launches}; expected {want} ({SCENE_ITERS} "
              f"steps, {n_held} held-out renders, {n_loc} localize "
              f"iterations)")
        check(blend_launches(launches) == want and n_loc > 0,
              f"--stage all launches {launches} != {want}")
        pose_algebra_launches("[all]", launches, n_loc)
        _, metrics = done["localize"]
        check((out / "metrics.json").exists(), "no metrics.json")
        on_disk = json.loads((out / "metrics.json").read_text())
        check(all(np.isfinite(v) for v in on_disk.values()),
              f"non-finite metrics {on_disk}")
        # loose gate: three runs ended at 0.373-0.375 cm / 0.175-0.177 deg
        check(on_disk["median_trans_m"] < 0.01
              and on_disk["median_rot_deg"] < 0.5,
              f"the localize stage's median error is not under 1 cm / "
              f"0.5 deg: {on_disk}")
        print(f"[all] train stage {(t_loc - t_train) * 1e3 / SCENE_ITERS:.3f}"
              f" ms/step (scene loading, held-out PSNR and the PLY save "
              f"included); localize stage {(t_end - t_loc) * 1e3 / n_loc:.3f}"
              f" ms/iteration over {n_loc} iterations (map and image loading "
              f"included); final median error "
              f"{on_disk['median_trans_m'] * 100:.3f} cm / "
              f"{on_disk['median_rot_deg']:.4f} deg ({smi}); metrics.json "
              f"{on_disk}")

        # the card's localize held against the CPU's (the plain versions)
        # from the card's PLY and init, for the query whose error rose the
        # most over its init: the same preset, raster config and code
        res_g = done["localize"][0]
        check(len(loc_calls[-1]) == len(res_g), "one localize batch expected")
        iters_g = dict(zip(res_g, loc_calls[-1]))

        def err_of(name, w):
            gt_w = true_w2c[name]
            return pose_errors(w[:3, :3], w[:3, 3], gt_w[:3, :3],
                               gt_w[:3, 3])

        worst = max(res_g, key=lambda n: err_of(n, res_g[n])[0]
                    - init_err[n][0])
        out_l = scene_dir / "out_cpu_localize"
        out_l.mkdir()
        write_pose_results(str(out_l / "results_dense.txt"), {
            worst: read_pose_results(str(out / "results_dense.txt"))[worst]})
        ply = out / "gs_map" / f"iteration_{SCENE_ITERS}" / "point_cloud.ply"
        loc_calls.clear()
        ploc.refine_poses_batch = counted
        t0 = time.perf_counter()
        done_l = run_scene.main(["--scene", str(root), "--preset",
                                 "seven_scenes", "--stage", "localize",
                                 "--device", "cpu", "--out", str(out_l),
                                 "--map", str(ply)])
        cpu_s = time.perf_counter() - t0
        ploc.refine_poses_batch = batch
        w_g, w_c = res_g[worst], done_l["localize"][0][worst]
        it_g, it_c = iters_g[worst], loc_calls[-1][0]
        (e_gt, e_gr), (e_ct, e_cr) = err_of(worst, w_g), err_of(worst, w_c)
        d_t, d_r = pose_errors(w_c[:3, :3], w_c[:3, 3], w_g[:3, :3],
                               w_g[:3, 3])

        def pose_str(w):
            q = rotmat_to_quat(w[:3, :3].astype(np.float64))
            return (f"q {np.array2string(q, precision=7)} t "
                    f"{np.array2string(w[:3, 3], precision=7)}")

        e0t, e0r = init_err[worst]
        print(f"[all] localize card vs CPU from the card's map, {worst} "
              f"(init {e0t * 100:.3f} cm / {e0r:.4f} deg; the largest rise, "
              f"{(e_gt - e0t) * 100:.3f} cm): card {pose_str(w_g)}, "
              f"{e_gt * 100:.4f} cm / "
              f"{e_gr:.5f} deg, {it_g} iterations; CPU {pose_str(w_c)}, "
              f"{e_ct * 100:.4f} cm / {e_cr:.5f} deg, {it_c} iterations; "
              f"apart {d_t * 1e3:.4f} mm / {d_r:.5f} deg; CPU {cpu_s:.1f} s "
              f"on {torch.get_num_threads()} threads ({smi})")
        check(d_t < 1e-3 and d_r < 0.1,
              f"the CPU's localize of {worst} ends {d_t * 1e3:.4f} mm / "
              f"{d_r:.5f} deg from the card's (gate 1 mm / 0.1 deg)")
        check(abs(it_g - it_c) <= LOC_ITERS_APART,
              f"{worst}: {it_g} iterations on the card, {it_c} on the CPU")

        # the sfm stage alone on the CPU, on the same files
        tee_c = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee_c):
            done_c = run_scene.main(["--scene", str(root), "--stage", "sfm",
                                     "--device", "cpu", "--out",
                                     str(scene_dir / "out_cpu")])
        mapped_c, poses_c = done_c["sfm"]
        shares = []
        for f_g, f_c in zip(mapped.features, mapped_c.features):
            vg = f_g.scores.cpu().numpy() > 0
            vc = f_c.scores.numpy() > 0
            same = np.all(f_g.keypoints.cpu().numpy()
                          == f_c.keypoints.numpy(), axis=1)
            check(vg.sum() == vc.sum(), f"keypoint counts {vg.sum()} != "
                  f"{vc.sum()} (card vs CPU)")
            shares.append(float(same[vc].mean()))
        n_c = int(mapped_c.valid.sum())
        methods_c = query_methods(tee_c.text())
        pose_d = [pose_errors(quat_to_rotmat(torch.tensor(poses[n][0])
                                             ).numpy(), poses[n][1],
                              quat_to_rotmat(torch.tensor(poses_c[n][0])
                                             ).numpy(), poses_c[n][1])
                  for n in test_names]
        print(f"[all] sfm card vs CPU: keypoints at the same position "
              f"{min(shares):.4f} (worst image); valid points {n_pts} vs "
              f"{n_c}; methods {methods == methods_c}; init poses apart at "
              f"most {max(d[0] for d in pose_d) * 100:.4f} cm / "
              f"{max(d[1] for d in pose_d):.5f} deg")
        check(min(shares) >= 0.99, "keypoints differ (card vs CPU)")
        check(abs(n_pts - n_c) <= 0.01 * n_c, "sfm points differ")
        check(methods == methods_c, f"methods {methods} != {methods_c}")
        check(all(d[0] <= 0.01 and d[1] <= 0.1 for d in pose_d),
              "init poses differ by more than 1 cm / 0.1 deg (card vs CPU)")

        # the extractors: ms per 640x480 image on the card, and SIFT card
        # vs CPU on one view
        gray = rgb_to_gray(torch.tensor(load_image(
            str(root / "seq-01" / "frame-000000.color.png")), device=dev))
        harris_ms = time_ms(lambda: extract_harris_features(gray), 10)
        sift_ms = time_ms(lambda: extract_sift(gray), 10)
        sg, sc = extract_sift(gray), extract_sift(gray.cpu())
        valid = sc.scores.numpy() > 0
        pos = np.abs(sg.keypoints.cpu().numpy()
                     - sc.keypoints.numpy()).max(1) <= 1e-3
        cos = np.sum(sg.descriptors.cpu().numpy() * sc.descriptors.numpy(),
                     1)
        share = float((pos & (cos >= 0.9999))[valid].mean())
        same_ori = float((sg.orientations.cpu().numpy()
                          == sc.orientations.numpy())[valid].mean())
        print(f"[all] 640x480 extraction on the card: Harris "
              f"{harris_ms:.3f} ms, SIFT {sift_ms:.3f} ms per image (median "
              f"of 10 after a warm-up; {smi}); SIFT card vs CPU: "
              f"{share:.4f} of {int(valid.sum())} keypoints within 1e-3 px "
              f"with cosine >= 0.9999 (orientations equal on "
              f"{same_ori:.4f})")
        check(share >= 0.95, "SIFT differs (card vs CPU)")

        # bundle adjustment and the incremental mapper, card vs CPU
        X, w2c_s, K, kps, matches = synthetic_sfm_scene(
            np.random.default_rng(0))
        recs, costs, map_s = [], [], []
        for d in (dev, cpu):
            tee_m = Tee(sys.stdout)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee_m):
                recs.append(incremental_mapping(
                    kps, matches, K, seed=2, verbose=True, device=d,
                    ba_iters=MAP_BA_ITERS, final_ba_iters=MAP_FINAL_BA_ITERS))
            torch.cuda.synchronize()
            map_s.append(time.perf_counter() - t0)
            costs.append(float(re.findall(r"BA over .* -> ([\d.]+)",
                                          tee_m.text())[-1]))
        (rg, rc), (cg, cc) = recs, costs
        print(f"[all] incremental_mapping card vs CPU (bundle adjustments "
              f"of {MAP_BA_ITERS} and finally {MAP_FINAL_BA_ITERS} LM steps):"
              f" init pair "
              f"{rg.init_pair} / {rc.init_pair}, registered "
              f"{int(rg.registered.sum())} / {int(rc.registered.sum())}, "
              f"final BA cost {cg} / {cc}; wall {map_s[0]:.3f} / "
              f"{map_s[1]:.3f} s ({smi})")
        check(rg.init_pair == rc.init_pair
              and np.array_equal(rg.registered, rc.registered),
              "incremental_mapping registers differently (card vs CPU)")
        check(abs(cg - cc) <= 1e-3 * abs(cc), "final BA costs differ")
        # one BA call: the first 5 cameras at their true poses, 150 points
        # moved by 4 cm on each axis, their true projections
        n_obs = 150
        cam_idx = np.repeat(np.arange(5), n_obs)
        pt_idx = np.tile(np.arange(n_obs), 5)
        Xc = np.einsum("eij,ej->ei", w2c_s[cam_idx, :3, :3],
                       X[pt_idx]) + w2c_s[cam_idx, :3, 3]
        uv = Xc[:, :2] / Xc[:, 2:] * 520.0 + K[:2, 2]
        ba_args = (w2c_s[:5], np.tile(K[None], (5, 1, 1)),
                   X[:n_obs] + 0.04, cam_idx, pt_idx, uv)
        # one call on each device (the mapper's BA calls warmed both up;
        # the call ends in a copy to the host)
        ba_ms = []
        for d in (dev, cpu):
            t0 = time.perf_counter()
            bundle_adjust_np(*ba_args, device=d, iters=BA_TIMED_ITERS)
            ba_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[all] bundle_adjust_np: card {ba_ms[0]:.1f} ms, CPU "
              f"{ba_ms[1]:.1f} ms per call of {BA_TIMED_ITERS} LM steps, 40 "
              f"CG iterations each ({ba_ms[0] / BA_TIMED_ITERS:.1f} / "
              f"{ba_ms[1] / BA_TIMED_ITERS:.1f} ms per LM step; 5 cameras, "
              f"{n_obs} points, {len(cam_idx)} observations; one call each; "
              f"{smi})")
        return launches
    finally:
        ploc.refine_poses_batch = batch
        shutil.rmtree(scene_dir, ignore_errors=True)


def keypoint_share(kp_ref, valid_ref, kp) -> float:
    """The share of the reference's valid keypoints that ``kp`` holds too,
    in any slot, within 1e-3 px (D2-Net's are sub-pixel; the others'
    pixels compare exactly): a keypoint that one device admits and the
    other does not (a near-tie in the NMS or at the top-k cut) moves every
    later slot, so slots are not compared one by one."""
    ref, kp = np.asarray(kp_ref)[valid_ref], np.asarray(kp)
    hits = sum(int((np.abs(part[:, None] - kp[None]).max(-1).min(1)
                    <= 1e-3).sum())
               for part in np.array_split(ref, max(1, len(ref) // 256)))
    return hits / max(len(ref), 1)


def sharp_superglue(path: Path, seed: int) -> None:
    """superglue_outdoor.pth at the official shapes from a seed: PyTorch's
    default init with the residual branches (the keypoint encoder's and
    each layer's last conv) at 0 and final_proj = 256 I, so that SuperGlue
    is a sharp optimal transport of the SuperPoint descriptors and image
    pairs match (at random weights no pair keeps 8 matches)."""
    import torch
    from gs_localization_torch.sfm.superglue import SuperGlueNet

    torch.manual_seed(seed)
    sg = SuperGlueNet("cpu")
    with torch.no_grad():
        for conv in [sg.kenc.encoder[-1]] + [l.mlp[-1]
                                             for l in sg.gnn.layers]:
            conv.weight.zero_()
            conv.bias.zero_()
        sg.final_proj.weight.copy_(256.0 * torch.eye(256)[:, :, None])
        sg.final_proj.bias.zero_()
    torch.save(sg.state_dict(), path)


def sharp_lightglue(path: Path, seed: int) -> None:
    """superpoint_lightglue.pth at the official shapes and names from a
    seed: PyTorch's default init with the residual branches (each block's
    last FFN layer) at 0, ``input_proj`` the identity, the last assignment
    head's ``final_proj`` = 256 I (as ``sharp_superglue``'s) and its
    matchability bias at 10, so that LightGlue is a sharp double softmax of
    the SuperPoint descriptors' cosines (256^2 / 16 = 4,096 per unit) and
    image pairs match: 642 matches of 1,024 keypoints on the scene phase's
    first two views, where random weights keep none and 64 I keeps 2 (a
    CPU run)."""
    import torch
    from gs_localization_torch.sfm.lightglue import (
        DIM, LightGlueNet, lightglue_state_dict)

    torch.manual_seed(seed)
    lg = LightGlueNet("cpu")
    with torch.no_grad():
        for lyr in lg.transformers:
            for blk in (lyr.self_attn, lyr.cross_attn):
                blk.ffn[3].weight.zero_()
                blk.ffn[3].bias.zero_()
        lg.input_proj.weight.copy_(torch.eye(DIM))
        lg.input_proj.bias.zero_()
        head = lg.log_assignment[-1]
        head.final_proj.weight.copy_(256.0 * torch.eye(DIM))
        head.final_proj.bias.zero_()
        head.matchability.weight.zero_()
        head.matchability.bias.fill_(10.0)
    torch.save(lightglue_state_dict(lg), path)


def _grid(radius: int):
    """The offsets of a (2r+1)^2 grid, the centre first, by max-norm."""
    return sorted(((a, b) for a in range(-radius, radius + 1)
                   for b in range(-radius, radius + 1)),
                  key=lambda o: (max(abs(o[0]), abs(o[1])), o))


def sharp_loftr_params(seed: int) -> dict:
    """LoFTR weights at the official shapes, in the JAX package's params
    layout, that reduce the network to census-transform matching, so that
    image pairs match (at PyTorch's default init the scene phase's first two
    views keep none of the 512 slots):

    - conv1 is a 7x7 box blur B (half resolution);
    - layer1 writes B on a 5x5 grid 2 px apart (the fine descriptor) and
      layer2 B on a 7x7 grid 4 px apart (quarter resolution): one tap per
      conv of each block's residual branch; every other residual branch
      is 0, so the blocks pass their input on;
    - layer3's first block computes 128 census comparisons of random pairs
      of the 49 samples and their complements, clamp(50 (B_a - B_b) + 1,
      0, 2) = relu(k d + 1 - relu(k d - 1)) from its shortcut and residual
      branch (the complements make every descriptor's sum 256); the
      coarse features are 2 x these bits;
    - the coarse and fine transformers are identities (norm2 at 0), the
      FPN's coarse-to-fine branch is 0, the fine features are 20 x the
      zero-mean 5x5 grid plus 20 (the offset passes the LeakyReLU and
      cancels in the fine softmax), and ``merge_feat`` passes them on.

    The scale 2 and the gains were chosen on the scene phase's views (640
    x 480 renders of the bench map): 65-96 % of a pair's 512 matches land
    within 4 px of the true correspondence (a CPU run)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    d1, d2, d3 = 128, 196, 256

    def bn(c, beta=0.0):
        return {"gamma": np.ones(c, f32), "beta": np.full(c, beta, f32),
                "mean": np.zeros(c, f32), "var": np.ones(c, f32)}

    def eye(cin, cout, k=1, scale=1.0):
        w = np.zeros((k, k, cin, cout), f32)
        n = min(cin, cout)
        w[k // 2, k // 2, np.arange(n), np.arange(n)] = scale
        return w

    def block(cin, cout, stride=1):
        p = {"conv1": np.zeros((3, 3, cin, cout), f32), "bn1": bn(cout),
             "conv2": np.zeros((3, 3, cout, cout), f32), "bn2": bn(cout)}
        if stride != 1:
            p["down"], p["down_bn"] = eye(cin, cout), bn(cout)
        return p

    def write_grid(first, second, src, ch):
        """Channel ch[o] = channel src shifted by o: max-norm 1 in the
        first block (a conv2 tap), further out in the second (a conv1 tap
        from the max-norm-1 channel towards o, then a conv2 tap)."""
        for o, m in ch.items():
            if o == (0, 0):
                continue
            sign = tuple(int(np.sign(v)) for v in o)
            if max(abs(o[0]), abs(o[1])) == 1:
                first["conv1"][1, 1, src, m] = 1.0
                first["conv2"][1 + o[0], 1 + o[1], m, m] = 1.0
                continue
            s1 = [sg if abs(v) >= 2 else 0 for v, sg in zip(o, sign)]
            s2 = [sg if abs(v) >= 3 else 0 for v, sg in zip(o, sign)]
            second["conv1"][1 + s1[0], 1 + s1[1], ch[sign], m] = 1.0
            second["conv2"][1 + s2[0], 1 + s2[1], m, m] = 1.0

    conv1 = np.zeros((7, 7, 1, d1), f32)
    conv1[:, :, 0, 0] = 1.0 / 49.0
    fine_ch = {o: i for i, o in enumerate(_grid(2))}
    l1 = [block(d1, d1), block(d1, d1)]
    write_grid(l1[0], l1[1], 0, fine_ch)
    coarse_ch = {o: i for i, o in enumerate(_grid(3))}
    l2 = [block(d1, d2, 2), block(d2, d2)]
    l2[0]["down"] = np.zeros((1, 1, d1, d2), f32)
    l2[0]["down"][0, 0, 0, 0] = 1.0
    write_grid(l2[0], l2[1], 0, coarse_ch)
    pairs = list(zip(*np.triu_indices(len(coarse_ch), 1)))
    census = np.zeros((d2, d3), f32)
    for c, i in enumerate(rng.permutation(len(pairs))[:d3 // 2]):
        a, b = pairs[i]
        census[a, c], census[b, c] = 50.0, -50.0
        census[b, d3 // 2 + c], census[a, d3 // 2 + c] = 50.0, -50.0
    l3 = [block(d2, d3, 2), block(d3, d3)]
    l3[0].update(conv2=eye(d3, d3, 3, -1.0), bn1=bn(d3, -1.0),
                 down=census[None, None], down_bn=bn(d3, 1.0))
    l3[0]["conv1"][1, 1] = census
    fine = np.zeros((1, 1, d1, d2), f32)
    n = len(fine_ch)
    fine[0, 0, :n, :n] = 20.0 * (np.eye(n) - 1.0 / n)

    def rnd(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(f32)

    def identity_layer(d):
        return {"q": rnd(d, d), "k": rnd(d, d), "v": rnd(d, d),
                "merge": rnd(d, d), "mlp1": rnd(2 * d, 2 * d),
                "mlp2": rnd(2 * d, d),
                "norm1": {"gamma": np.ones(d, f32),
                          "beta": np.zeros(d, f32)},
                "norm2": {"gamma": np.zeros(d, f32),
                          "beta": np.zeros(d, f32)}}

    merge = np.zeros((2 * d1, d1), f32)
    merge[:d1] = np.eye(d1)
    return {
        "backbone": {
            "conv1": conv1, "bn1": bn(d1), "layer1": l1, "layer2": l2,
            "layer3": l3, "layer3_outconv": eye(d3, d3, 1, 2.0),
            "layer2_outconv": rnd(1, 1, d2, d3),
            "layer2_outconv2_a": rnd(3, 3, d3, d3),
            "layer2_outconv2_bn": bn(d3),
            "layer2_outconv2_b": np.zeros((3, 3, d3, d2), f32),
            "layer1_outconv": fine,
            "layer1_outconv2_a": eye(d2, d2, 3),
            "layer1_outconv2_bn": bn(d2, 20.0),
            "layer1_outconv2_b": eye(d2, d1, 3)},
        "coarse": [identity_layer(256) for _ in range(8)],
        "fine_preprocess": {"down_proj_w": rnd(256, 128),
                            "down_proj_b": np.zeros(128, f32),
                            "merge_w": merge,
                            "merge_b": np.zeros(128, f32)},
        "fine": [identity_layer(128) for _ in range(2)],
    }


def sharp_loftr(path: Path, seed: int) -> None:
    """outdoor_ds.ckpt in the official format (the ``state_dict`` under
    ``matcher.``) with ``sharp_loftr_params``' weights."""
    import torch
    from gs_localization_torch.sfm.loftr import loftr_from_jax_params

    net = loftr_from_jax_params(sharp_loftr_params(seed), "cpu")
    torch.save({"state_dict": {f"matcher.{k}": v.clone() for k, v in
                               net.state_dict().items()}}, path)


def learned_front_end(g, cam, cfg, dev) -> dict:
    """The learned front end on the card (see the module docstring, step
    15). Returns the launch counts of the ``--stage all --weights-dir``
    call."""
    import torch
    import gs_localization_torch as gsl
    from gs_localization_torch.core.camera import quat_to_rotmat
    from gs_localization_torch.data.scene import load_image
    from gs_localization_torch.ops import dpt as dpt_lib
    from gs_localization_torch.ops import midas as midas_lib
    from gs_localization_torch.pipelines import localize as ploc
    from gs_localization_torch.pipelines import run_scene
    from gs_localization_torch.pipelines.sfm_init import SfmInitConfig
    from gs_localization_torch.sfm import weights as wlib
    from gs_localization_torch.sfm.evaluate import pose_errors
    from gs_localization_torch.sfm.features import rgb_to_gray
    from gs_localization_torch.sfm.io import read_pose_results
    from gs_localization_torch.sfm.netvlad import netvlad_descriptor
    from gs_localization_torch.sfm.superglue import superglue_match
    from gs_localization_torch.sfm.superpoint import extract_superpoint

    cpu = torch.device("cpu")
    smi = smi_line()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_learned_",
                                 dir=ROOT / "build"))
    batch = ploc.refine_poses_batch
    estimate = dpt_lib.estimate_depth
    try:
        # the checkpoints: W holds the reference pipeline's four, the
        # MiDaS fallback has a folder of its own
        wdir, mdir = work / "weights", work / "weights_midas"
        wdir.mkdir()
        mdir.mkdir()
        t0 = time.perf_counter()
        for name in ("superpoint", "netvlad", "dpt_hybrid"):
            wlib.write_random(name, str(wdir), seed=0)
        sharp_superglue(wdir / wlib.MANIFEST["superglue_outdoor"].file, 0)
        wlib.write_random("midas_v21", str(mdir), seed=0)
        print(f"[learned] random checkpoints written in "
              f"{time.perf_counter() - t0:.1f} s: "
              f"{sorted(p.name for p in wdir.iterdir())}, "
              f"{sorted(p.name for p in mdir.iterdir())}")
        nets = {}
        for name, d in (("superpoint", wdir), ("superglue_outdoor", wdir),
                        ("netvlad", wdir), ("dpt_hybrid", wdir),
                        ("midas_v21", mdir)):
            path = str(d / wlib.MANIFEST[name].file)
            nets[name] = (wlib.load(name, path, device=dev),
                          wlib.load(name, path, device=cpu))
            print(f"[learned] {name}: {wlib.n_params(nets[name][0]):,} "
                  f"parameters")

        # the layout: the scene phase's views, no sfm files
        root = work / "chess"
        rng_s = np.random.default_rng(13)
        views = [cam] + [perturbed(cam, rng_s, 0.03, 0.1) for _ in
                         range(N_SCENE_TRAIN + N_SCENE_TEST - 1)]
        true_w2c = write_seven_scenes(root, g, views, cfg)
        test_names = list(true_w2c)[N_SCENE_TRAIN:]
        rgb = [load_image(str(root / "seq-01" / f"frame-{k:06d}.color.png"))
               for k in (0, 1)]

        # 1. each network at full width, the card against the CPU
        ms = {}
        sp_g, sp_c = nets["superpoint"]
        gray = [rgb_to_gray(torch.tensor(im)) for im in rgb]
        fc = extract_superpoint(sp_c, gray[0], 4096, 3)
        fg = extract_superpoint(sp_g, gray[0].to(dev), 4096, 3)
        valid = fc.scores.numpy() > 0
        share = keypoint_share(fc.keypoints.numpy(), valid,
                               fg.keypoints.cpu().numpy())
        # the score maps themselves, pixel by pixel (TF32 would move them
        # by ~1e-2 at these peaked logits)
        with torch.no_grad():
            d_sc = float((sp_g(gray[0].to(dev))[0].cpu()
                          - sp_c(gray[0])[0]).abs().max())
        ms["SuperPoint"] = time_ms(
            lambda: extract_superpoint(sp_g, gray[0].to(dev), 4096, 3), 10)
        print(f"[learned] SuperPoint 640x480 (superpoint_aachen: 4,096 "
              f"keypoints, NMS 3): {int(valid.sum())} keypoints; card vs "
              f"CPU: {share:.4f} of the CPU's keypoints also on the card, "
              f"score map max|d| {d_sc:.3e} (tol 1e-5)")
        check(int((fg.scores > 0).sum()) == int(valid.sum()) > 1000
              and share >= 0.99 and d_sc <= 1e-5,
              "SuperPoint differs (card vs CPU)")

        sg_g, sg_c = nets["superglue_outdoor"]
        k = SfmInitConfig().num_keypoints
        feats = [extract_superpoint(sp_c, gr, k, 3) for gr in gray]
        args_c = (*feats[0][:3], *feats[1][:3], W, H, W, H)
        args_g = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                       for a in args_c)
        for iters in (5, 50):
            rc = superglue_match(sg_c, *args_c, sinkhorn_iters=iters)
            rg = superglue_match(sg_g, *args_g, sinkhorn_iters=iters)
            m_c, m_g = rc.matches0.numpy(), rg.matches0.cpu().numpy()
            agree = float(np.mean(m_c == m_g))
            d_ms = float(np.abs(rc.matching_scores0.numpy()
                                - rg.matching_scores0.cpu().numpy()).max())
            ms[f"SuperGlue sinkhorn {iters}"] = time_ms(
                lambda: superglue_match(sg_g, *args_g,
                                        sinkhorn_iters=iters), 10)
            print(f"[learned] SuperGlue {k} x {k} keypoints, sinkhorn "
                  f"{iters}: {int((m_c >= 0).sum())} matches on the CPU; "
                  f"card vs CPU matches0 equal on {agree:.4f} of the rows, "
                  f"matching scores max|d| {d_ms:.3e}")
            check(agree >= 0.99 and (m_c >= 0).sum() > 0,
                  f"SuperGlue sinkhorn {iters} differs (card vs CPU)")

        nv_g, nv_c = nets["netvlad"]
        img_g = torch.tensor(rgb[0], device=dev)
        dc = netvlad_descriptor(nv_c, torch.tensor(rgb[0])).numpy()
        dg = netvlad_descriptor(nv_g, img_g).cpu().numpy()
        d_nv = float(np.abs(dg - dc).max())
        ms["NetVLAD"] = time_ms(lambda: netvlad_descriptor(nv_g, img_g), 10)
        print(f"[learned] NetVLAD 640x480: card vs CPU max|d| {d_nv:.3e} "
              f"(rtol 2e-3, atol 2e-5)")
        check(np.allclose(dg, dc, rtol=2e-3, atol=2e-5),
              "NetVLAD differs (card vs CPU)")

        for label, mod, name in (("DPT_Hybrid", dpt_lib, "dpt_hybrid"),
                                 ("MiDaS v2.1", midas_lib, "midas_v21")):
            net_g, net_c = nets[name]
            ec = mod.estimate_depth(net_c, torch.tensor(rgb[0]), H, W)
            eg = mod.estimate_depth(net_g, img_g, H, W)
            scale = float(ec.abs().max())
            d_e = float((eg.cpu() - ec).abs().max()) / scale
            ms[f"{label} estimate_depth"] = time_ms(
                lambda: mod.estimate_depth(net_g, img_g, H, W), 10)
            print(f"[learned] {label} estimate_depth 480x640 (the net at "
                  f"384x512): card vs CPU max|d| {d_e:.3e} of the output's "
                  f"scale {scale:.4g} (tol 5e-4)")
            check(bool(torch.isfinite(eg).all()) and d_e <= 5e-4,
                  f"{label} differs (card vs CPU)")
        print(f"[learned] ms per call on the card (median of 10 after a "
              f"warm-up; {smi}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
        del nets

        # 2. run_scene --stage all --weights-dir W, the networks on the card
        loc_iters, est_calls = [], []

        def counted(*a, **kw):
            res = batch(*a, **kw)
            loc_iters.extend(res.num_iters)
            return res

        def counted_estimate(*a, **kw):
            est_calls.append(1)
            return estimate(*a, **kw)

        ploc.refine_poses_batch = counted
        dpt_lib.estimate_depth = counted_estimate
        out = root / "output_tpu"
        tee = Tee(sys.stdout, sync=torch.cuda.synchronize)
        torch.cuda.synchronize()
        gsl.reset_launches()
        with contextlib.redirect_stdout(tee):
            done = run_scene.main(["--scene", str(root), "--preset",
                                   "seven_scenes", "--stage", "all",
                                   "--iterations", str(LEARNED_ITERS),
                                   "--weights-dir", str(wdir)])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = dict(gsl.LAUNCHES)
        ploc.refine_poses_batch = batch
        dpt_lib.estimate_depth = estimate
        log = tee.text()
        for line in ("superpoint extractor enabled",
                     "superglue matcher enabled (sinkhorn 5)",
                     "netvlad retrieval enabled",
                     "dpt_hybrid depth prior enabled",
                     "superpoint keypoint masks enabled"):
            check(f"weights: {line}" in log, f"no 'weights: {line}' line")
        methods = query_methods(log)
        poses_file = read_pose_results(str(out / "results_dense.txt"))
        check(sorted(poses_file) == sorted(test_names)
              and sorted(methods) == sorted(test_names),
              f"init poses / methods missing: {methods}")
        # the few-shot branch: 8 train views < 200, so pseudo views, each
        # with one DPT call; the pseudo window scaled to LEARNED_ITERS
        frac = LEARNED_ITERS / 30_000
        window = (max(1, int(2_000 * frac)), max(2, int(29_000 * frac)))
        n_pseudo = len([it for it in range(1, LEARNED_ITERS + 1)
                        if it % 20 == 0 and window[0] < it < window[1]])
        check("few-shot: generated" in log and n_pseudo > 0
              and len(est_calls) == n_pseudo,
              f"{len(est_calls)} DPT calls for {n_pseudo} pseudo steps")
        n_held = min(8, N_SCENE_TEST)
        n_loc = int(sum(loc_iters))
        want = {"stream_fwd": LEARNED_ITERS + 2 * n_pseudo + n_held + n_loc,
                "stream_bwd": LEARNED_ITERS + n_pseudo + n_loc,
                "pregathered_fwd": 0, "pregathered_bwd": 0}
        print(f"[learned] launches {launches}; expected {want} "
              f"({LEARNED_ITERS} steps, {n_pseudo} pseudo steps in "
              f"{window}, {n_held} held-out renders, {n_loc} localize "
              f"iterations)")
        check(blend_launches(launches) == want and n_loc > 0,
              f"--stage all --weights-dir launches {launches} != {want}")
        pose_algebra_launches("[learned]", launches, n_loc)
        on_disk = json.loads((out / "metrics.json").read_text())
        check(all(np.isfinite(v) for v in on_disk.values()),
              f"non-finite metrics {on_disk}")
        mapped, poses = done["sfm"]
        n_pts = int(mapped.valid.sum())
        t_sfm = tee.time_of("=== stage: sfm")
        t_ext = tee.time_of("extracted features for")
        t_match = tee.time_of("matched ")
        t_tri = tee.time_of("depth-corrected;")
        t_pnp = max(tee.time_of(f"{n}: ") for n in test_names)
        t_train = tee.time_of("=== stage: train")
        t_loc = tee.time_of("=== stage: localize")
        print(f"[learned] sfm stage {t_train - t_sfm:.3f} s: loading and "
              f"extraction {t_ext - t_sfm:.3f} s (checkpoints, 8 NetVLAD "
              f"descriptors, retrieval, 8 SuperPoint extractions), matching "
              f"{t_match - t_ext:.3f} s (SuperGlue), triangulation "
              f"{t_tri - t_match:.3f} s, PnP {t_pnp - t_tri:.3f} s, writing "
              f"{t_train - t_pnp:.3f} s; {n_pts} sfm points; methods "
              f"{methods} ({smi})")
        print(f"[learned] train stage {t_loc - t_train:.3f} s "
              f"({(t_loc - t_train) * 1e3 / LEARNED_ITERS:.3f} ms/step, the "
              f"DPT load and {n_pseudo} pseudo steps included); localize "
              f"stage {t_end - t_loc:.3f} s over {n_loc} iterations; "
              f"metrics.json {on_disk}")
        for name in test_names:
            q, t = poses[name]
            gt_w = true_w2c[name]
            e = pose_errors(quat_to_rotmat(torch.tensor(q)).numpy(), t,
                            gt_w[:3, :3], gt_w[:3, 3])
            print(f"[learned] {name}: {methods[name]}, initial error "
                  f"{e[0] * 100:.3f} cm / {e[1]:.4f} deg")

        # 3. the sfm stage on the card machine's CPU, held against the card
        tee_c = Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee_c):
            done_c = run_scene.main(["--scene", str(root), "--stage", "sfm",
                                     "--device", "cpu", "--weights-dir",
                                     str(wdir), "--out",
                                     str(work / "out_cpu")])
        t_cpu = time.perf_counter() - t0
        mapped_c, poses_c = done_c["sfm"]
        shares = [keypoint_share(f_c.keypoints.numpy(),
                                 f_c.scores.numpy() > 0,
                                 f_g.keypoints.cpu().numpy())
                  for f_g, f_c in zip(mapped.features, mapped_c.features)]
        slots = [float(np.mean(np.all(f_g.keypoints.cpu().numpy()
                                      == f_c.keypoints.numpy(), axis=1)))
                 for f_g, f_c in zip(mapped.features, mapped_c.features)]
        n_c = int(mapped_c.valid.sum())
        methods_c = query_methods(tee_c.text())
        pose_d = [pose_errors(quat_to_rotmat(torch.tensor(poses[n][0])
                                             ).numpy(), poses[n][1],
                              quat_to_rotmat(torch.tensor(poses_c[n][0])
                                             ).numpy(), poses_c[n][1])
                  for n in test_names]
        print(f"[learned] sfm card vs CPU ({t_cpu:.1f} s on the CPU): "
              f"the CPU's keypoints also on the card {min(shares):.4f}, in "
              f"the same slot {min(slots):.4f} (worst image); valid points "
              f"{n_pts} vs {n_c}; methods "
              f"{methods == methods_c}; init poses apart at most "
              f"{max(d[0] for d in pose_d) * 100:.4f} cm / "
              f"{max(d[1] for d in pose_d):.5f} deg")
        inl = [{n: int(k) for n, k in re.findall(
            r"^(\S+\.png): \w+ \((\d+) inl\)$", t.text(), re.MULTILINE)}
            for t in (tee, tee_c)]
        print(f"[learned] PnP inliers card {inl[0]}, CPU {inl[1]}")
        check(min(shares) >= 0.99, "keypoints differ (card vs CPU)")
        check(abs(n_pts - n_c) <= 0.02 * n_c, "sfm points differ")
        check(methods == methods_c, f"methods {methods} != {methods_c}")
        check(all(abs(inl[0][n] - inl[1][n]) <= 0.05 * inl[1][n]
                  for n in test_names), "PnP inliers differ by over 5 %")
        # PnP-RANSAC draws its samples by list index from a fixed seed, so
        # a match flipped by a near-tie (2 of 22,366 in the first card
        # run) moves the pose within the RANSAC's noise: 12 px of inlier
        # slack is ~11 cm at 5 m, and other seeds move these init poses by
        # 0.4-7 cm on the same data (a CPU run at 512 keypoints)
        check(all(d[0] <= 0.05 and d[1] <= 1.0 for d in pose_d),
              "init poses differ by more than 5 cm / 1 deg (card vs CPU)")
        return launches
    finally:
        ploc.refine_poses_batch = batch
        dpt_lib.estimate_depth = estimate
        shutil.rmtree(work, ignore_errors=True)


class DuckPCA:
    """sklearn's PCA attributes (as dirtorch checkpoints store the
    whitening under ``pca['Landmarks_clean']``), made from a seed: a
    random orthonormal basis of the descriptor space and decreasing
    variances."""

    def __init__(self, dim: int, seed: int):
        rng = np.random.default_rng(seed)
        q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
        self.mean_ = (0.01 * rng.standard_normal(dim)).astype(np.float32)
        self.components_ = q.T.astype(np.float32)
        self.explained_variance_ = np.linspace(
            2.0, 0.05, dim).astype(np.float32)
        self.whiten = True


def hloc_confs(g, cam, cfg, dev) -> dict:
    """The rest of hloc's learned confs on the card (see the module
    docstring, step 15). Returns the launch counts of its train and two
    localize runs."""
    import torch
    import gs_localization_torch as gsl
    from gs_localization_torch.core.camera import quat_to_rotmat
    from gs_localization_torch.data.scene import load_depth, load_image
    from gs_localization_torch.data.seven_scenes import (
        load_seven_scenes_scene)
    from gs_localization_torch.pipelines import localize as ploc
    from gs_localization_torch.pipelines import run_scene
    from gs_localization_torch.pipelines.sfm_init import (
        SfmInitConfig, build_point_model, localize_query_dense,
        localize_query_pnp)
    from gs_localization_torch.sfm import weights as wlib
    from gs_localization_torch.sfm.d2net import dense_features
    from gs_localization_torch.sfm.dir import load_pca_from_sklearn
    from gs_localization_torch.sfm.disk import unet_forward
    from gs_localization_torch.sfm.evaluate import pose_errors
    from gs_localization_torch.sfm.io import write_pose_results
    from gs_localization_torch.sfm.r2d2 import r2d2_forward
    from gs_localization_torch.sfm.registry import (
        get_dense_matcher, get_extractor, get_global_descriptor, get_matcher)

    cpu = torch.device("cpu")
    smi = smi_line()
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_hloc_",
                                 dir=ROOT / "build"))
    batch = ploc.refine_poses_batch
    try:
        wdir = work / "weights"
        wdir.mkdir()
        t0 = time.perf_counter()
        for name in ("superpoint", "d2net", "r2d2", "disk", "dir", "openibl",
                     "eigenplaces"):
            wlib.write_random(name, str(wdir), seed=0)
        sharp_lightglue(wdir / wlib.MANIFEST["lightglue"].file, 0)
        sharp_loftr(wdir / wlib.MANIFEST["loftr_outdoor"].file, 0)
        nets = {}
        for name in ("superpoint", "lightglue", "loftr_outdoor", "d2net",
                     "r2d2", "disk", "dir", "openibl", "eigenplaces"):
            path = str(wdir / wlib.MANIFEST[name].file)
            nets[name] = (wlib.load(name, path, device=dev),
                          wlib.load(name, path, device=cpu))
        pca = load_pca_from_sklearn(DuckPCA(2048, 0))
        for net in nets["dir"]:
            net.set_pca(pca)
        print(f"[hloc] checkpoints written and loaded on the card and the "
              f"CPU in {time.perf_counter() - t0:.1f} s: "
              + ", ".join(f"{n} {wlib.n_params(v[0]):,}"
                          for n, v in nets.items())
              + " parameters; DIR with a 2,048-component PCA whitening")

        # the layout: the scene phase's views
        root = work / "chess"
        rng_s = np.random.default_rng(13)
        views = [cam] + [perturbed(cam, rng_s, 0.03, 0.1) for _ in
                         range(N_SCENE_TRAIN + N_SCENE_TEST - 1)]
        true_w2c = write_seven_scenes(root, g, views, cfg)
        test_names = list(true_w2c)[N_SCENE_TRAIN:]
        rgb = [load_image(str(root / "seq-01" / f"frame-{k:06d}.color.png"))
               for k in (0, 1)]
        img_c = [torch.tensor(im) for im in rgb]
        img_g = [im.to(dev) for im in img_c]

        # 1. each conf at full width, the card against the CPU
        ms = {}
        for conf, name, dense_fn in (("r2d2", "r2d2", r2d2_forward),
                                     ("d2net-ss", "d2net", dense_features),
                                     ("disk", "disk", unet_forward)):
            net_g, net_c = nets[name]
            ext_g = get_extractor(conf, params=net_g)
            ext_c = get_extractor(conf, params=net_c)
            fc, fg = ext_c(img_c[0]), ext_g(img_g[0])
            valid = fc.scores.numpy() > 0
            share = keypoint_share(fc.keypoints.numpy(), valid,
                                   fg.keypoints.cpu().numpy())
            with torch.no_grad(), gsl.float32_exact():
                oc, og = dense_fn(net_c, img_c[0]), dense_fn(net_g, img_g[0])
            oc, og = (oc, og) if isinstance(oc, tuple) else ((oc,), (og,))
            d_map = max(float((b.cpu() - a).abs().max() / a.abs().max())
                        for a, b in zip(oc, og))
            ms[conf] = time_ms(lambda: ext_g(img_g[0]), 5)
            print(f"[hloc] {conf} 640x480 ({fc.keypoints.shape[0]:,} "
                  f"slots): {int(valid.sum())} keypoints on the CPU, "
                  f"{int((fg.scores > 0).sum())} on the card; {share:.4f} "
                  f"of the CPU's also on the card (within 1e-3 px: "
                  f"D2-Net's are sub-pixel); dense output max|d| "
                  f"{d_map:.3e} of its scale (tol 1e-4)")
            check(valid.sum() > 100 and share >= 0.99 and d_map <= 1e-4
                  and abs(int((fg.scores > 0).sum()) - int(valid.sum()))
                  <= 0.01 * valid.sum(), f"{conf} differs (card vs CPU)")

        sp_g, sp_c = nets["superpoint"]
        ext = [get_extractor("superpoint_max", params=n, num_keypoints=2048)
               for n in (sp_g, sp_c)]
        fg = [ext[0](im) for im in img_g]
        fc = [ext[1](im) for im in img_c]
        mt = [get_matcher("lightglue", params=n) for n in nets["lightglue"]]
        size = (W, H)
        rc = mt[1](fc[0], fc[1], size, size)
        rg = mt[0](*[f._replace(keypoints=f.keypoints.to(dev),
                                scores=f.scores.to(dev),
                                descriptors=f.descriptors.to(dev))
                     for f in fc], size, size)
        m_c, m_g = rc.matches0.numpy(), rg.matches0.cpu().numpy()
        agree = float(np.mean(m_c == m_g))
        d_ms = float(np.abs(rc.matching_scores0.numpy()
                            - rg.matching_scores0.cpu().numpy()).max())
        ms["lightglue"] = time_ms(lambda: mt[0](fg[0], fg[1], size, size), 5)
        print(f"[hloc] lightglue on two 2,048-keypoint superpoint_max sets "
              f"(the CPU's, on both): {int((m_c >= 0).sum())} matches on "
              f"the CPU; card vs CPU matches0 equal on {agree:.4f} of the "
              f"rows, matching scores max|d| {d_ms:.3e}")
        check(agree >= 0.99 and (m_c >= 0).sum() > 100,
              "lightglue differs (card vs CPU)")

        dm = [get_dense_matcher("loftr", params=n)[0]
              for n in nets["loftr_outdoor"]]
        by_cell = []
        for m in dm:
            k0, k1, sc = (a.cpu().numpy() for a in m(rgb[0], rgb[1]))
            by_cell.append({tuple(c): p for c, p, v in zip(k1, k0, sc)
                            if v > 0})
        cells_g, cells_c = by_cell
        common = cells_g.keys() & cells_c.keys()
        share = len(common) / max(len(cells_c), 1)
        d_k0 = max((float(np.abs(cells_g[c] - cells_c[c]).max())
                    for c in common), default=0.0)
        ms["loftr"] = time_ms(lambda: dm[0](rgb[0], rgb[1]), 5)
        print(f"[hloc] loftr on two 640x480 views (512 slots): "
              f"{len(cells_c)} matches on the CPU, {len(cells_g)} on the "
              f"card; {share:.4f} of the CPU's image1 cells also the "
              f"card's, their image0 keypoints max|d| {d_k0:.3e} px")
        check(len(cells_c) > 100 and share >= 0.98 and d_k0 <= 0.05,
              "loftr differs (card vs CPU)")

        for conf in ("dir", "openibl", "eigenplaces"):
            fn = [get_global_descriptor(conf, params=n) for n in nets[conf]]
            dgc = fn[1](img_c[0]).numpy()
            dgg = fn[0](img_g[0]).cpu().numpy()
            d_d = float(np.abs(dgg - dgc).max() / np.abs(dgc).max())
            ms[conf] = time_ms(lambda: fn[0](img_g[0]), 5)
            print(f"[hloc] {conf} 640x480: {dgc.shape[0]}-d; card vs CPU "
                  f"max|d| {d_d:.3e} of the largest entry (tol 1e-4)")
            check(bool(np.isfinite(dgg).all()) and d_d <= 1e-4,
                  f"{conf} differs (card vs CPU)")
        print(f"[hloc] ms per call on the card (median of 5 after a "
              f"warm-up; {smi}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))

        # 2. the sparse and dense front ends through the sfm stage's entry
        # points, on the card and again on the CPU
        run_scene.main(["--scene", str(root), "--stage", "prepare"])
        scene = load_seven_scenes_scene(str(root), model_dir="sparse_dslam/0",
                                        device=dev)
        imgs = [load_image(c.image_path) for c in scene.train_cameras]
        deps = [load_depth(c.depth_path) for c in scene.train_cameras]
        train_cams = [c.camera for c in scene.train_cameras]
        queries = [(q.name, load_image(q.image_path), np.array(
            [[float(q.camera.fx), 0, float(q.camera.cx)],
             [0, float(q.camera.fy), float(q.camera.cy)], [0, 0, 1.0]]))
            for q in scene.test_cameras]
        icfg = SfmInitConfig(match_window=HLOC_WINDOW,
                             retrieval_k=HLOC_RETRIEVAL)

        def sparse(k):
            """superpoint_max + lightglue + dir on net k (0 card, 1 CPU)."""
            on = (dev, cpu)[k]
            extractor = get_extractor("superpoint_max",
                                      params=nets["superpoint"][k],
                                      num_keypoints=icfg.num_keypoints)
            lg = get_matcher("lightglue", params=nets["lightglue"][k])
            gdesc = get_global_descriptor("dir", params=nets["dir"][k])
            fs = (W, H)

            def matcher(f0, f1):
                return lg(f0, f1, fs, fs)

            t0 = time.perf_counter()
            mapped = build_point_model(
                imgs, train_cams, icfg, depth_maps=deps, extractor=extractor,
                sparse_matcher=matcher, global_desc_fn=gdesc, device=on)
            t1 = time.perf_counter()
            res = {n: localize_query_pnp(
                im, K, mapped, train_cams, icfg, extractor=extractor,
                sparse_matcher=matcher, global_desc_fn=gdesc, device=on)
                for n, im, K in queries}
            return mapped, res, (t1 - t0, time.perf_counter() - t1)

        def dense(k):
            """loftr + eigenplaces on net k (0 card, 1 CPU)."""
            on = (dev, cpu)[k]
            matcher, dcfg = get_dense_matcher(
                "loftr", params=nets["loftr_outdoor"][k])
            gdesc = get_global_descriptor("eigenplaces",
                                          params=nets["eigenplaces"][k])
            dense_cfg = dataclasses.replace(
                icfg, dense_max_error=dcfg["max_error"],
                dense_cell_size=dcfg["cell_size"])
            t0 = time.perf_counter()
            mapped = build_point_model(
                imgs, train_cams, dense_cfg, depth_maps=deps,
                global_desc_fn=gdesc, dense_matcher=matcher, device=on)
            t1 = time.perf_counter()
            res = {n: localize_query_dense(
                im, K, mapped, train_cams, matcher, imgs, dense_cfg,
                global_desc_fn=gdesc, device=on) for n, im, K in queries}
            return mapped, res, (t1 - t0, time.perf_counter() - t1)

        def write_sfm(out: Path, mapped, res) -> None:
            """The sfm stage's two files, as ``stage_sfm`` writes them."""
            out.mkdir(parents=True, exist_ok=True)
            write_pose_results(str(out / "results_dense.txt"),
                               {n: (q, t) for n, (q, t, _) in res.items()})
            ok = np.asarray(mapped.valid)
            np.savez(out / "sfm_points.npz",
                     points=np.asarray(mapped.points)[ok].astype(np.float32),
                     colors=np.asarray(mapped.track_colors)[ok].astype(
                         np.float32))

        def report(label, mapped, res, times):
            n_pts = int(mapped.valid.sum())
            errs = {}
            for n, (q, t, info) in res.items():
                gt_w = true_w2c[n]
                errs[n] = pose_errors(quat_to_rotmat(torch.tensor(q)).numpy(),
                                      t, gt_w[:3, :3], gt_w[:3, 3])
            print(f"[hloc] {label}: point model {times[0]:.3f} s "
                  f"({n_pts} points), {len(res)} queries {times[1]:.3f} s; "
                  + "; ".join(f"{n}: {info['method']} "
                              f"({info.get('num_inliers', 0)} inl), "
                              f"{errs[n][0] * 100:.2f} cm / "
                              f"{errs[n][1]:.3f} deg"
                              for n, (_, _, info) in res.items()))
            return n_pts

        runs = {}
        for label, fn in (("sparse", sparse), ("dense", dense)):
            runs[label] = (fn(0), fn(1))
            report(f"{label} front end, card", *runs[label][0])
            report(f"{label} front end, CPU", *runs[label][1])
        out_s, out_d = root / "output_tpu", root / "output_dense"
        write_sfm(out_s, *runs["sparse"][0][:2])
        write_sfm(out_d, *runs["dense"][0][:2])

        # 3. train on the sparse front end's points, localize from both
        # front ends' initial poses (K1/K2)
        loc_iters = []

        def counted(*a, **kw):
            res = batch(*a, **kw)
            loc_iters.extend(res.num_iters)
            return res

        ploc.refine_poses_batch = counted
        tee = Tee(sys.stdout, sync=torch.cuda.synchronize)
        map_path = out_s / f"gs_map/iteration_{HLOC_ITERS}/point_cloud.ply"
        torch.cuda.synchronize()
        gsl.reset_launches()
        with contextlib.redirect_stdout(tee):
            run_scene.main(["--scene", str(root), "--stage", "train",
                            "--iterations", str(HLOC_ITERS)])
            _, met_s = run_scene.main([
                "--scene", str(root), "--stage", "localize",
                "--iterations", str(HLOC_ITERS)])["localize"]
            _, met_d = run_scene.main([
                "--scene", str(root), "--stage", "localize",
                "--map", str(map_path), "--out", str(out_d)])["localize"]
        torch.cuda.synchronize()
        launches = dict(gsl.LAUNCHES)
        ploc.refine_poses_batch = batch
        n_held = min(8, N_SCENE_TEST)
        n_loc = int(sum(loc_iters))
        want = {"stream_fwd": HLOC_ITERS + n_held + n_loc,
                "stream_bwd": HLOC_ITERS + n_loc,
                "pregathered_fwd": 0, "pregathered_bwd": 0}
        log = tee.text()
        n_init = re.findall(r"initialized from (\d+) sfm points", log)
        print(f"[hloc] train from {n_init} sfm points, then localize from "
              f"the sparse and the dense initial poses: launches "
              f"{launches}; expected {want} ({HLOC_ITERS} steps, {n_held} "
              f"held-out renders, {n_loc} localize iterations); metrics "
              f"sparse {met_s}, dense {met_d}")
        check(len(n_init) == 1, "train did not start from the sparse front "
              "end's points")
        check(blend_launches(launches) == want and n_loc > 0,
              f"hloc launches {launches} != {want}")
        pose_algebra_launches("[hloc]", launches, n_loc)
        for out in (out_s, out_d):
            on_disk = json.loads((out / "metrics.json").read_text())
            check(all(np.isfinite(v) for v in on_disk.values()),
                  f"non-finite metrics {on_disk}")

        # 4. the card against the CPU: points, methods, initial poses
        for label, ((m_g, r_g, _), (m_c, r_c, _)) in runs.items():
            n_g, n_c = int(m_g.valid.sum()), int(m_c.valid.sum())
            meth_g = {n: i["method"] for n, (_, _, i) in r_g.items()}
            meth_c = {n: i["method"] for n, (_, _, i) in r_c.items()}
            pose_d = [pose_errors(
                quat_to_rotmat(torch.tensor(r_g[n][0])).numpy(), r_g[n][1],
                quat_to_rotmat(torch.tensor(r_c[n][0])).numpy(), r_c[n][1])
                for n in test_names]
            print(f"[hloc] {label} sfm card vs CPU: valid points {n_g} vs "
                  f"{n_c}; methods equal {meth_g == meth_c}; init poses "
                  f"apart at most {max(d[0] for d in pose_d) * 100:.4f} cm / "
                  f"{max(d[1] for d in pose_d):.5f} deg")
            check(n_c > 0 and abs(n_g - n_c) <= 0.02 * n_c,
                  f"{label} sfm points differ")
            check(meth_g == meth_c, f"{label} methods {meth_g} != {meth_c}")
            check(all(d[0] <= 0.05 and d[1] <= 1.0 for d in pose_d),
                  f"{label} init poses differ by more than 5 cm / 1 deg")
        print(f"[hloc] phase time {time.perf_counter() - t_phase:.1f} s")
        return launches
    finally:
        ploc.refine_poses_batch = batch
        shutil.rmtree(work, ignore_errors=True)


def touched_case(seed: int, n: int, spread: float, device):
    """The scenes of ``tests/test_torch_cuda.py``'s n_touched test (its
    ``_scene`` draws at SH degree 2) and its 96x64 camera."""
    from gs_localization_torch.core import sh as sh_lib
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.core.gaussians import GaussianParams

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
    arrays = {"xyz": xyz, "features_dc": fdc, "features_rest": frest,
              "scaling": scaling, "rotation": rot,
              "opacity": rng.uniform(-1.0, 3.0, (n, 1)),
              "live": np.ones(n, bool)}
    fx = 96 / (2.0 * np.tan(0.5))
    return (GaussianParams.from_numpy(arrays, 2, 2, device=device),
            Camera.from_rt(np.eye(3), np.zeros(3), fx, fx, 96, 64,
                           device=device))


def f32_ulps(a, b) -> int:
    """Distance between two float32 values in units in the last place (the
    count of float32 values between them)."""
    def ordered(x):
        i = int(np.array(x, np.float32).view(np.int32))
        return i if i >= 0 else -(i & 0x7FFFFFFF)

    return abs(ordered(a) - ordered(b))


def touched_walk(prep, bins, grid_x: int, grid_y: int, chunk: int):
    """``blend.count_touched``'s walk written out again with the same ops
    at the same shapes, so that each pixel decision's deciding value can be
    read: yields per chunk (gid, mask, power, alpha before its gate,
    inclusive log T, hit), each (T, chunk[, npix])."""
    import torch
    from gs_localization_torch.raster.blend import tile_pixel_coords
    from gs_localization_torch.raster.constants import (
        ALPHA_MAX, ALPHA_MIN, LOG_T_EPS)

    num_tiles, max_per_tile = bins.tile_gid.shape
    pix = tile_pixel_coords(grid_x, grid_y, 16, prep.means2d.device)[:, None]
    log_t_full = torch.zeros((num_tiles, 256), dtype=torch.float32,
                             device=prep.means2d.device)
    for lo in range(0, max_per_tile, chunk):
        gid = bins.tile_gid[:, lo:lo + chunk].long()
        mask = bins.tile_mask[:, lo:lo + chunk]
        opa = torch.where(mask, prep.opacity[gid],
                          torch.zeros_like(prep.opacity[gid]))
        xy, conic = prep.means2d[gid][:, :, None, :], prep.conic[gid][:, :, None, :]
        dx, dy = xy[..., 0] - pix[..., 0], xy[..., 1] - pix[..., 1]
        power = (-0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy)
                 - conic[..., 1] * dx * dy)
        raw = torch.clamp_max(opa[:, :, None] * torch.exp(
            torch.clamp_max(power, 0.0)), ALPHA_MAX)
        alpha = torch.where((power > 0.0) | (raw < ALPHA_MIN),
                            torch.zeros_like(raw), raw)
        la = torch.log1p(-alpha)
        clog = log_t_full[:, None, :] + torch.cumsum(la, dim=1)
        yield gid, mask, power, raw, clog, (alpha > 0.0) & (clog >= LOG_T_EPS)
        log_t_full = log_t_full + la.sum(dim=1)


def touched_margins(label, devices, cfg, max_rows: int = 12) -> None:
    """``count_touched`` on the card and on the CPU; where counts differ,
    ``touched_walk`` in lockstep on both (its counts held equal to
    ``count_touched``'s) gives each differing pixel decision of those
    Gaussians, its deciding value and that value's margin from the
    threshold it crossed, in float32 ULPs: alpha against 1/255 (or power
    against 0), else the inclusive log T against log(1e-4). ``devices``
    holds (map, camera) on the card, then on the CPU."""
    import torch
    from gs_localization_torch.raster import blend
    from gs_localization_torch.raster.constants import ALPHA_MIN, LOG_T_EPS
    from gs_localization_torch.raster.preprocess import preprocess
    from gs_localization_torch.raster.rasterize import bins_for

    runs = []
    for g_, c_ in devices:
        with torch.no_grad():
            prep = preprocess(g_, c_, tile_size=16)
            bins = bins_for(prep, c_, cfg.replace(use_stream=False))
        check(not bool(bins.tile_overflow), f"n_touched {label}: tile overflow")
        grid = (-(-c_.width // 16), -(-c_.height // 16))
        counts = blend.count_touched(
            bins.tile_gid, bins.tile_mask, prep.means2d, prep.conic,
            prep.opacity, g_.capacity, *grid, 16, cfg.chunk)
        runs.append((prep, bins, grid, counts.cpu().long()))
    (_, bins_k, _, cnt_k), (_, bins_p, _, cnt_p) = runs
    same_bins = (torch.equal(bins_k.tile_gid.cpu(), bins_p.tile_gid)
                 and torch.equal(bins_k.tile_mask.cpu(), bins_p.tile_mask))
    d = (cnt_k - cnt_p).abs()
    diff = set(torch.nonzero(d).flatten().tolist())
    print(f"n_touched {label} card vs CPU: {len(diff)} of {len(d)} Gaussians "
          f"differ (max |d| {int(d.max())} px; bins "
          f"{'equal' if same_bins else 'DIFFER'})")
    if not diff:
        return
    walked = [torch.zeros_like(cnt_p) for _ in range(2)]
    entries = []
    for ck, cp in zip(*(touched_walk(p_, b_, *gr, cfg.chunk)
                        for p_, b_, gr, _ in runs)):
        ck = [x.cpu() for x in ck]
        for w, (gid, mask, _, _, _, hit) in zip(walked, (ck, cp)):
            w.index_add_(0, gid.reshape(-1), (hit.sum(-1) * mask).reshape(-1))
        gid, mask = cp[0], cp[1]
        sel = (ck[5] != cp[5]) & mask[..., None]
        for t, sl, px in sel.nonzero().tolist():
            if int(gid[t, sl]) not in diff:
                continue
            (pk, ak, lk), (pp, ap, lp) = [
                tuple(float(c[i][t, sl, px]) for i in (2, 3, 4))
                for c in (ck, cp)]
            gate_k = pk <= 0.0 and np.float32(ak) >= np.float32(ALPHA_MIN)
            gate_p = pp <= 0.0 and np.float32(ap) >= np.float32(ALPHA_MIN)
            if gate_k != gate_p and (pk > 0.0) != (pp > 0.0):
                what, vk, vp, thr = "power vs 0", pk, pp, 0.0
            elif gate_k != gate_p:
                what, vk, vp, thr = "alpha vs 1/255", ak, ap, ALPHA_MIN
            else:
                what, vk, vp, thr = "log T vs log(1e-4)", lk, lp, LOG_T_EPS
            entries.append((int(gid[t, sl]), t, sl, px, what, vk, vp,
                            f32_ulps(vk, thr), f32_ulps(vp, thr),
                            f32_ulps(vk, vp), bool(ck[5][t, sl, px])))
    check(torch.equal(walked[0], cnt_k) and torch.equal(walked[1], cnt_p),
          f"n_touched {label}: the walk does not count as count_touched")
    margin = max([max(e[7], e[8]) for e in entries], default=0)
    print(f"n_touched {label}: {len(entries)} pixel decisions differ on "
          f"those Gaussians; largest margin from the threshold crossed "
          f"{margin} float32 ULPs")
    for gid_, t, sl, px, what, vk, vp, uk, up, apart, hit in \
            entries[:max_rows]:
        print(f"n_touched {label}:   gaussian {gid_} tile {t} slot {sl} "
              f"pixel {px}: {what}: card {vk:.9g} ({uk} ULPs, "
              f"{'hit' if hit else 'miss'}), CPU {vp:.9g} ({up} ULPs), "
              f"{apart} ULPs apart")


def launches_delta(before: dict) -> dict:
    """The launch counters' increase since ``before``."""
    import gs_localization_torch as gsl

    return {k: gsl.LAUNCHES[k] - before[k] for k in before}


def add_launches(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in set(total) | set(more)}


def md_worker(rank: int, init: str, out: str, max_per_tile: int) -> None:
    """One of two ranks that share cuda:0 over gloo (``--md-rank``): the
    bench scene rendered tile-sharded (the 30 tile rows over 2 ranks) and
    Gaussian-sharded (100,000 / 2), written to ``out`` with the rank's
    K3/K4 launches."""
    import torch
    import gs_localization_torch as gsl
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.parallel import dp, gauss_shard, runtime
    from gs_localization_torch.parallel.tile_shard import (
        rasterize_tile_sharded)
    from gs_localization_torch.raster import RasterizerConfig

    runtime.initialize_runtime(init, 2, rank, backend="gloo")
    dev = torch.device("cuda", 0)
    g = bench_scene(dev)
    cam = Camera.from_rt(np.eye(3), np.zeros(3), 520.0, 520.0, W, H,
                         device=dev)
    cfg = RasterizerConfig(max_pairs=MAX_PAIRS, max_per_tile=max_per_tile,
                           fast_k=1, pallas_chunk=CHUNK, use_stream=False)
    gsl.reset_launches()
    with torch.no_grad():
        t = rasterize_tile_sharded(dp.make_mesh(2, axis="tile"), g, cam, cfg)
        gmesh = dp.make_mesh(2, axis="gauss")
        color, depth, alpha, radii = gauss_shard.rasterize_gauss_sharded(
            gmesh, gauss_shard.shard_rows(g, gmesh), cam, cfg)
    torch.cuda.synchronize()
    np.savez(Path(out) / f"md_r{rank}.npz", tile_color=t.color.cpu().numpy(),
             tile_depth=t.depth.cpu().numpy(),
             tile_overflow=bool(t.tile_overflow),
             gauss_color=color.cpu().numpy(), gauss_depth=depth.cpu().numpy(),
             gauss_alpha=alpha.cpu().numpy(), radii=radii.cpu().numpy(),
             launches=json.dumps(gsl.LAUNCHES))
    runtime.shutdown_runtime()


def hold_blend_tiles(g, cam, md_cfg) -> float:
    """``blend_tiles`` on the card at the tile-sharded path's two ranks'
    slices of the bench render (tile0 = 0 and num_tiles / 2: the gathered
    windows, K3/K4 with the run's first tile) against K3/K4's plain
    versions at the same tile0 on the same windows: the images with
    check_forward, and the autograd gradients of a seeded loss in every
    blend input with check_backward (each input's gradient divided by its
    largest |plain| value, as TOL_LAYOUT_GRAD). Returns the forward's max
    abs error."""
    import torch
    from gs_localization_torch.raster import binning
    from gs_localization_torch.raster import blend as tblend
    from gs_localization_torch.raster import pallas_blend as pb
    from gs_localization_torch.raster.preprocess import preprocess

    ts = md_cfg.tile_size
    grid_x, grid_y = -(-cam.width // ts), -(-cam.height // ts)
    with torch.no_grad():
        prep = preprocess(g, cam, tile_size=ts,
                          scale_modifier=md_cfg.scale_modifier)
        bins = binning.bin_gaussians(
            prep, grid_x, grid_y, md_cfg.max_pairs, md_cfg.max_per_tile,
            tile_size=ts, tile_cull=md_cfg.tile_cull)
    check(not bool(bins.tile_overflow), "blend_tiles: tile_overflow")
    fields = [x.detach().clone().requires_grad_() for x in (
        prep.means2d, prep.conic, prep.rgb, prep.opacity, prep.depths)]
    names = ("means2d", "conic", "rgb", "opacity", "depths")
    pix = tblend.tile_pixel_coords(grid_x, grid_y, ts, cam.device)
    per = grid_x * grid_y // 2
    err = 0.0
    for lo in (0, per):
        gid, mask = bins.tile_gid[lo:lo + per], bins.tile_mask[lo:lo + per]
        out = tblend.blend_tiles(gid, mask, *fields, grid_x, grid_y, ts,
                                 chunk=md_cfg.chunk, pix=pix[lo:lo + per],
                                 pallas_chunk=md_cfg.pallas_chunk)
        geom, rgbd = pb.gather_windows(gid, *fields)
        counts = mask.sum(dim=1, dtype=torch.int32)
        chunk = min(md_cfg.pallas_chunk, geom.shape[2])
        with torch.no_grad():
            out_p = pb.pregathered_blend_fwd_plain(
                counts, geom, rgbd, grid_x, ts, chunk, tile0=lo)
        acc_k = torch.cat([out.color.transpose(1, 2), out.depth[:, None]], 1)
        label = f"blend_tiles tile0 {lo}"
        e_f, flip = check_forward(
            label, f"blend_tiles on the card (K3, {per} tiles)",
            (acc_k.detach(), out.log_t.detach()[..., None], None), out_p,
            float(rgbd.detach().abs().max()))
        err = max(err, e_f)

        def bwd(gacc, glogt):
            """[(card, plain)] gradients of <gacc, accum> + <glogt, log_t>
            in each blend input, each divided by its largest |plain|."""
            got = torch.autograd.grad(
                (out.color, out.depth, out.log_t), fields,
                (gacc[:, :3].transpose(1, 2), gacc[:, 3], glogt[..., 0]),
                retain_graph=True)
            dgeom, drgbd = pb.pregathered_blend_bwd_plain(
                counts, geom.detach(), rgbd.detach(), gacc, glogt, grid_x,
                ts, chunk, tile0=lo)
            want = torch.autograd.grad((geom, rgbd), fields, (dgeom, drgbd),
                                       retain_graph=True)
            pairs = []
            for name, k, p in zip(names, got, want):
                scale = float(p.abs().max())
                check(scale > 0, f"{label}: no plain gradient in {name}")
                pairs.append((k.reshape(k.shape[0], -1) / scale,
                              p.reshape(p.shape[0], -1) / scale))
            return pairs

        ga, gl = cotangents(out_p[0], out_p[1], seed=9 + lo)
        check_backward(label, "blend_tiles on the card (K4) in means2d, "
                       "conic, rgb, opacity, depths", bwd, ga, gl, flip)
    return err


def multi_device(g, cam, cfg, md_cfg, queries, tcfg, dev):
    """The multi-device layer at full width on the one card: a world-size-1
    NCCL group runs dp_train_grads, shard_queries_refine,
    rasterize_tile_sharded, rasterize_gauss_sharded and
    gauss_sharded_loss_and_grads, each against the unsharded port; two
    processes sharing cuda:0 over gloo run the dryrun's checks and the
    tile- and Gaussian-sharded renders of the bench scene against the
    unsharded render, started once the NCCL group's timings are taken and
    run alongside the rest of the phase; blend_tiles on the card is held
    against its plain version at the two ranks' slices. Returns the K1-K4
    launches of the sharded calls (their unsharded references and the
    plain comparisons not counted) and blend_tiles' forward error."""
    import torch
    import torch.distributed as dist
    import gs_localization_torch as gsl
    from gs_localization_torch.loc import refine_poses_batch
    from gs_localization_torch.mapping import losses as mlosses
    from gs_localization_torch.parallel import dp, dryrun, gauss_shard, runtime
    from gs_localization_torch.parallel.tile_shard import (
        rasterize_tile_sharded)
    from gs_localization_torch.raster import rasterize

    smi = smi_line()
    launches = {k: 0 for k in gsl.LAUNCHES}
    with torch.no_grad():
        ref = rasterize(g, cam, md_cfg)
    check(not bool(ref.overflow) and not bool(ref.tile_overflow),
          "multi-device: the bench render overflows")
    gt = ref.color

    def sharded(fn):
        """fn() with its launches added to the phase's count."""
        nonlocal launches
        torch.cuda.synchronize()
        before = dict(gsl.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        launches = add_launches(launches, launches_delta(before))
        return out

    def mean_grads(gg, cams, imgs, c):
        """The unsharded reference: the mean loss and gradients."""
        ls, gs = [], []
        for cm, im in zip(cams, imgs):
            p = {k: getattr(gg, k).detach().requires_grad_() for k in TRAINABLE}
            loss = mlosses.training_loss(rasterize(gg.replace(**p), cm,
                                                   c).color, im)[0]
            ls.append(loss.detach())
            gs.append(torch.autograd.grad(loss, [p[k] for k in TRAINABLE]))
        return (sum(ls) / len(ls),
                {k: sum(x[i] for x in gs) / len(gs)
                 for i, k in enumerate(TRAINABLE)})

    def held(label, got, want):
        """One rank's sharded call runs the unsharded code with identity
        collectives: the same bits are expected, held to TOL_SAME."""
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        print(f"[multi-device] {label}: max|d| {err:.3e} against the "
              f"unsharded port (tol {TOL_SAME})")
        check(err <= TOL_SAME, f"multi-device: {label} disagrees with the "
                               "unsharded port")

    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_md_", dir=ROOT / "build"))
    procs = []
    try:
        dist.init_process_group(
            "nccl", init_method=runtime.local_rendezvous(out_dir),
            world_size=1, rank=0)
        try:
            mesh = dp.make_mesh()
            cams2 = [q.camera for q in queries[:2]]
            imgs2 = torch.stack([gt, gt])
            loss, grads = sharded(lambda: dp.dp_train_grads(mesh, g, cams2,
                                                            imgs2, cfg))
            ms_dp = time_ms(lambda: dp.dp_train_grads(mesh, g, cams2, imgs2,
                                                      cfg), 5)
            ref_l, ref_g = mean_grads(g, cams2, imgs2, cfg)
            held("dp_train_grads (2 cameras, stream layout): loss and "
                 "gradients", [loss] + [grads[k] for k in TRAINABLE],
                 [ref_l] + [ref_g[k] for k in TRAINABLE])

            n_q = len(queries)
            imgs_q = torch.stack([gt] * n_q)
            deps_q = torch.stack([ref.depth] * n_q)
            masks_q = torch.ones(imgs_q.shape[:3], dtype=torch.bool,
                                 device=dev)
            cams_q = [q.camera for q in queries]
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            res = sharded(lambda: dp.shard_queries_refine(
                mesh, g, cams_q, imgs_q, masks_q, tcfg, cfg,
                gt_depths=deps_q))
            ev1.record()
            ev1.synchronize()
            ms_iter = ev0.elapsed_time(ev1) / (n_q * tcfg.num_iters)

            # the timings are taken: start the two gloo ranks' full-width
            # renders (chip_smoke.py --md-rank) and the dryrun, which run
            # on the card alongside the rest of the phase
            t0 = time.perf_counter()
            init = runtime.local_rendezvous(out_dir)
            procs = dryrun.start_ranks(
                [[sys.executable, str(ROOT / "chip_smoke.py"), "--md-rank",
                  str(k), "--md-init", init, "--md-out", str(out_dir),
                  "--md-max-per-tile", str(md_cfg.max_per_tile)]
                 for k in range(2)]
                + [[sys.executable, "-m",
                    "gs_localization_torch.parallel.dryrun", "--nproc", "2",
                    "--device", "cuda"]], out_dir, cwd=ROOT)

            unsh = refine_poses_batch(g, cams_q, imgs_q, masks_q, tcfg, cfg,
                                      gt_depths=deps_q)
            check(res.num_iters == unsh.num_iters,
                  f"multi-device: iterations {res.num_iters} != "
                  f"{unsh.num_iters}")
            held(f"shard_queries_refine ({n_q} queries, {tcfg.num_iters} "
                 "iterations, pose mode): poses", [res.w2c, res.exposure_ab],
                 [unsh.w2c, unsh.exposure_ab])

            tmesh = dp.make_mesh(axis="tile")
            out_t = sharded(lambda: rasterize_tile_sharded(tmesh, g, cam,
                                                           md_cfg))
            held("rasterize_tile_sharded: images", [out_t.color, out_t.depth,
                                                    out_t.alpha],
                 [ref.color, ref.depth, ref.alpha])
            check(not bool(out_t.tile_overflow), "tile_overflow")
            p = {k: getattr(g, k).detach().requires_grad_()
                 for k in TRAINABLE}
            tau = torch.zeros(6, device=dev, requires_grad=True)
            with torch.no_grad():          # a target the render at cam misses
                target = rasterize(g, queries[0].camera, md_cfg).color

            def tile_grads(render):
                o = render(g.replace(**p), cam.with_delta(tau))
                loss = mlosses.training_loss(o.color, target)[0]
                return torch.autograd.grad(loss, [p[k] for k in TRAINABLE]
                                           + [tau])

            g_t = sharded(lambda: tile_grads(
                lambda gg, c: rasterize_tile_sharded(tmesh, gg, c, md_cfg)))
            g_r = tile_grads(lambda gg, c: rasterize(gg, c, md_cfg))
            held("rasterize_tile_sharded: gradients in the Gaussians and "
                 "tau", g_t, g_r)

            gmesh = dp.make_mesh(axis="gauss")
            color, depth, alpha, radii = sharded(
                lambda: gauss_shard.rasterize_gauss_sharded(
                    gmesh, gauss_shard.shard_rows(g, gmesh), cam, md_cfg))
            held("rasterize_gauss_sharded: images and radii",
                 [color, depth, alpha, radii.float()],
                 [ref.color, ref.depth, ref.alpha, ref.radii.float()])
            mesh2 = gauss_shard.make_mesh_2d(1, 1)
            loss2, grads2 = sharded(
                lambda: gauss_shard.gauss_sharded_loss_and_grads(
                    mesh2, gauss_shard.shard_rows(g, mesh2), cams2, imgs2,
                    md_cfg))
            ref_l2, ref_g2 = mean_grads(g, cams2, imgs2, md_cfg)
            held("gauss_sharded_loss_and_grads (a 1 x 1 data x gauss mesh, 2 "
                 "cameras): loss and gradients",
                 [loss2] + [grads2[k] for k in TRAINABLE],
                 [ref_l2] + [ref_g2[k] for k in TRAINABLE])
        finally:
            runtime.shutdown_runtime()
        print(f"[multi-device] one NCCL rank on {smi}: {ms_iter:.3f} ms per "
              f"refinement iteration per rank (shard_queries_refine, {n_q} "
              f"queries x {tcfg.num_iters}), {ms_dp:.3f} ms per DP step (2 "
              "cameras, median of 5); the ranks share one card, and no NCCL "
              "run across cards was measured (the machine has one card)")
        print(f"[multi-device] NCCL rank launches {launches}")

        # blend_tiles on the card against its plain version, at the
        # tile-sharded path's slices
        e_f = hold_blend_tiles(g, cam, md_cfg)

        # ---- the two gloo ranks and the dryrun, started above ----------
        results = dryrun.wait_ranks(procs, 600)
        dry_rc, dry_log = results[2]
        print(dry_log.strip())
        check(dry_rc == 0 and "ALL OK (2 processes, gloo, cuda)" in dry_log
              and all(rc == 0 for rc, _ in results[:2]),
              "multi-device: the 2-rank dryrun or a gloo rank on cuda:0 "
              "failed (the dryrun is rank 2 here):\n"
              + dryrun.rank_tails(results))
        print(f"[multi-device] the 2-rank gloo dryrun and the 2 gloo ranks' "
              f"renders on cuda:0, started with the NCCL checks and the "
              f"blend_tiles check still to run: {time.perf_counter() - t0:.1f}"
              " s from their start to the end of the last")
        ranks = [np.load(out_dir / f"md_r{k}.npz") for k in range(2)]
        want = {k: v.cpu().numpy() for k, v in (
            ("color", ref.color), ("depth", ref.depth), ("alpha", ref.alpha))}
        for k in range(2):
            for name in ("color", "depth"):
                check(np.array_equal(ranks[k][f"tile_{name}"], want[name]),
                      f"multi-device: rank {k}'s tile-sharded {name}")
            for name in ("color", "depth", "alpha"):
                check(np.array_equal(ranks[k][f"gauss_{name}"], want[name]),
                      f"multi-device: rank {k}'s Gaussian-sharded {name}")
            check(not bool(ranks[k]["tile_overflow"]), "tile_overflow")
        radii = np.concatenate([ranks[k]["radii"] for k in range(2)])
        check(np.array_equal(radii, ref.radii.cpu().numpy()),
              "multi-device: the Gaussian-sharded radii")
        gloo_launches = {}
        for k in range(2):
            gloo_launches = add_launches(
                gloo_launches, json.loads(str(ranks[k]["launches"])))
        print(f"[multi-device] 2 gloo ranks on cuda:0: the tile-sharded "
              f"render (30 tile rows, 15 a rank) and the Gaussian-sharded "
              f"render ({N_GAUSS} / 2) equal the unsharded render bit for "
              f"bit, tile_overflow false; K1-K4 launches of both ranks "
              f"{gloo_launches}")
    finally:
        for pr in procs:          # a rank left waiting on a failed peer
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    return add_launches(launches, gloo_launches), e_f


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
    from gs_localization_torch.data.scene import (
        CameraInfo, SceneInfo, compute_scene_extent)
    from gs_localization_torch.loc import TrackingConfig
    from gs_localization_torch.mapping import losses as mlosses
    from gs_localization_torch.mapping import train as mtrain
    from gs_localization_torch.pipelines.localize import (
        LocalizePipelineConfig, QuerySpec, load_map)
    from gs_localization_torch.pipelines.train_map import (
        TrainPipelineConfig, train_map)
    from gs_localization_torch.raster import RasterizerConfig, rasterize
    from gs_localization_torch.raster import pallas_blend as pb
    from gs_localization_torch.raster import stream_blend as sb
    from gs_localization_torch.raster.pose_mode import (
        _project_pairs, _project_stream, build_pair_pack,
        build_stream_pair_pack, render_pose_mode)
    from gs_localization_torch.sfm.evaluate import pose_errors

    t_start = time.perf_counter()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {kind}")
    print(f"nvidia-smi: {smi}")

    with phase("build"):
        t0 = time.perf_counter()
        built = _kernels.build()
        print(f"kernel build: {time.perf_counter() - t0:.1f} s "
              f"({'cached' if built is None else 'nvcc'}) from "
              f"{[s.name for s in _kernels.sources()]}")
        for name, info in _kernels.kernel_info().items():
            print(f"occupancy {name}: "
                  f"{info['ctas_per_sm']} CTAs/SM "
                  f"({info['ctas_per_sm'] * 8} warps), {info['regs']} "
                  f"registers/thread, {info['smem']} B shared memory/CTA, "
                  f"{info['local']} B local/thread")

    cfg = RasterizerConfig(max_pairs=MAX_PAIRS, max_per_tile=1024,
                           max_render=MAX_RENDER, fast_k=1,
                           pallas_chunk=CHUNK)
    dev = torch.device("cuda")
    grid_x = -(-W // 16)
    g = bench_scene(dev)
    cam = Camera.from_rt(np.eye(3), np.zeros(3), 520.0, 520.0, W, H,
                         device=dev)
    gs = small_scene(dev)
    cam_s = Camera.from_rt(np.eye(3), np.zeros(3), 60.0, 60.0, 96, 64,
                           device=dev)
    cfg_s = cfg.replace(max_pairs=1 << 14, max_render=1 << 14)

    # ---- K1/K2 vs plain --------------------------------------------------
    with phase("K1/K2 vs plain"):
        pack = build_stream_pair_pack(g, cam, cfg)
        check(not bool(pack.overflow), "bench pack overflow")
        with torch.no_grad():
            stream_t = _project_stream(pack.params, pack.kept_al, cam)
        print(f"bench stream: {tuple(stream_t.shape)}, kept_al "
              f"{int(pack.kept_al)}, tiles {pack.tstart.shape[0]}, max walk "
              f"{int(pack.walk_counts.max())}")
        err_k1, err_k2, (gacc, glogt, fwd12) = compare_kernels(
            "bench", stream_t, pack, grid_x, seed=0)
        pack_s = build_stream_pair_pack(gs, cam_s, cfg_s)
        counts_s = pack_s.walk_counts
        print(f"small stream: max walk {int(counts_s.max())}, empty tiles "
              f"{int((counts_s == 0).sum())}")
        check(int(counts_s.max()) <= CHUNK and int((counts_s == 0).sum()) > 0,
              "small scene is not single-chunk with an empty tile")
        with torch.no_grad():
            stream_s = _project_stream(pack_s.params, pack_s.kept_al, cam_s)
        e1, e2, _ = compare_kernels("small", stream_s, pack_s, -(-96 // 16),
                                    seed=1)
        err_k1, err_k2 = max(err_k1, e1), max(err_k2, e2)

    # ---- the binning kernels vs plain, bin_stream card vs CPU --------------
    with phase("binning kernels vs plain"):
        scene = scene_case(dev)
        bin_result = binning_kernels(g, dev, scene)
    with phase("K1/K2 vs plain at scene scale"):
        bin_result["scene K1/K2"] = scene_blend(*scene)
    with phase("pose projection vs plain"):
        bin_result["bench P1/P2"] = pose_projection("bench", pack, cam)
        g_m, cam_m, cfg_m = scene
        pack_m = build_stream_pair_pack(g_m, cam_m, cfg_m)
        check(not bool(pack_m.overflow), "scene pack overflow")
        bin_result["scene P1/P2"] = pose_projection("scene", pack_m, cam_m)
        del scene, g_m, pack_m
        torch.cuda.empty_cache()
    with phase("pose algebra vs plain"):
        bin_result["pose algebra"] = pose_algebra(cam)

    # ---- K3/K4 vs plain --------------------------------------------------
    with phase("K3/K4 vs plain"):
        bins_b, geom_b, rgbd_b, mtc_bench, n_bench = bench_windows(g, cam,
                                                                   cfg)
        print(f"bench windows: max_tile_count {mtc_bench} -> max_per_tile "
              f"{geom_b.shape[2]}, geom {tuple(geom_b.shape)}, {n_bench}"
              f" pairs emitted")
        err_k3, err_k4, (gacc3, glogt3, fwd3) = compare_pregathered(
            "bench", bins_b.tile_counts, geom_b, rgbd_b, grid_x, seed=2)
        bins_sm, geom_sm, rgbd_sm = pregathered_inputs(
            gs, cam_s, cfg_s.replace(use_stream=False, max_per_tile=256))
        c_sm = bins_sm.tile_counts
        print(f"small windows: max count {int(c_sm.max())}, empty tiles "
              f"{int((c_sm == 0).sum())}, geom {tuple(geom_sm.shape)}")
        check(int(c_sm.max()) <= CHUNK and int((c_sm == 0).sum()) > 0,
              "small windows are not single-chunk with an empty tile")
        e3, e4, _ = compare_pregathered("small", c_sm, geom_sm, rgbd_sm,
                                        -(-96 // 16), seed=3)
        err_k3, err_k4 = max(err_k3, e3), max(err_k4, e4)
        hold_stream_vs_pregathered(stream_t, pack, grid_x, seed=8)

    # ---- CUDA path vs CPU path, small scene, both layouts ----------------
    with phase("CUDA vs CPU"):
        gs_cpu = gs.replace(**{f: getattr(gs, f).cpu() for f in
                               TRAINABLE + ("live",)})
        cam_cpu = cam_s.replace(w2c=cam_s.w2c.cpu(), fx=cam_s.fx.cpu(),
                                fy=cam_s.fy.cpu(), cx=cam_s.cx.cpu(),
                                cy=cam_s.cy.cpu())
        for layout, build, c in (
                ("stream pack", build_stream_pair_pack, cfg_s),
                ("PairPack", build_pair_pack,
                 cfg_s.replace(use_stream=False, max_per_tile=256))):
            grads = []
            for gg, cc in ((gs, cam_s), (gs_cpu, cam_cpu)):
                pk = build(gg, cc, c)
                tau = torch.zeros(6, device=cc.device, requires_grad=True)
                cl, dp, al = render_pose_mode(pk, cc.with_delta(tau), c)
                (cl.sum() + 0.1 * dp.sum() + 0.01 * al.sum()).backward()
                grads.append((cl.detach().cpu(), dp.detach().cpu(),
                              al.detach().cpu(), tau.grad.cpu()))
            (c1, d1, a1, t1), (c2, d2, a2, t2) = grads
            img_err = max(float((c1 - c2).abs().max()),
                          float((d1 - d2).abs().max()),
                          float((a1 - a2).abs().max()))
            _, n_grad = close_err(t1, t2, *TOL_GRAD)
            print(f"small scene CUDA vs CPU ({layout}): images max|d| "
                  f"{img_err:.3e} (tol {TOL_IMG}); tangent grad max "
                  f"normalized {n_grad:.3f}")
            check(img_err <= TOL_IMG and n_grad <= 1,
                  f"CUDA path disagrees with the CPU path ({layout})")
            check(all(bool(torch.isfinite(x).all()) for x in (c1, d1, a1, t1)),
                  "non-finite render")

    # ---- n_touched: the card's counts against the CPU's ---------------------
    with phase("n_touched: card vs CPU"):
        cpu = torch.device("cpu")
        # the card test's two scenes and configs, then the bench scene
        for label, (seed, n, spread, chunk, cap) in (
                ("multi_chunk", (0, 500, 1.0, 32, 512)),
                ("single_chunk", (4, 40, 0.5, 128, 128))):
            c = RasterizerConfig(max_pairs=1 << 14, max_render=1 << 14,
                                 fast_k=1, pallas_chunk=chunk,
                                 max_per_tile=cap, chunk=32)
            touched_margins(
                label, [touched_case(seed, n, spread, d) for d in (dev, cpu)],
                c)
        g_cpu = g.replace(**{f: getattr(g, f).cpu()
                             for f in TRAINABLE + ("live",)})
        cam_cpu_b = cam.replace(w2c=cam.w2c.cpu(), fx=cam.fx.cpu(),
                                fy=cam.fy.cpu(), cx=cam.cx.cpu(),
                                cy=cam.cy.cpu())
        touched_margins(
            "bench", [(g, cam), (g_cpu, cam_cpu_b)],
            cfg.replace(max_per_tile=round_up(mtc_bench, 64), chunk=64))
        del g_cpu

    # ---- localization path: 4 perturbed queries, stream layout ------------
    with phase("localization (stream, K1/K2)"):
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
        # convergence=0: every query runs all N_ITERS iterations, so the
        # launch counts must equal the iterations exactly
        tcfg = TrackingConfig(num_iters=N_ITERS, lr=1e-3, rebin_every=10,
                              pose_mode=True, convergence=0.0)
        launches_loc, ms_iter, _ = localize_checked(
            "localize", g, queries, init, gt_w2c,
            LocalizePipelineConfig(batch_size=N_QUERIES, tracking=tcfg), cfg)
        iters = N_QUERIES * N_ITERS
        check(launches_loc["stream_fwd"] == iters
              and launches_loc["stream_bwd"] == iters
              and launches_loc["pregathered_fwd"] == 0
              and launches_loc["pregathered_bwd"] == 0,
              f"launch counts {launches_loc} != {iters} iterations")
        pose_algebra_launches("localize", launches_loc, iters)

    # ---- training scene: 10 views of the bench map --------------------------
    with phase("training scene"):
        views = training_views(cam)
        imgs, deps = [], []
        with torch.no_grad():
            for v in views:
                r = rasterize(g, v, cfg)
                check(not bool(r.overflow) and not bool(r.tile_overflow),
                      "view render overflow")
                imgs.append(r.color.cpu().numpy())
                deps.append(r.depth.cpu().numpy())
        infos = [CameraInfo(uid=i, name=f"view{i}", camera=v)
                 for i, v in enumerate(views)]
        centres = np.stack([v.campos.cpu().numpy() for v in views])
        pipe = TrainPipelineConfig(
            iterations=N_TRAIN, densify_from=50, densification_interval=100,
            densify_until=N_TRAIN + 1, sh_up_interval=100,
            test_iterations=(N_TRAIN,), save_iterations=(N_TRAIN,),
            log_every=50)
        # the map train_map starts from, and the capacities it needs
        points, colors, g0 = initial_map(g, pipe, dev)
        scene = SceneInfo(train_cameras=infos[:N_VIEWS - N_TEST_VIEWS],
                          test_cameras=infos[N_VIEWS - N_TEST_VIEWS:],
                          points=points, colors=colors,
                          extent=compute_scene_extent(centres))
        train_cfg, mtc, nrend, deep = probe_training(
            g0, [i.camera for i in scene.train_cameras])
        print(f"training scene: {len(scene.train_cameras)} train + "
              f"{len(scene.test_cameras)} held-out views, extent "
              f"{scene.extent:.4f}; from_pcd map capacity {g0.capacity}; "
              f"probe max_tile_count {mtc} (view{deep}), pairs {nrend} -> "
              f"max_per_tile {train_cfg.max_per_tile}, max_pairs "
              f"{train_cfg.max_pairs}")

    # ---- K3/K4 vs plain at the training path's shapes -----------------------
    with phase("K3/K4 vs plain (training windows)"):
        cam_deep = views[deep]
        bins_t, geom_t, rgbd_t = pregathered_inputs(g0, cam_deep, train_cfg)
        check(not bool(bins_t.overflow) and not bool(bins_t.tile_overflow),
              "training-view bin_gaussians overflow")
        c_t = bins_t.tile_counts
        print(f"training windows (initial map, view{deep}): max count "
              f"{int(c_t.max())} ({-(-int(c_t.max()) // CHUNK)} chunks), "
              f"median {int(c_t.median())}, geom {tuple(geom_t.shape)}")
        e3, e4, (gacc_t, glogt_t, fwd_t) = compare_pregathered(
            "train-initial", c_t, geom_t, rgbd_t, grid_x, seed=4,
            yardstick=True, at_most_f32=True)
        err_k3, err_k4 = max(err_k3, e3), max(err_k4, e4)

    # ---- layout cross-check at full width ------------------------------------
    with phase("layout cross-check"):
        gt0 = torch.tensor(imgs[0], device=dev)
        gd0 = torch.tensor(deps[0], device=dev)
        stream_cfg = RasterizerConfig(
            max_pairs=train_cfg.max_pairs, max_render=round_up(1.5 * nrend,
                                                               CHUNK),
            pallas_chunk=CHUNK)
        res = {}
        for name, c in (("stream", stream_cfg), ("pregathered", train_cfg)):
            params = {f: getattr(g0, f).clone().requires_grad_()
                      for f in TRAINABLE}
            off = torch.zeros((g0.capacity, 2), device=dev,
                              requires_grad=True)
            r = rasterize(g0.replace(**params), cam, c, means2d_offset=off)
            check(not bool(r.overflow) and not bool(r.tile_overflow),
                  f"cross-check {name} overflow")
            loss, _ = mlosses.training_loss(r.color, gt0, depth=r.depth,
                                            gt_depth=gd0)
            grads = torch.autograd.grad(loss, [params[f] for f in TRAINABLE]
                                        + [off], allow_unused=True)
            res[name] = (r._replace(color=r.color.detach(),
                                    depth=r.depth.detach(),
                                    alpha=r.alpha.detach()),
                         float(loss.detach()), grads)
        (rs, ls, gs_), (rp, lp, gp) = res["stream"], res["pregathered"]
        img_err = max(float((a - b).abs().max()) for a, b in zip(
            (rs.color, rs.depth, rs.alpha), (rp.color, rp.depth, rp.alpha)))
        print(f"layouts: images max|d| {img_err:.3e} (tol {TOL_LAYOUT_IMG}); "
              f"loss {ls:.7f} vs {lp:.7f} (rtol {TOL_LAYOUT_LOSS})")
        check(img_err <= TOL_LAYOUT_IMG
              and abs(ls - lp) <= TOL_LAYOUT_LOSS * abs(ls),
              "the layouts disagree on images or loss")
        for name, a, b in zip(TRAINABLE + ("means2d_offset",), gs_, gp):
            a = torch.zeros(1, device=dev) if a is None else a
            b = torch.zeros(1, device=dev) if b is None else b
            scale = float(a.abs().max())
            if scale == 0.0:          # e.g. features_rest at SH degree 0
                print(f"layouts: d{name} zero on both: "
                      f"{float(b.abs().max()) == 0.0}")
                check(float(b.abs().max()) == 0.0, f"layouts: d{name}")
                continue
            e, n = close_err(b / scale, a / scale, *TOL_LAYOUT_GRAD)
            print(f"layouts: d{name} max|d|/max|g| {e:.3e} (tol atol "
                  f"{TOL_LAYOUT_GRAD[0]} rtol {TOL_LAYOUT_GRAD[1]}, max "
                  f"normalized {n:.3f})")
            check(n <= 1, f"the layouts disagree on d{name}")
        del res, rs, rp, gs_, gp

    # ---- training path: train_map on the pregathered layout -----------------
    with phase("training (pregathered, K3/K4)"):
        with torch.no_grad():
            psnr0 = float(np.mean([
                float(mlosses.psnr(rasterize(g0, i.camera, train_cfg).color,
                                   torch.tensor(imgs[i.uid], device=dev)))
                for i in scene.test_cameras]))
        step_losses, logs = [], []
        (ROOT / "build").mkdir(exist_ok=True)
        out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_",
                                        dir=ROOT / "build"))
        try:
            torch.cuda.synchronize()
            gsl.reset_launches()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            trained = train_map(
                scene, str(out_dir), pipe, raster_cfg=train_cfg,
                image_loader=lambda info: (imgs[info.uid], deps[info.uid]),
                log_fn=logs.append, device=dev,
                step_hook=lambda it, aux: step_losses.append(aux["total"]))
            ev1.record()
            ev1.synchronize()
            launches_train = dict(gsl.LAUNCHES)
            ms_step = ev0.elapsed_time(ev1) / N_TRAIN
            for line in logs:
                print(f"train_map: {line}")
            losses_np = torch.stack(step_losses).cpu().numpy()
            first, last = float(losses_np[:10].mean()), float(
                losses_np[-10:].mean())
            print(f"training: {N_TRAIN} steps, {ms_step:.3f} ms/step (CUDA "
                  f"events around train_map, densify, held-out PSNR and the "
                  f"PLY save included); loss first 10 {first:.5f} -> last 10 "
                  f"{last:.5f}; live {int(trained.num_live)}, capacity "
                  f"{trained.capacity}, SH degree {trained.sh_degree}")
            print(f"training launches: {launches_train}")
            check(np.isfinite(losses_np).all() and last < first,
                  "training loss did not fall")
            n_test = len(scene.test_cameras[:8])
            check(launches_train["pregathered_bwd"] == N_TRAIN
                  and launches_train["pregathered_fwd"] == N_TRAIN + n_test
                  and launches_train["stream_fwd"] == 0
                  and launches_train["stream_bwd"] == 0,
                  f"training launches {launches_train} != {N_TRAIN} steps + "
                  f"{n_test} held-out renders")
            rounds = [tuple(int(x) for x in m.groups()) for line in logs
                      for m in [re.search(r"densify: cloned (\d+) split (\d+)",
                                          line)] if m]
            check(len(rounds) == 3 and all(c + s > 0 for c, s in rounds),
                  f"densify rounds {rounds}: each must clone or split")
            grew = [line for line in logs if "grew capacity" in line]
            print(f"capacity growth: {trained.capacity} vs initial "
                  f"{g0.capacity}, {len(grew)} growth lines logged")
            check((trained.capacity > g0.capacity) == bool(grew),
                  "a capacity growth was not logged")
            with torch.no_grad():
                psnr1 = float(np.mean([
                    float(mlosses.psnr(
                        rasterize(trained, i.camera, train_cfg).color,
                        torch.tensor(imgs[i.uid], device=dev)))
                    for i in scene.test_cameras]))
            print(f"held-out PSNR: initial map {psnr0:.3f} dB -> trained "
                  f"{psnr1:.3f} dB")
            check(psnr1 > psnr0, "held-out PSNR did not rise")
            ply = out_dir / "gs_map" / f"iteration_{N_TRAIN}" / \
                "point_cloud.ply"
            back = load_map(str(ply), device=dev)
            with torch.no_grad():
                a = rasterize(trained, scene.test_cameras[0].camera,
                              train_cfg)
                b = rasterize(back, scene.test_cameras[0].camera, train_cfg)
            ply_err = float((a.color - b.color).abs().max())
            print(f"PLY round trip: {back.capacity} Gaussians, image max|d| "
                  f"{ply_err:.3e} (tol {TOL_PLY})")
            check(back.capacity == int(trained.num_live)
                  and ply_err <= TOL_PLY, "the saved PLY renders differently")
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        # K3/K4 vs plain on the trained map's windows at the same view
        bins_f, geom_f, rgbd_f = pregathered_inputs(trained, cam_deep,
                                                    train_cfg)
        c_f = bins_f.tile_counts
        print(f"training windows (trained map, view{deep}): max count "
              f"{int(c_f.max())}, tile overflow {bool(bins_f.tile_overflow)},"
              f" geom {tuple(geom_f.shape)}")
        e3, e4, _ = compare_pregathered("train-final", c_f, geom_f, rgbd_f,
                                        grid_x, seed=5, yardstick=True)
        err_k3, err_k4 = max(err_k3, e3), max(err_k4, e4)
        del bins_f, geom_f, rgbd_f

    # ---- few-shot training: pseudo views on the stream layout (K1/K2) -------
    with phase("few-shot training (stream, K1/K2)"):
        from gs_localization_torch.mapping.pseudo_views import (
            generate_pseudo_poses)
        from gs_localization_torch.utils.viewer import serve

        stream_train = RasterizerConfig(
            max_pairs=train_cfg.max_pairs,
            max_render=round_up(1.5 * nrend, CHUNK), pallas_chunk=CHUNK)
        pipe_fs = dataclasses.replace(
            pipe, save_iterations=(), sample_pseudo_interval=FS_INTERVAL,
            start_sample_pseudo=FS_WINDOW[0], end_sample_pseudo=FS_WINDOW[1],
            pseudo_per_edge=3)
        pseudo_its = [it for it in range(1, N_TRAIN + 1)
                      if it % FS_INTERVAL == 0
                      and FS_WINDOW[0] < it < FS_WINDOW[1]]
        n_pseudo_cams = len(generate_pseudo_poses(
            [i.camera for i in scene.train_cameras], n_per_edge=3))
        est_calls, pv_losses, step_events, logs_fs = [], {}, {}, []

        def prior(rgb):
            """A deterministic monocular prior: 1 / (0.1 + luminance)."""
            return 1.0 / (0.1 + rgb @ np.array([0.299, 0.587, 0.114],
                                               np.float32))

        def estimator(rgb):
            check(rgb.shape == (H, W, 3), f"estimator got {rgb.shape}")
            est_calls.append(1)
            return prior(rgb)

        def hook(it, aux):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            step_events[it] = ev
            if "pseudo_view" in aux:
                pv_losses[it] = aux["pseudo_view"]

        torch.cuda.synchronize()
        gsl.reset_launches()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        step_events[0] = ev0
        trained_fs = train_map(
            scene, None, pipe_fs, raster_cfg=stream_train,
            image_loader=lambda info: (imgs[info.uid], deps[info.uid]),
            depth_estimator=estimator, log_fn=logs_fs.append, device=dev,
            step_hook=hook)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        ev1.synchronize()
        launches_fs = dict(gsl.LAUNCHES)
        for line in logs_fs:
            print(f"few-shot train_map: {line}")
        step_ms = {it: step_events[it - 1].elapsed_time(step_events[it])
                   for it in range(2, N_TRAIN + 1)}
        ms_pseudo = statistics.median(step_ms[it] for it in pseudo_its)
        ms_plain = statistics.median(ms for it, ms in step_ms.items()
                                     if it not in pseudo_its)
        n_test = len(scene.test_cameras[:8])
        n_ps = len(pseudo_its)
        print(f"few-shot: {n_pseudo_cams} pseudo cameras, pseudo steps at "
              f"{pseudo_its} ({n_ps}), estimator called {len(est_calls)} "
              f"times; {ev0.elapsed_time(ev1) / N_TRAIN:.3f} ms/step over "
              f"{N_TRAIN} steps (CUDA events around train_map); median step "
              f"{ms_plain:.3f} ms without a pseudo view, {ms_pseudo:.3f} ms "
              f"with one (events at each step's end; nvidia-smi: {smi})")
        print(f"few-shot launches: {launches_fs}")
        check(n_pseudo_cams == 21 and "few-shot: generated 21 pseudo views"
              in logs_fs, "few-shot: not 21 pseudo cameras")
        check(len(est_calls) == n_ps and sorted(pv_losses) == pseudo_its,
              f"few-shot: {len(est_calls)} estimator calls, pseudo terms at "
              f"{sorted(pv_losses)}, schedule {pseudo_its}")
        pv = torch.stack(list(pv_losses.values())).cpu().numpy()
        print(f"few-shot: pseudo_view loss {pv.min():.5f} .. {pv.max():.5f}")
        check(np.isfinite(pv).all(), "few-shot: non-finite pseudo_view")
        check(launches_fs["stream_fwd"] == N_TRAIN + 2 * n_ps + n_test
              and launches_fs["stream_bwd"] == N_TRAIN + n_ps
              and launches_fs["pregathered_fwd"] == 0
              and launches_fs["pregathered_bwd"] == 0,
              f"few-shot launches {launches_fs} != K1 {N_TRAIN} + 2 x {n_ps} "
              f"+ {n_test}, K2 {N_TRAIN} + {n_ps}")
        psnr_fs = [float(x) for line in logs_fs
                   for x in re.findall(r"test PSNR ([\d.]+)", line)]
        print(f"few-shot held-out PSNR: initial map {psnr0:.3f} dB -> "
              f"{psnr_fs}")
        check(len(psnr_fs) == 1 and psnr_fs[0] > psnr0,
              "few-shot: held-out PSNR not above the initial map's")
        del trained_fs

        # one train_step with the pseudo term, card vs CPU, small scene
        gs_c = gs.replace(**{f: getattr(gs, f).cpu()
                             for f in TRAINABLE + ("live",)})
        cs_c = cam_s.replace(w2c=cam_s.w2c.cpu(), fx=cam_s.fx.cpu(),
                             fy=cam_s.fy.cpu(), cx=cam_s.cx.cpu(),
                             cy=cam_s.cy.cpu())
        tau_t = torch.tensor([0.01, -0.008, 0.012, 0.02, -0.015, 0.01])
        tau_p = torch.tensor([-0.03, 0.02, 0.01, 0.03, 0.02, -0.02])
        for layout, c in (("stream", cfg_s), (
                "pregathered", cfg_s.replace(use_stream=False,
                                             max_per_tile=256))):
            res = []
            for gg, cc in ((gs, cam_s), (gs_c, cs_c)):
                d_ = cc.device
                with torch.no_grad():
                    tgt = rasterize(gg, cc.with_delta(tau_t.to(d_)), c)
                    pdep = torch.tensor(prior(rasterize(
                        gg, cc.with_delta(tau_p.to(d_)), c).color.cpu()
                        .numpy()), device=d_)
                mc = mtrain.MapTrainConfig()
                st = mtrain.init_training(gg, mc)
                gsl.reset_launches()
                st, aux = mtrain.train_step(
                    st, cc, tgt.color, mc, c, gt_depth=tgt.depth,
                    pseudo_camera=cc.with_delta(tau_p.to(d_)),
                    pseudo_view_depth=pdep)
                res.append((aux, st, dict(gsl.LAUNCHES)))
            (a_k, s_k, l_k), (a_p, s_p, _) = res
            k = "stream" if layout == "stream" else "pregathered"
            check(l_k[f"{k}_fwd"] == 2 and l_k[f"{k}_bwd"] == 2,
                  f"pseudo step ({layout}) launches {l_k}")
            worst = 0.0
            for name in TRAINABLE:
                mu_k, mu_p = s_k.opt_state[name].mu.cpu(), \
                    s_p.opt_state[name].mu
                scale = max(float(mu_p.abs().max()), 1e-30)
                worst = max(worst, close_err(mu_k / scale, mu_p / scale,
                                             *TOL_BWD)[1])
            l_err = max(abs(float(a_k[x]) - float(a_p[x])) / abs(float(a_p[x]))
                        for x in ("total", "pseudo_view"))
            print(f"pseudo step card vs CPU ({layout}): loss and pseudo_view "
                  f"rel err {l_err:.2e} (tol 1e-5), gradients max normalized "
                  f"{worst:.3f} (atol {TOL_BWD[0]} rtol {TOL_BWD[1]} of each "
                  f"field's max), launches {l_k}")
            check(l_err <= 1e-5 and worst <= 1,
                  f"pseudo step ({layout}): card disagrees with the CPU")
            check(torch.equal(s_k.densify.denom.cpu(), s_p.densify.denom),
                  f"pseudo step ({layout}): densify stats")

        # train_step_batched (B = 4 training views, full width) against the
        # mean of the four single-view gradients
        mc = mtrain.MapTrainConfig(spatial_scale=scene.extent)
        s0 = mtrain.init_training(g0, mc)
        bviews = scene.train_cameras[:4]
        b_imgs = torch.tensor(np.stack([imgs[i.uid] for i in bviews]),
                              device=dev)
        b_deps = torch.tensor(np.stack([deps[i.uid] for i in bviews]),
                              device=dev)
        gsl.reset_launches()
        sb_, aux_b = mtrain.train_step_batched(
            s0, [i.camera for i in bviews], b_imgs, mc, stream_train,
            gt_depths=b_deps)
        l_b = dict(gsl.LAUNCHES)
        singles = [mtrain.train_step(s0, i.camera, b_imgs[j], mc,
                                     stream_train, gt_depth=b_deps[j])
                   for j, i in enumerate(bviews)]
        worst = 0.0
        for name in TRAINABLE:
            # from zero moments, mu after one step is 0.1 x the gradient
            mean_mu = sum(s.opt_state[name].mu for s, _ in singles) / 4
            scale = max(float(mean_mu.abs().max()), 1e-30)
            worst = max(worst, close_err(sb_.opt_state[name].mu / scale,
                                         mean_mu / scale, *TOL_BWD)[1])
        vis_any = sum((s.densify.denom > 0).to(torch.int32)
                      for s, _ in singles) > 0
        total_mean = sum(float(a["total"]) for _, a in singles) / 4
        t_err = abs(float(aux_b["total"]) - total_mean) / total_mean
        print(f"train_step_batched (B 4, {W}x{H}, {g0.capacity} slots): "
              f"total rel err {t_err:.2e} vs the single steps' mean (tol "
              f"1e-5), gradients max normalized {worst:.3f} against the mean "
              f"single-view gradient, launches {l_b}")
        check(l_b["stream_fwd"] == 4 and l_b["stream_bwd"] == 4,
              f"batched step launches {l_b}")
        check(t_err <= 1e-5 and worst <= 1
              and torch.equal(sb_.densify.denom > 0, vis_any),
              "train_step_batched disagrees with the mean single-view step")
        del sb_, singles, s0

        # one viewer frame rendered on the card
        httpd = serve(g, width=W, height=H, port=0, raster_cfg=cfg,
                      block=False)
        try:
            gsl.reset_launches()
            frame = urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.server_address[1]}/render?az=0&"
                f"el=0&r=4", timeout=120).read()
            launches_view = dict(gsl.LAUNCHES)
        finally:
            httpd.shutdown()
            httpd.server_close()
        is_jpeg = frame[:2] == b"\xff\xd8"
        print(f"viewer: {len(frame)}-byte frame, JPEG {is_jpeg}, launches "
              f"{launches_view}")
        check(is_jpeg and launches_view["stream_fwd"] == 1,
              "the viewer's frame is not a JPEG rendered through K1")

    # ---- the repaired faults: reproducible stream training ----------------
    with phase("repairs (stream training bits, the pack gradient)"):
        mcfg_r = mtrain.MapTrainConfig(spatial_scale=scene.extent)
        rviews = [(i.camera, torch.tensor(imgs[i.uid], device=dev),
                   torch.tensor(deps[i.uid], device=dev))
                  for i in scene.train_cameras]

        def stream_run(n=20):
            st = mtrain.init_training(g0, mcfg_r)
            for k in range(n):
                c, im, dp = rviews[k % len(rviews)]
                st, _ = mtrain.train_step(st, c, im, mcfg_r, stream_train,
                                          gt_depth=dp)
            return st

        run_a, run_b = stream_run(), stream_run()
        same = {f: bool(torch.equal(getattr(run_a.gaussians, f),
                                    getattr(run_b.gaussians, f)))
                for f in TRAINABLE}
        moved = float((run_a.gaussians.xyz - g0.xyz).abs().max())
        print(f"stream training, 20 train_steps twice from one state "
              f"(initial map, {g0.capacity} slots): parameters bit-equal "
              f"{same}; xyz moved up to {moved:.3e}")
        check(all(same.values()) and moved > 0,
              "stream training is not bit-reproducible")
        del run_a, run_b
        # the pack gradient's reduction at a stream step's shapes: the
        # slot-order reduction (this port) beside index_add_ (the gather's
        # adjoint before), on the same grad stream
        from gs_localization_torch.raster.preprocess import preprocess
        from gs_localization_torch.raster.rasterize import (bin_stream_for,
                                                            stream_pack)
        c0 = rviews[0][0]
        with torch.no_grad():
            prep0 = preprocess(g0, c0)
            sb0 = bin_stream_for(prep0, c0, stream_train)
            pk0 = stream_pack(prep0, prep0.means2d)
        dst = torch.randn((16, sb0.gid_of_pos.shape[0] + CHUNK),
                          generator=torch.Generator().manual_seed(12)).to(dev)
        slot = lambda: sb.slot_order_pack_grad(dst, sb0, 12)  # noqa: E731

        def index_add():
            d = torch.where(torch.arange(dst.shape[1], device=dev)
                            < sb0.kept_al, dst, 0.0)[:12, :-CHUNK].T
            return torch.zeros((pk0.shape[0] + 1, 12), device=dev
                               ).index_add_(0, sb0.gid_of_pos.long(),
                                            d)[:-1]

        d_slot, d_add = slot(), index_add()
        e_red = float((d_slot - d_add).abs().max())
        ms_slot, ms_add = device_ms(slot), device_ms(index_add)
        print(f"pack gradient per stream step ({pk0.shape[0]} Gaussians, "
              f"{int(sb0.kept_al)} stream lanes, {sb0.pos_by_slot.shape[0]} "
              f"slots): slot order {ms_slot:.4f} ms device time, index_add_ "
              f"{ms_add:.4f} ms; max|d| between them {e_red:.3e} (scale "
              f"{float(d_add.abs().max()):.3e}); {smi_line()}")
        check(e_red <= 1e-4 * max(float(d_add.abs().max()), 1.0),
              "the slot-order pack gradient disagrees with index_add_")

    # ---- pose mode's PairPack: 2 queries on the pregathered layout ----------
    with phase("localization (PairPack, K3/K4)"):
        cfg_pair = cfg.replace(use_stream=False,
                               max_per_tile=round_up(1.5 * mtc_bench, 256))
        launches_pair, ms_pair, logs_pair = localize_checked(
            "pairpack", g, queries[:N_PAIR_QUERIES], init[:N_PAIR_QUERIES],
            gt_w2c, LocalizePipelineConfig(batch_size=N_PAIR_QUERIES,
                                           tracking=tcfg), cfg_pair)
        iters_pair = N_PAIR_QUERIES * N_ITERS
        check(not any("overflow" in line for line in logs_pair)
              and launches_pair["pregathered_fwd"] == iters_pair
              and launches_pair["pregathered_bwd"] == iters_pair
              and launches_pair["stream_fwd"] == 0,
              f"PairPack launches {launches_pair} != {iters_pair} iterations")
        pose_algebra_launches("pairpack", launches_pair, iters_pair,
                              stream=False)
        # K3/K4 vs plain on a PairPack's windows (valid row from the
        # projection, max_per_tile of this phase)
        with torch.no_grad():
            pk = build_pair_pack(g, queries[0].camera, cfg_pair)
            geom_q, rgbd_q = _project_pairs(pk.params, queries[0].camera)
        print(f"PairPack windows: max count {int(pk.counts.max())}, geom "
              f"{tuple(geom_q.shape)}")
        e3, e4, _ = compare_pregathered(
            "pairpack", pk.counts, geom_q.contiguous(), rgbd_q.contiguous(),
            grid_x, seed=6)
        err_k3, err_k4 = max(err_k3, e3), max(err_k4, e4)
        del pk, geom_q, rgbd_q

    # ---- the multi-device layer at full width on the one card -------------
    with phase("multi-device (one card)"):
        md_cfg = cfg.replace(use_stream=False,
                             max_per_tile=train_cfg.max_per_tile)
        print(f"[multi-device] the bench scene ({W}x{H}, {N_GAUSS} "
              f"Gaussians at SH 3), max_per_tile {md_cfg.max_per_tile} (the "
              f"training phase's)")
        launches_md, e_f = multi_device(g, cam, cfg, md_cfg, queries, tcfg,
                                        dev)
        err_k3 = max(err_k3, e_f)
        print(f"multi-device launches: {launches_md}")
        check(all(launches_md[k] > 0 for k in BLEND_KERNELS),
              f"multi-device: a kernel was not launched: {launches_md}")

    # ---- the scene runner on a 7-Scenes layout: stream training, K1/K2 ------
    with phase("scene runner (stream training, K1/K2)"):
        from gs_localization_torch.core import sh as sh_lib
        from gs_localization_torch.core.camera import (quat_to_rotmat,
                                                       rotmat_to_quat)
        from gs_localization_torch.core.gaussians import GaussianParams
        from gs_localization_torch.data.scene import load_depth, load_image
        from gs_localization_torch.data.seven_scenes import (
            load_seven_scenes_scene)
        from gs_localization_torch.pipelines import run_scene
        from gs_localization_torch.sfm.io import (read_pose_results,
                                                  write_pose_results)

        (ROOT / "build").mkdir(exist_ok=True)
        scene_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_scene_",
                                          dir=ROOT / "build"))
        try:
            root = scene_dir / "chess"
            rng_s = np.random.default_rng(13)
            views_s = [cam] + [perturbed(cam, rng_s, 0.03, 0.1) for _ in
                               range(N_SCENE_TRAIN + N_SCENE_TEST - 1)]
            true_w2c = write_seven_scenes(root, g, views_s, cfg)
            # the native decoder (opt-in; the runner reads with PIL)
            # against PIL on one colour and one depth frame
            from gs_localization_torch.data import native_loader as nl

            if nl.NativeLoader.available():
                dec = nl.NativeLoader(2)
                errs = []
                for kind, name, ref in (
                        (nl.KIND_RGB, "frame-000000.color.png", load_image),
                        (nl.KIND_DEPTH16, "frame-000000.depth.png",
                         load_depth)):
                    path = str(root / "seq-01" / name)
                    dec.submit(0, path, kind)
                    _, arr = dec.fetch()
                    errs.append(float(np.abs(arr - ref(path)).max()))
                dec.close()
                print(f"native loader: built ({nl.library_path().name}); "
                      f"decode vs PIL max|d| colour {errs[0]:.3e}, depth "
                      f"{errs[1]:.3e}")
                check(max(errs) <= 1e-6, "the native loader decodes "
                      "differently from PIL")
            else:
                print(f"native loader: not built ({nl.build_error()})")
            # the sfm stage is not ported: write its two files
            out_s = root / "output_tpu"
            out_s.mkdir()
            pts = g.xyz.cpu().numpy()
            cols = np.clip(sh_lib.sh_dc_to_rgb(
                g.features_dc[:, 0].cpu().numpy()), 0.0, 1.0)
            np.savez(out_s / "sfm_points.npz", points=pts,
                     colors=cols.astype(np.float32))
            init_s, init_err = {}, []
            test_names = list(true_w2c)[N_SCENE_TRAIN:]
            for name, cam_t in zip(test_names, views_s[N_SCENE_TRAIN:]):
                gt_w = true_w2c[name]
                w = perturbed(cam_t, rng_s, np.deg2rad(1.0), 0.025
                              ).w2c.cpu().numpy().astype(np.float64)
                init_s[name] = (rotmat_to_quat(w[:3, :3]), w[:3, 3])
                init_err.append(pose_errors(w[:3, :3], w[:3, 3],
                                            gt_w[:3, :3], gt_w[:3, 3]))
            write_pose_results(str(out_s / "results_dense.txt"), init_s)
            print(f"scene: {len(views_s)} views {W}x{H} written under "
                  f"{root.name}/, init errors " + ", ".join(
                      f"{t * 100:.2f} cm / {r:.3f} deg" for t, r in init_err))
            common = ["--scene", str(root), "--preset", "seven_scenes"]

            done = run_scene.main(common + ["--stage", "prepare"])
            n_tr, n_te = (len(x) for x in done["prepare"])
            check((n_tr, n_te) == (N_SCENE_TRAIN, N_SCENE_TEST),
                  f"prepare reported {n_tr} / {n_te} images")

            # the initial map's held-out PSNR and the K1/K2 check on its
            # pack, at the runner's raster config
            scene_s = load_seven_scenes_scene(str(root), device=dev)
            rcfg_s = RasterizerConfig(max_pairs=1 << 21, max_per_tile=1024,
                                      use_stream=True)
            g_init = GaussianParams.from_pcd(
                pts, cols, sh_degree=3,
                capacity=max(int(len(pts) * 4.0), 1024), device=dev)
            with torch.no_grad():
                psnr_init = float(np.mean([
                    float(mlosses.psnr(
                        rasterize(g_init, c.camera, rcfg_s).color,
                        torch.tensor(load_image(c.image_path), device=dev)))
                    for c in scene_s.test_cameras]))
            err_s1, err_s2 = scene_pack_check(
                "scene-train", g_init,
                scene_s.train_cameras[0].camera, rcfg_s, grid_x, seed=9)
            err_k1, err_k2 = max(err_k1, err_s1), max(err_k2, err_s2)

            tee = Tee(sys.stdout)
            torch.cuda.synchronize()
            gsl.reset_launches()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            with contextlib.redirect_stdout(tee):
                done = run_scene.main(common + [
                    "--stage", "train", "--iterations", str(SCENE_ITERS)])
            ev1.record()
            ev1.synchronize()
            launches_scene_train = dict(gsl.LAUNCHES)
            ms_step_s = ev0.elapsed_time(ev1) / SCENE_ITERS
            log_s = tee.text()
            psnrs = [float(x) for x in re.findall(
                r"\[\d+\] test PSNR ([\d.]+)", log_s)]
            grow_s = [ln for ln in log_s.splitlines()
                      if "binning overflow" in ln]
            trained_s = done["train"]
            print(f"scene train: {SCENE_ITERS} steps, {ms_step_s:.3f} ms/step "
                  f"(CUDA events around the train stage: scene and image "
                  f"loading, held-out PSNR and the PLY save included); "
                  f"held-out PSNR initial map {psnr_init:.3f} dB -> logged "
                  f"{psnrs}; live {int(trained_s.num_live)}; "
                  f"{len(grow_s)} binning overflow lines")
            print(f"scene train launches: {launches_scene_train}")
            n_held = min(8, N_SCENE_TEST)
            check(launches_scene_train["stream_bwd"] == SCENE_ITERS
                  and launches_scene_train["stream_fwd"]
                  == SCENE_ITERS + n_held
                  and launches_scene_train["pregathered_fwd"] == 0
                  and launches_scene_train["pregathered_bwd"] == 0,
                  f"scene training launches {launches_scene_train} != "
                  f"{SCENE_ITERS} steps + {n_held} held-out renders on K1/K2")
            check(len(psnrs) == 1 and psnrs[-1] > psnr_init,
                  f"held-out PSNR {psnrs} not above the initial map's "
                  f"{psnr_init:.3f}")
            ply_s = (root / "output_tpu" / "gs_map" /
                     f"iteration_{SCENE_ITERS}" / "point_cloud.ply")
            back_s = load_map(str(ply_s), device=dev)
            check(back_s.capacity == int(trained_s.num_live),
                  "the scene's PLY does not reload")

            torch.cuda.synchronize()
            gsl.reset_launches()
            ev0.record()
            done = run_scene.main(common + [
                "--stage", "localize", "--iterations", str(SCENE_ITERS)])
            ev1.record()
            ev1.synchronize()
            launches_scene_loc = dict(gsl.LAUNCHES)
            n_loc = launches_scene_loc["stream_bwd"]
            ms_loc_s = ev0.elapsed_time(ev1) / max(n_loc, 1)
            print(f"scene localize launches: {launches_scene_loc}; "
                  f"{ms_loc_s:.3f} ms per refinement iteration (CUDA events "
                  f"around the localize stage, map and image loading "
                  f"included, over its {n_loc} iterations)")
            check(n_loc > 0 and launches_scene_loc["stream_fwd"] == n_loc
                  and launches_scene_loc["pregathered_fwd"] == 0
                  and launches_scene_loc["pregathered_bwd"] == 0,
                  f"scene localize launches {launches_scene_loc}")
            pose_algebra_launches("scene localize", launches_scene_loc,
                                  n_loc)
            poses_s = read_pose_results(str(out_s / "results.txt"))
            check(sorted(poses_s) == sorted(test_names),
                  f"results.txt holds {sorted(poses_s)}")
            check((out_s / "metrics.json").exists(), "no metrics.json")
            metrics_s = json.loads((out_s / "metrics.json").read_text())
            fin_err = []
            for name in test_names:
                q, t = poses_s[name]
                check(np.isfinite(q).all() and np.isfinite(t).all(),
                      f"{name}: non-finite pose")
                gt_w = true_w2c[name]
                R = quat_to_rotmat(torch.tensor(q)).numpy()
                fin_err.append(pose_errors(R, t, gt_w[:3, :3], gt_w[:3, 3]))
            med0 = np.median(np.array(init_err), axis=0)
            med1 = np.median(np.array(fin_err), axis=0)
            print(f"scene localize: median error {med0[0] * 100:.3f} cm / "
                  f"{med0[1]:.4f} deg -> {med1[0] * 100:.3f} cm / "
                  f"{med1[1]:.4f} deg; metrics.json {metrics_s}")
            check(med1[0] < med0[0] and med1[1] < med0[1],
                  "the median refined error is not below the initial one")

            # ms per training step, stream vs pregathered, on the same
            # initial state and view set (the scene's runner configs; the
            # pregathered cap from a probe of this map)
            mcfg_s = mtrain.MapTrainConfig(spatial_scale=scene_s.extent,
                                           lambda_gt_depth=0.05,
                                           lambda_pseudo_depth=0.01)
            sviews = []
            for c in scene_s.train_cameras:
                sviews.append((c.camera, torch.tensor(
                    load_image(c.image_path), device=dev), torch.tensor(
                    load_depth(c.depth_path), device=dev)))
            pre_cfg_s, mtc_s, _, _ = probe_training(
                g_init, [c for c, _, _ in sviews])
            s0 = mtrain.init_training(g_init, mcfg_s)

            def steps_on(rc, n=10):
                st = s0
                for k in range(n):
                    c, im, dp = sviews[k % len(sviews)]
                    st, _ = mtrain.train_step(st, c, im, mcfg_s, rc,
                                              gt_depth=dp)
                return st

            step_stream = time_ms(lambda: steps_on(rcfg_s), 5) / 10
            step_pre = time_ms(lambda: steps_on(pre_cfg_s), 5) / 10
            # the pack gradient as index_select's adjoint index_add_
            # (atomics) gives it, instead of the slot-order reduction
            slot_order = sb._SlotOrderStream

            class IndexAdd:
                @staticmethod
                def apply(pack, sbins, chunk):
                    return sb.assemble_stream(pack, sbins.gid_of_pos, chunk)

            sb._SlotOrderStream = IndexAdd
            try:
                step_add = time_ms(lambda: steps_on(rcfg_s), 5) / 10
            finally:
                sb._SlotOrderStream = slot_order
            print(f"scene train_step from the initial map: stream layout "
                  f"{step_stream:.3f} ms/step (slot-order pack gradient), "
                  f"{step_add:.3f} ms/step with index_add_ instead; "
                  f"pregathered (max_per_tile {pre_cfg_s.max_per_tile}, "
                  f"probed max count {mtc_s}) {step_pre:.3f} ms/step "
                  f"(median of 5 runs of 10 steps)")
        finally:
            shutil.rmtree(scene_dir, ignore_errors=True)

    # ---- the scene runner's four stages, the sfm stage on the card ----------
    with phase("scene runner, all stages (sfm on the card)"):
        launches_all = all_stages(g, cam, cfg, dev)

    # ---- the learned front end: networks on the card, --weights-dir --------
    with phase("learned front end (networks on the card)"):
        launches_learned = learned_front_end(g, cam, cfg, dev)

    # ---- the rest of hloc's learned confs: networks, both front ends ------
    with phase("hloc confs (networks on the card)"):
        launches_hloc = hloc_confs(g, cam, cfg, dev)

    # ---- timing at the bench shapes -----------------------------------------
    with phase("timing"):
        clocks = "clocks.sm,clocks.max.sm"
        print(f"SM clock before timing ({clocks}): {smi_line(clocks)}")
        args = (stream_t, pack.tstart, pack.walk_counts)
        bargs = (bins_b.tile_counts, geom_b, rgbd_b)
        pargs = (bins_t.tile_counts, geom_t, rgbd_t)
        # kernel -> (device time per call, median single call): K1/K2 and
        # K3/K4 at the bench shapes (the same walked work), K3/K4 at the
        # training path's windows (the kernels line's numbers)
        calls = {
            "K1": lambda: sb.stream_blend_fwd_cuda(*args, grid_x, 16, CHUNK),
            "K2": lambda: sb.stream_blend_bwd_cuda(
                *args, gacc, glogt, fwd12[1], fwd12[3], grid_x, 16, CHUNK),
            "K3 bench": lambda: pb.pregathered_blend_fwd_cuda(
                *bargs, grid_x, 16, CHUNK),
            "K4 bench": lambda: pb.pregathered_blend_bwd_cuda(
                *bargs, gacc3, glogt3, fwd3[1], fwd3[3], grid_x, 16, CHUNK),
            "K3": lambda: pb.pregathered_blend_fwd_cuda(
                *pargs, grid_x, 16, CHUNK),
            "K4": lambda: pb.pregathered_blend_bwd_cuda(
                *pargs, gacc_t, glogt_t, fwd_t[1], fwd_t[3], grid_x, 16,
                CHUNK),
        }
        tk = {name: (device_ms(fn), time_ms(fn)) for name, fn in calls.items()}
        k1p_ms = time_ms(lambda: sb.stream_blend_fwd_plain(
            *args, grid_x, 16, CHUNK), N_PLAIN_TIMED)
        k2p_ms = time_ms(lambda: sb.stream_blend_bwd_plain(
            *args, gacc, glogt, grid_x, 16, CHUNK), N_PLAIN_TIMED)
        k3p_ms = time_ms(lambda: pb.pregathered_blend_fwd_plain(
            *pargs, grid_x, 16, CHUNK), N_PLAIN_TIMED)
        k4p_ms = time_ms(lambda: pb.pregathered_blend_bwd_plain(
            *pargs, gacc_t, glogt_t, grid_x, 16, CHUNK), N_PLAIN_TIMED)
        work12 = walked_work(stream_t, pack, fwd12[2], grid_x)
        work34b = pregathered_work(*bargs, fwd3[2], grid_x)
        work34 = pregathered_work(*pargs, fwd_t[2], grid_x)
        for label, wk in (("K1/K2 bench", work12), ("K3/K4 bench", work34b),
                          ("K3/K4 training", work34)):
            b_fwd = max(wk["fwd_ops_s"], wk["fwd_bytes"] / PEAK_HBM) * 1e3
            b_bwd = max(wk["bwd_ops_s"], wk["bwd_bytes"] / PEAK_HBM) * 1e3
            print(f"walked {label}: {wk['chunks']} chunks, {wk['slots']} pair "
                  f"slots x 256 pixels, {wk['gated']} (pixel, pair) products "
                  f"pass the gate; fwd {wk['fwd_bytes']} bytes, (fp32, sfu) "
                  f"instructions {wk['fwd_ins']}; bwd {wk['bwd_bytes']} "
                  f"bytes, {wk['bwd_ins']}; bound fwd {b_fwd:.4f} ms, bwd "
                  f"{b_bwd:.4f} ms")
        def shown(name):
            dev_ms, one_ms = tk[name]
            return f"{dev_ms:.4f} ms (single call {one_ms:.4f})"

        print(f"bench shapes, device time per call over {N_TIMED} calls back "
              f"to back (and the median single call, host enqueue "
              f"included): K1 {shown('K1')}, plain {k1p_ms:.3f}; K2 "
              f"{shown('K2')}, plain {k2p_ms:.3f}; K3 {shown('K3 bench')}; "
              f"K4 {shown('K4 bench')}")
        print(f"training shapes (cap {geom_t.shape[2]}): K3 {shown('K3')}, "
              f"plain {k3p_ms:.3f}; K4 {shown('K4')}, plain {k4p_ms:.3f}")
        print(f"SM clock after timing ({clocks}): {smi_line(clocks)}")

    def entry(name, source, replaces, n_launch, err, times, plain_ms, byts,
              ops_s):
        t_bytes, t_ops = byts / PEAK_HBM * 1e3, ops_s * 1e3
        return {"name": name, "route": "cuda",
                "source": f"gs_localization_torch/csrc/{source}",
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": times[1], "kernel_ms": times[1],
                "device_ms": times[0],
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None}

    # K1/K2 run on seven paths: localization, few-shot training, the
    # viewer, the scene runner's stream training and localization, its four
    # stages in one call, the four stages with the learned front end, and
    # training and localization from the hloc confs' front ends (each
    # counted from 0 over its own run)
    k12_launches = {k: launches_loc[k] + launches_fs[k] + launches_view[k]
                    + launches_scene_train[k] + launches_scene_loc[k]
                    + launches_all[k] + launches_learned[k]
                    + launches_hloc[k] + launches_md[k]
                    for k in ("stream_fwd", "stream_bwd")}
    # K3/K4 run on two paths: pregathered training and the multi-device
    # phase's tile- and Gaussian-sharded renders
    k34_launches = {k: launches_train[k] + launches_md[k]
                    for k in ("pregathered_fwd", "pregathered_bwd")}
    print(f"K1/K2 launches: localization {launches_loc}, few-shot training "
          f"{launches_fs}, viewer {launches_view}, scene runner train "
          f"{launches_scene_train}, localize {launches_scene_loc}, all "
          f"stages {launches_all}, learned front end {launches_learned}, "
          f"hloc confs {launches_hloc}, multi-device {launches_md}; K3/K4 "
          f"launches: training {launches_train}, multi-device "
          f"{launches_md}")
    kernels = [
        entry("stream_fwd", "stream_blend.cu",
              "gs_localization_tpu/raster/stream_blend.py:85",
              k12_launches["stream_fwd"], err_k1, tk["K1"], k1p_ms,
              work12["fwd_bytes"], work12["fwd_ops_s"]),
        entry("stream_bwd", "stream_blend.cu",
              "gs_localization_tpu/raster/stream_blend.py:161",
              k12_launches["stream_bwd"], err_k2, tk["K2"], k2p_ms,
              work12["bwd_bytes"], work12["bwd_ops_s"]),
        entry("pregathered_fwd", "pallas_blend.cu",
              "gs_localization_tpu/raster/pallas_blend.py:82",
              k34_launches["pregathered_fwd"], err_k3, tk["K3"], k3p_ms,
              work34["fwd_bytes"], work34["fwd_ops_s"]),
        entry("pregathered_bwd", "pallas_blend.cu",
              "gs_localization_tpu/raster/pallas_blend.py:145",
              k34_launches["pregathered_bwd"], err_k4, tk["K4"], k4p_ms,
              work34["bwd_bytes"], work34["bwd_ops_s"]),
    ]
    # A1/A2, V1/V2 and S1 on the refinement paths, each counted from 0
    # over its own run (the multi-device phase's A1/A2 also count one
    # differentiated camera of its sharded renders)
    bin_result["pose algebra launches"] = {
        path: {k: launches[k] for k in POSE_ALGEBRA}
        for path, launches in (
            ("localize", launches_loc), ("pairpack", launches_pair),
            ("scene localize", launches_scene_loc),
            ("all stages", launches_all), ("learned", launches_learned),
            ("hloc", launches_hloc), ("multi-device", launches_md))}
    print(f"pose algebra launches: "
          f"{json.dumps(bin_result['pose algebra launches'])}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "binning": bin_result}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if "--md-rank" in sys.argv:
        import argparse

        ap = argparse.ArgumentParser()
        for flag in ("--md-rank", "--md-max-per-tile"):
            ap.add_argument(flag, type=int, required=True)
        ap.add_argument("--md-init", required=True)
        ap.add_argument("--md-out", required=True)
        a = ap.parse_args()
        md_worker(a.md_rank, a.md_init, a.md_out, a.md_max_per_tile)
    else:
        main()
