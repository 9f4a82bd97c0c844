#!/usr/bin/env python3
"""Ablation of the pregathered blend kernels K3/K4 on an NVIDIA card.

    python3 blend_ablation.py [--parent CSRC_DIR]

Run it from the repository root: it takes ``chip_smoke.py``'s bench scene
and training windows (the initial map at its deepest training view). It
builds ``gs_localization_torch/csrc/`` and copies of it in which one design
point of K3/K4 is undone (``ABLATIONS``), prints what ``ptxas`` reports for
K3/K4 of each build (registers, shared memory, spills) and each new build's
CTAs per SM, holds each against the redesign (k_stop equal, the largest
differences printed), and times K3 and K4 (median of 25 launches, CUDA
events, the kernels alone without the wrappers' allocation) at the training
and the bench windows, in two rounds, the second in reverse order. The
times include the tile-order helper launch that the redesign's entry points
make before each kernel. ``--parent`` adds the K3/K4 of an older ``csrc/``
whose entry points take no tile order (the first design).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

# name -> text edits (file, old, new) to a copy of csrc/
ABLATIONS = {
    "redesign": [],
    "tiles in index order": [(
        "pallas_blend.cu", "  if (lane == 0) order[rank] = t;\n",
        "  if (lane == 0) order[t] = t;\n")],
    "ten warp_sum folds (K4)": [(
        "blend_common.cuh",
        "    if (__any_sync(0xffffffffu, g.in)) s = reduce10(v, lane);\n",
        "    if (__any_sync(0xffffffffu, g.in)) {\n"
        "      for (int q = 0; q < kGrad; ++q) {\n"
        "        const float t = warp_sum(v[q]);\n"
        "        if (q == slot) s = t;\n"
        "      }\n"
        "    }\n")],
    "synchronous copies": [(
        "pallas_blend.cu",
        "  cp_async_commit();\n}\n",
        "  cp_async_commit();\n  cp_async_wait_all();\n}\n")],
    "accurate exp and division": [
        ("blend_common.cuh", "alpha * __expf(log_full)",
         "alpha * expf(log_full)"),
        ("blend_common.cuh", "__expf(log_before)", "expf(log_before)"),
        ("blend_common.cuh", "__fdividef(labar, 1.0f - alpha)",
         "labar / (1.0f - alpha)")],
    "6 CTAs/SM bound": [
        ("blend_common.cuh", "kPieceMinBlocks = 4", "kPieceMinBlocks = 6")],
}
OUT = Path("build") / "ablation"


def _sources(tag: str, csrc: Path, edits) -> Path:
    d = OUT / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for name, old, new in edits:
        text = (d / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: {old!r} not found once in {name}")
        (d / name).write_text(text.replace(old, new))
    return d


def _build_all(dirs: dict) -> dict:
    """One nvcc per source of every build, all started together, then one
    link per build; prints ptxas' lines for the pregathered kernels and
    returns tag -> loaded library."""
    from gs_localization_torch._kernels import NVCC_FLAGS

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs, objs = [], {}
    for tag, d in dirs.items():
        for src in sorted(d.glob("*.cu")):
            obj = d / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                   str(src)]
            procs.append((tag, src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.setdefault(tag, []).append(str(obj))
    for tag, src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc {src.name}: exit "
                               f"{proc.returncode}\n{out}")
        if src.name == "pallas_blend.cu":
            for line in out.splitlines():
                if "ptxas info" in line and ("entry function" in line
                                             or "Used" in line):
                    print(f"{tag}: {line.split(':', 1)[1].strip()}")
    libs = {}
    for tag, d in dirs.items():
        lib = d / "lib.so"
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                        *objs[tag]], check=True)
        libs[tag] = ctypes.CDLL(str(lib.resolve()))
    return libs


def _launchers(lib, with_order: bool):
    """K3 and K4 of one library, called through its C entry points."""
    import torch

    p, i = ctypes.c_void_p, ctypes.c_int

    def head(counts, order):
        return [p(counts.data_ptr())] + (
            [p(order.data_ptr())] if with_order else [])

    def fwd(counts, order, geom, rgbd, grid_x, chunk, outs):
        num_tiles, _, cap = geom.shape
        rc = lib.gsl_pregathered_fwd(
            *head(counts, order), p(geom.data_ptr()), p(rgbd.data_ptr()),
            i(num_tiles), i(cap), i(grid_x), i(chunk),
            *[p(o.data_ptr()) for o in outs],
            p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"K3 launch: CUDA error {rc}")

    def bwd(counts, order, geom, rgbd, grid_x, chunk, gacc, glogt, resid,
            outs):
        num_tiles, _, cap = geom.shape
        rc = lib.gsl_pregathered_bwd(
            *head(counts, order), p(geom.data_ptr()), p(rgbd.data_ptr()),
            i(num_tiles), i(cap), i(grid_x), i(chunk), p(gacc.data_ptr()),
            p(glogt.data_ptr()), p(resid.data_ptr()),
            *[p(o.data_ptr()) for o in outs],
            p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"K4 launch: CUDA error {rc}")

    return fwd, bwd


def _windows():
    """(name, counts, geom, rgbd, grid_x) at the training and the bench
    windows, as chip_smoke.py builds them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.pipelines.train_map import TrainPipelineConfig
    from gs_localization_torch.raster import RasterizerConfig

    dev = torch.device("cuda")
    g = cs.bench_scene(dev)
    cam = Camera.from_rt(np.eye(3), np.zeros(3), 520.0, 520.0, cs.W, cs.H,
                         device=dev)
    cfg = RasterizerConfig(max_pairs=cs.MAX_PAIRS, max_per_tile=1024,
                           max_render=cs.MAX_RENDER, fast_k=1,
                           pallas_chunk=cs.CHUNK)
    bins_b, geom_b, rgbd_b, _, _ = cs.bench_windows(g, cam, cfg)
    views = cs.training_views(cam)
    _, _, g0 = cs.initial_map(g, TrainPipelineConfig(), dev)
    train_cfg, _, _, deep = cs.probe_training(
        g0, views[:cs.N_VIEWS - cs.N_TEST_VIEWS])
    bins_t, geom_t, rgbd_t = cs.pregathered_inputs(g0, views[deep],
                                                   train_cfg)
    grid_x = -(-cs.W // 16)
    return [("training", bins_t.tile_counts, geom_t, rgbd_t, grid_x),
            ("bench", bins_b.tile_counts, geom_b, rgbd_b, grid_x)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an older csrc/ whose K3/K4 take no tile order")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from gs_localization_torch import _kernels
    from gs_localization_torch.raster import pallas_blend as pb

    if not torch.cuda.is_available():
        raise SystemExit("blend_ablation needs an NVIDIA card")
    dirs = {tag: _sources(f"v{k}", _kernels.CSRC, edits)
            for k, (tag, edits) in enumerate(ABLATIONS.items())}
    if args.parent is not None:
        dirs["parent"] = _sources("parent", args.parent, [])
    libs = _build_all(dirs)
    runs = [(tag, libs[tag], True) for tag in ABLATIONS]
    if args.parent is not None:
        runs.insert(0, ("parent", libs["parent"], False))
    for tag, lib, new in runs:
        if not new:
            continue
        lib.gsl_kernel_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        for which in (2, 3):
            out = (ctypes.c_int * 4)()
            lib.gsl_kernel_info(which, cs.CHUNK, out)
            print(f"{tag}: {_kernels.KERNELS[which]} {out[0]} CTAs/SM, "
                  f"{out[1]} registers, {out[2]} B shared, {out[3]} B "
                  f"local", flush=True)

    sets = []
    for name, counts, geom, rgbd, grid_x in _windows():
        acc, logt, resid = pb.pregathered_blend_fwd_cuda(
            counts, geom, rgbd, grid_x, 16, cs.CHUNK)
        gacc, glogt = cs.cotangents(acc, logt, seed=0)
        sets.append((name, counts, geom, rgbd, grid_x, gacc, glogt, resid))
    ref = {}
    for rnd, order_runs in enumerate((runs, runs[::-1])):
        for tag, lib, new in order_runs:
            fwd, bwd = _launchers(lib, new)
            line = []
            for name, counts, geom, rgbd, grid_x, gacc, glogt, resid in sets:
                num_tiles = counts.shape[0]
                order = torch.empty_like(counts)     # the entry points fill it
                f_out = [torch.empty((num_tiles, 4, 256), device=geom.device),
                         torch.empty((num_tiles, 256, 1), device=geom.device),
                         torch.empty((num_tiles, 256, 2), device=geom.device)]
                b_out = [torch.empty_like(geom), torch.empty_like(rgbd)]
                call = (counts, order, geom, rgbd, grid_x, cs.CHUNK)
                fwd(*call, f_out)
                bwd(*call, gacc, glogt, resid, b_out)
                torch.cuda.synchronize()
                if tag == "redesign":
                    ref.setdefault(name, [x.clone() for x in f_out + b_out])
                t3 = cs.time_ms(lambda: fwd(*call, f_out))
                t4 = cs.time_ms(lambda: bwd(*call, gacc, glogt, resid, b_out))
                line.append(f"{name} K3 {t3:.4f} ms K4 {t4:.4f} ms")
                base = ref.get(name)
                if base is not None and tag != "redesign":
                    cur = f_out + b_out
                    same_k = torch.equal(cur[2][..., 1], base[2][..., 1])
                    d_f = float((cur[0] - base[0]).abs().max())
                    d_b = max(float((cur[k] - base[k]).abs().max())
                              for k in (3, 4))
                    line.append(f"(vs redesign: k_stop equal {same_k}, "
                                f"accum max|d| {d_f:.2e}, gradients max|d| "
                                f"{d_b:.2e})")
            print(f"round {rnd} {tag}: " + "; ".join(line), flush=True)
    print(cs.smi_line("name,power.limit,clocks.sm,clocks.max.sm"))


if __name__ == "__main__":
    main()
