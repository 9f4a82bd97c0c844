#!/usr/bin/env python3
"""Ablation of the blend kernels K1-K4 on an NVIDIA card.

    python3 blend_ablation.py [--parent CSRC_DIR]

Run it from the repository root: it takes ``chip_smoke.py``'s bench scene
(the bench stream for K1/K2, the bench windows for K3/K4) and its training
windows (the initial map at its deepest training view). It builds
``gs_localization_torch/csrc/`` and copies of it in which one design point
of the shared piece walks is undone (``ABLATIONS``), prints what ``ptxas``
reports for the four kernels of each build (registers, shared memory,
spills) and each new build's CTAs per SM, holds each against the redesign
(k_stop equal, the largest differences printed), prints each build's K4
distance from the float64 plain K4 at the training windows (as
``chip_smoke.py``'s train-initial yardstick), and times K1 and K2 at
the bench stream and K3 and K4 at the training and the bench windows
(median of 25 launches, CUDA events, the kernels alone without the
wrappers' allocation), in two rounds, the second in reverse order. The
times include the tile-order helper launch that the forward entry points
make before each forward kernel; each build's backward runs on its own
forward's outputs. ``--parent`` adds the kernels of an older ``csrc/``
whose K1/K2 entry points take no tile order (the chunk walks), whose K3/K4
take one, whose forward entry points record no last applied lane and
whose backward entry points take the forward's resid.
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
        "blend_common.cuh", "  if (lane == 0) order[rank] = t;\n",
        "  if (lane == 0) order[t] = t;\n")],
    "ten 5-shuffle folds (K2/K4)": [(
        "blend_common.cuh",
        "    if (__any_sync(0xffffffffu, applied)) s = reduce10(v, lane);\n",
        "    if (__any_sync(0xffffffffu, applied)) {\n"
        "      for (int q = 0; q < kGrad; ++q) {\n"
        "        float t = v[q];\n"
        "        for (int off = 16; off > 0; off >>= 1)\n"
        "          t += __shfl_xor_sync(0xffffffffu, t, off);\n"
        "        if (q == slot) s = t;\n"
        "      }\n"
        "    }\n")],
    "synchronous copies": [(
        "blend_common.cuh",
        "  cp_async_commit();\n}\n",
        "  cp_async_commit();\n  cp_async_wait_all();\n}\n")],
    "accurate exp and division": [
        ("blend_common.cuh", "alpha * __expf(log_full)",
         "alpha * expf(log_full)"),
        ("blend_common.cuh", "__expf(log_before)", "expf(log_before)"),
        ("blend_common.cuh",
         "__fdividef((float)(suffix + gl), 1.0f - alpha)",
         "(float)(suffix + gl) / (1.0f - alpha)")],
    "log T rebuilt over the whole walk (K2/K4)": [(
        "blend_common.cuh",
        "if (p == n_pieces - 1 || (p + 1) % nsub == 0) {",
        "if (p == n_pieces - 1) {")],
    "float32 suffix sum (K2/K4)": [
        ("blend_common.cuh", "double& suffix)", "float& suffix)"),
        ("blend_common.cuh", "double suffix = 0.0;", "float suffix = 0.0f;"),
        ("blend_common.cuh", "suffix += (double)wbar * (double)w;",
         "suffix += wbar * w;")],
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
    link per build; prints ptxas' lines for the blend kernels and returns
    tag -> loaded library."""
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
        for line in out.splitlines():
            if "ptxas info" in line and ("entry function" in line
                                         or "Used" in line):
                print(f"{tag}: {src.name}: "
                      f"{line.split(':', 1)[1].strip()}")
    libs = {}
    for tag, d in dirs.items():
        lib = d / "lib.so"
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                        *objs[tag]], check=True)
        libs[tag] = ctypes.CDLL(str(lib.resolve()))
    return libs


def _launchers(lib, new: bool):
    """K1-K4 of one library, called through its C entry points. K3/K4 take
    the order; with ``new`` (this tree's entry points) K1/K2 take it too,
    K3/K4 take the first tile (0 here), K1/K3 write each pixel's last
    applied lane and its log T at each walked chunk (``last`` is the pair
    (lanes, records)), and K2/K4 take the forward's log_t, lanes and
    records instead of its resid."""
    import torch

    p, i = ctypes.c_void_p, ctypes.c_int

    def cs():
        return p(torch.cuda.current_stream().cuda_stream)

    def ptrs(*ts):
        return [p(t.data_ptr()) for t in ts]

    def run(name, rc):
        if rc:
            raise RuntimeError(f"{name} launch: CUDA error {rc}")

    def written(fwd, last):      # what a forward writes: accum, log_t, resid
        return ptrs(*fwd) + (ptrs(*last) if new else [])

    def taken(fwd, last):        # what a backward takes of it
        return ptrs(fwd[1], *last) if new else ptrs(fwd[2])

    tile0 = [i(0)] if new else []

    def k1(tstart, wcount, order, stream, grid_x, chunk, fwd, last):
        head = ptrs(tstart, wcount) + (ptrs(order) if new else [])
        run("K1", lib.gsl_stream_fwd(
            *head, *ptrs(stream), i(tstart.shape[0]), i(stream.shape[1]),
            i(grid_x), i(chunk), *written(fwd, last), cs()))

    def k2(tstart, wcount, order, stream, grid_x, chunk, gacc, glogt, fwd,
           last, out):
        head = ptrs(tstart, wcount) + (ptrs(order) if new else [])
        run("K2", lib.gsl_stream_bwd(
            *head, *ptrs(stream), i(tstart.shape[0]), i(stream.shape[1]),
            i(grid_x), i(chunk), *ptrs(gacc, glogt), *taken(fwd, last),
            *ptrs(out), cs()))

    def k3(counts, order, geom, rgbd, grid_x, chunk, fwd, last):
        num_tiles, _, cap = geom.shape
        run("K3", lib.gsl_pregathered_fwd(
            *ptrs(counts, order, geom, rgbd), i(num_tiles), i(cap),
            i(grid_x), i(chunk), *tile0, *written(fwd, last), cs()))

    def k4(counts, order, geom, rgbd, grid_x, chunk, gacc, glogt, fwd, last,
           outs):
        num_tiles, _, cap = geom.shape
        run("K4", lib.gsl_pregathered_bwd(
            *ptrs(counts, order, geom, rgbd), i(num_tiles), i(cap),
            i(grid_x), i(chunk), *tile0, *ptrs(gacc, glogt),
            *taken(fwd, last), *ptrs(*outs), cs()))

    return k1, k2, k3, k4


def _inputs():
    """The bench stream (stream, tstart, walk_counts, grid_x) and the
    (name, counts, geom, rgbd, grid_x) of the training and the bench
    windows, as chip_smoke.py builds them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.pipelines.train_map import TrainPipelineConfig
    from gs_localization_torch.raster import RasterizerConfig
    from gs_localization_torch.raster.pose_mode import (
        _project_stream, build_stream_pair_pack)

    dev = torch.device("cuda")
    g = cs.bench_scene(dev)
    cam = Camera.from_rt(np.eye(3), np.zeros(3), 520.0, 520.0, cs.W, cs.H,
                         device=dev)
    cfg = RasterizerConfig(max_pairs=cs.MAX_PAIRS, max_per_tile=1024,
                           max_render=cs.MAX_RENDER, fast_k=1,
                           pallas_chunk=cs.CHUNK)
    grid_x = -(-cs.W // 16)
    pack = build_stream_pair_pack(g, cam, cfg)
    with torch.no_grad():
        stream = _project_stream(pack.params, pack.kept_al, cam)
    bins_b, geom_b, rgbd_b, _, _ = cs.bench_windows(g, cam, cfg)
    views = cs.training_views(cam)
    _, _, g0 = cs.initial_map(g, TrainPipelineConfig(), dev)
    train_cfg, _, _, deep = cs.probe_training(
        g0, views[:cs.N_VIEWS - cs.N_TEST_VIEWS])
    bins_t, geom_t, rgbd_t = cs.pregathered_inputs(g0, views[deep],
                                                   train_cfg)
    return ((stream, pack.tstart, pack.walk_counts, grid_x),
            [("training", bins_t.tile_counts, geom_t, rgbd_t, grid_x),
             ("bench", bins_b.tile_counts, geom_b, rgbd_b, grid_x)])


def _vs(cur, base) -> str:
    """A build's outputs (forward three, then the gradients) against the
    redesign's."""
    import torch

    same_k = bool(torch.equal(cur[2][..., 1], base[2][..., 1]))
    d_f = float((cur[0] - base[0]).abs().max())
    d_b = max(float((c - b).abs().max()) for c, b in zip(cur[3:], base[3:]))
    return (f"(vs redesign: k_stop equal {same_k}, accum max|d| {d_f:.2e}, "
            f"gradients max|d| {d_b:.2e})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an older csrc/ whose K1/K2 take no tile order")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from gs_localization_torch import _kernels
    from gs_localization_torch.raster import pallas_blend as pb
    from gs_localization_torch.raster import stream_blend as sb

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
        lib.gsl_kernel_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
        for which, name in enumerate(_kernels.KERNELS):
            out = (ctypes.c_int * 4)()
            lib.gsl_kernel_info(which, out)
            print(f"{tag}: {name} {out[0]} CTAs/SM, {out[1]} registers, "
                  f"{out[2]} B shared, {out[3]} B local", flush=True)

    (stream, tstart, wcount, sgx), windows = _inputs()
    out = sb.stream_blend_fwd_cuda(stream, tstart, wcount, sgx, 16, cs.CHUNK)
    sgacc, sglogt = cs.cotangents(out[0], out[1], seed=0)
    sets = []
    for name, counts, geom, rgbd, grid_x in windows:
        out = pb.pregathered_blend_fwd_cuda(counts, geom, rgbd, grid_x, 16,
                                            cs.CHUNK)
        gacc, glogt = cs.cotangents(out[0], out[1], seed=0)
        sets.append((name, counts, geom, rgbd, grid_x, gacc, glogt))
    ref = {}
    dev = stream.device

    def fwd_outs(num_tiles, chunks):
        """A forward's accum, log_t, resid and its walk: the last applied
        lanes and the log T records (``chunks`` rows of 256)."""
        return ([torch.empty((num_tiles, 4, 256), device=dev),
                 torch.empty((num_tiles, 256, 1), device=dev),
                 torch.empty((num_tiles, 256, 2), device=dev)],
                (torch.empty((num_tiles, 256), dtype=torch.int32,
                             device=dev),
                 torch.zeros((chunks, 256), device=dev)))

    for rnd, order_runs in enumerate((runs, runs[::-1])):
        for tag, lib, new in order_runs:
            k1, k2, k3, k4 = _launchers(lib, new)
            order = torch.empty_like(tstart)      # K1 fills it
            f_out, last = fwd_outs(tstart.shape[0],
                                   -(-stream.shape[1] // cs.CHUNK))
            d_out = torch.zeros_like(stream)
            call = (tstart, wcount, order, stream, sgx, cs.CHUNK)
            k1(*call, f_out, last)
            k2(*call, sgacc, sglogt, f_out, last, d_out)
            torch.cuda.synchronize()
            cur = f_out + [d_out]
            if tag == "redesign":
                ref.setdefault("stream", [x.clone() for x in cur])
            t1 = cs.time_ms(lambda: k1(*call, f_out, last))
            t2 = cs.time_ms(lambda: k2(*call, sgacc, sglogt, f_out, last,
                                       d_out))
            line = [f"stream K1 {t1:.4f} ms K2 {t2:.4f} ms"]
            if tag != "redesign" and "stream" in ref:
                line.append(_vs(cur, ref["stream"]))
            for name, counts, geom, rgbd, grid_x, gacc, glogt in sets:
                order = torch.empty_like(counts)     # K3 fills it
                f_out, last = fwd_outs(counts.shape[0], counts.shape[0]
                                       * (geom.shape[2] // cs.CHUNK))
                b_out = [torch.empty_like(geom), torch.empty_like(rgbd)]
                call = (counts, order, geom, rgbd, grid_x, cs.CHUNK)
                k3(*call, f_out, last)
                k4(*call, gacc, glogt, f_out, last, b_out)
                torch.cuda.synchronize()
                if tag == "redesign":
                    ref.setdefault(name, [x.clone() for x in f_out + b_out])
                t3 = cs.time_ms(lambda: k3(*call, f_out, last))
                t4 = cs.time_ms(lambda: k4(*call, gacc, glogt, f_out, last,
                                           b_out))
                line.append(f"{name} K3 {t3:.4f} ms K4 {t4:.4f} ms")
                if tag != "redesign" and name in ref:
                    line.append(_vs(f_out + b_out, ref[name]))
            print(f"round {rnd} {tag}: " + "; ".join(line), flush=True)
    # K4's distance from the float64 plain K4 at the training windows, per
    # build: chip_smoke.py's train-initial yardstick (its cotangents, seed 4,
    # zeroed on the pixels a pair flips between K3, plain f32 and f64)
    _, counts, geom, rgbd, grid_x = sets[0][:5]
    f64 = torch.float64
    pargs = (counts, geom, rgbd, grid_x, 16, cs.CHUNK)
    out = pb.pregathered_blend_fwd_cuda(*pargs)
    out_p = pb.pregathered_blend_fwd_plain(*pargs)
    out_64 = pb.pregathered_blend_fwd_plain(*pargs, dtype=f64)
    flip = (cs.flipped(out[1], out_p[1]) | cs.flipped(out[1], out_64[1])
            | cs.flipped(out_p[1], out_64[1]))
    gacc, glogt = cs.cotangents(out[0], out[1], 4)
    keep = (~flip).float()
    gacc, glogt = gacc * keep[:, None, :], glogt * keep[:, :, None]
    d_64 = pb.pregathered_blend_bwd_plain(counts, geom, rgbd, gacc, glogt,
                                          grid_x, 16, cs.CHUNK, dtype=f64)

    def dist(ds):
        return max(cs.close_err(d, r, *cs.TOL_BWD)[1]
                   for d, r in zip(ds, d_64))

    d_32 = pb.pregathered_blend_bwd_plain(counts, geom, rgbd, gacc, glogt,
                                          grid_x, 16, cs.CHUNK)
    line = [f"plain f32 {dist(d_32):.4e}"]
    for tag, lib, new in runs:
        if not new:
            continue
        _, _, k3, k4 = _launchers(lib, new)
        order = torch.empty_like(counts)
        f_out, last = fwd_outs(counts.shape[0], counts.shape[0]
                               * (geom.shape[2] // cs.CHUNK))
        b_out = [torch.empty_like(geom), torch.empty_like(rgbd)]
        call = (counts, order, geom, rgbd, grid_x, cs.CHUNK)
        k3(*call, f_out, last)
        k4(*call, gacc, glogt, f_out, last, b_out)
        torch.cuda.synchronize()
        line.append(f"{tag} {dist(b_out):.4e}")
    print("K4 from the float64 plain K4 at the training windows (max "
          f"normalized, tol atol {cs.TOL_BWD[0]} rtol {cs.TOL_BWD[1]}): "
          + "; ".join(line), flush=True)
    print(cs.smi_line("name,power.limit,clocks.sm,clocks.max.sm"))


if __name__ == "__main__":
    main()
