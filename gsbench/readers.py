"""Pieces the per-layer metric readers share: the spans they wrap, what
they note of each call, the device trace's blend kernels, and the bodies of
the roofline and idle readers (one metric file each names its cell's
units).

A reader returns None when its run gave it nothing to read (no span fired,
no trace, no card): the metric is then left out of the result line.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from gsbench import registry, workcount

REBIN = "gs_localization_torch.raster.pose_mode.build_stream_pair_pack"
BINS = "gs_localization_torch.raster.rasterize.bins_for"
DENSIFY = "gs_localization_torch.pipelines.train_map.densify_and_prune"

# the hand-written blend kernels' names (csrc/stream_blend.cu,
# csrc/pallas_blend.cu, csrc/blend_common.cuh)
BLEND_KERNELS = ("stream_fwd_kernel", "stream_bwd_kernel",
                 "pregathered_fwd_kernel", "pregathered_bwd_kernel",
                 "tile_order_kernel")


def note_camera(args, kwargs, out) -> dict:
    cam = args[1] if len(args) > 1 else kwargs["camera"]
    return {"camera": id(cam)}


def records(ctx, path: str) -> List[dict]:
    return ctx.spans.records.get(path, [])


def query_iters(st) -> List[int]:
    """Iterations of each window query, in window order: ``num_iters`` of
    the refinement whose pose the query returned (the localize driver's
    capture of ``RefineResult``)."""
    return [calls[-1]["iters"] for _, _, calls in st.done if calls]


def step_views(ctx, st) -> List[int]:
    """The view of each window step, in window order."""
    return [st.view_of[r["camera"]] for r in records(ctx, BINS)]


def driver(ctx):
    return registry.driver(ctx.traffic["driver"])


def peak(ctx) -> Optional[dict]:
    if ctx.device.type != "cuda":
        return None
    import torch

    return workcount.peak(torch.cuda.get_device_name(ctx.device))


def trace(ctx):
    return ctx.device_trace.result


def blend_kernel_s(ctx) -> float:
    d = trace(ctx)
    if d is None:
        return 0.0
    return sum(s for name, s in d["kernels"].items()
               if any(k in name for k in BLEND_KERNELS))


def idle_pct(ctx) -> Optional[float]:
    d = trace(ctx)
    if d is None or d["window_s"] <= 0 or d["activities"] == 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])


def traced_units(ctx) -> Optional[int]:
    """Index of the first window unit the device trace covers."""
    d = trace(ctx)
    return None if d is None else ctx.device_trace.first_unit


def blend_roofline(ctx, traced) -> Optional[float]:
    """The blend kernels' share of their roofline: the least time the chip
    needs for the blend forward and backward of the traced units
    (``traced``: (``workcount.Render`` of one unit's render, renders of
    it)), over the blend kernels' device time in the trace."""
    p, spent = peak(ctx), blend_kernel_s(ctx)
    if p is None or spent <= 0 or not traced:
        return None
    need = sum(n * workcount.blend_seconds(r, p) for r, n in traced)
    r = traced[0][0]
    bounds = [workcount.min_seconds(r.blend_fwd_flops(), r.blend_fwd_bytes(),
                                    p)[1],
              workcount.min_seconds(r.blend_bwd_flops(), r.blend_bwd_bytes(),
                                    p)[1]]
    print(f"gsbench: blend work of one traced unit: {r}; forward and "
          f"backward bound by {bounds}", file=sys.stderr)
    return 100.0 * need / spent


def mfu(ctx, flops: float, seconds: float) -> Optional[float]:
    """``flops`` over ``seconds`` times the chip's float32 peak, in %."""
    p = peak(ctx)
    if p is None or seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * p["flops"])
