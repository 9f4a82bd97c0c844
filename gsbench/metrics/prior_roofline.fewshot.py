"""The depth prior's network's share of its roofline: the least time the
chip needs for one DPT_Hybrid forward at its input (``workcount_dpt``:
operations and bytes from the layer shapes, against the published H100
float32 peak outside the tensor cores and its memory bandwidth) over the
mean stream time of the port's ``prior/net`` span."""

from gsbench import readers, registry, workcount, workcount_dpt


def read(ctx, st, window):
    ms = registry.metric("prior_ms.fewshot").read(ctx, st, window)
    p = readers.peak(ctx)
    if ms is None or p is None:
        return None
    w = workcount_dpt.count(*ctx.config["depth_prior"]["input"])
    need = workcount.min_seconds(w.flops, w.nbytes, p)[0]
    return 100.0 * need / (ms / 1e3)
