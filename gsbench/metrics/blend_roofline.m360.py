"""The blend kernels' share of their roofline in localization at scene
scale: the least time the chip needs for the blend forward and backward of
every traced iteration (``workcount``: the benchmark's own count of each
query's walk at its initial pose, against the published H100 peaks) over
the blend kernels' device time in the trace."""

from gsbench import readers


def read(ctx, st, window):
    first, its = readers.traced_units(ctx), readers.query_iters(st)
    if first is None or first >= len(its):
        return None
    drv = readers.driver(ctx)
    return readers.blend_roofline(ctx, [
        (drv.work(st, q), n) for q, n in zip(window["units"][first:],
                                             its[first:])])
