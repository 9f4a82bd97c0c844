"""The whole training step's share of the chip's float32 peak: the
operations every traced step needs (``workcount``: projection and SH,
blend, L1, depth and SSIM, forward and backward, for the step's view,
walked over the map as it stood when the trace began), over the traced
seconds times the published H100 float32 peak outside the tensor cores."""

from gsbench import readers

SPANS = [readers.BINS]
note = readers.note_camera


def read(ctx, st, window):
    first, views = readers.traced_units(ctx), readers.step_views(ctx, st)
    d = readers.trace(ctx)
    if d is None or first is None or first >= len(views):
        return None
    drv = readers.driver(ctx)
    return readers.mfu(ctx, sum(drv.flops(st, v) for v in views[first:]),
                       d["window_s"])
