"""The blend kernels' share of their roofline in training: the least time
the chip needs for the blend forward and backward of every traced step
(``workcount``: the benchmark's own count of the step's view, walked over
the map as it stood when the trace began, against the published H100
peaks) over the blend kernels' device time in the trace."""

from gsbench import readers

SPANS = [readers.BINS]
note = readers.note_camera


def read(ctx, st, window):
    first, views = readers.traced_units(ctx), readers.step_views(ctx, st)
    if first is None or first >= len(views):
        return None
    drv = readers.driver(ctx)
    return readers.blend_roofline(ctx, [(drv.work(st, v), 1)
                                        for v in views[first:]])
