"""Share of the traced window in which the device ran nothing, at scene
scale: one minus the union of its kernel, copy and set intervals
(torch.profiler, CUPTI) over the window's length."""

from gsbench import readers


def read(ctx, st, window):
    return readers.idle_pct(ctx)
