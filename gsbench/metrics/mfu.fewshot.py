"""The whole few-shot training step's share of the chip's float32 peak:
the operations every traced step needs (``workcount``: the step's view as
``mfu.train`` counts it; on a pseudo step also the pseudo view's forward
twice and its backward, and ``workcount_dpt``'s DPT_Hybrid forward), over
the traced seconds times the published H100 float32 peak outside the
tensor cores."""

from gsbench import readers

SPANS = [readers.BINS]
note = readers.note_camera


def read(ctx, st, window):
    first, d = readers.traced_units(ctx), readers.trace(ctx)
    if d is None or first is None:
        return None
    drv = readers.driver(ctx)
    steps = drv.steps(ctx, st, readers.records(ctx, readers.BINS))
    if first >= len(steps):
        return None
    return readers.mfu(ctx, sum(drv.step_flops(st, v, p)
                                for v, p in steps[first:]), d["window_s"])
