"""The blend kernels' share of their roofline in few-shot training: the
least time the chip needs for the blend work of every traced step
(``workcount``: the step's view forward and backward, as
``blend_roofline.train`` counts it; on a pseudo step also the pseudo view's
forward twice, for the prior and in the graph, and its backward once),
walked over the map as it stood when the trace began, against the
published H100 peaks, over the blend kernels' device time in the trace."""

from gsbench import readers, workcount

SPANS = [readers.BINS]
note = readers.note_camera


def read(ctx, st, window):
    first, p = readers.traced_units(ctx), readers.peak(ctx)
    spent = readers.blend_kernel_s(ctx)
    if first is None or p is None or spent <= 0:
        return None
    drv = readers.driver(ctx)
    steps = drv.steps(ctx, st, readers.records(ctx, readers.BINS))
    if first >= len(steps):
        return None
    need = 0.0
    for view, pseudo in steps[first:]:
        need += workcount.blend_seconds(drv.work(st, view), p)
        if pseudo is not None:
            r = drv.work(st, pseudo)
            need += (workcount.blend_seconds(r, p) + workcount.min_seconds(
                r.blend_fwd_flops(), r.blend_fwd_bytes(), p)[0])
    return 100.0 * need / spent
