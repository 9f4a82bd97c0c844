"""The whole localization loop's share of the chip's float32 peak at scene
scale: the operations every window query needs (``workcount``: its
iterations, each a pose-mode projection, blend and loss forward and
backward, and its rebins), over the window's seconds times the published
H100 float32 peak outside the tensor cores."""

from gsbench import readers


def read(ctx, st, window):
    its = readers.query_iters(st)
    drv = readers.driver(ctx)
    return readers.mfu(ctx, sum(drv.flops(st, q, n) for q, n in
                                zip(window["units"], its)),
                       window["window_s"])
