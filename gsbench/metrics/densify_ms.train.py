"""Milliseconds per densification round: the span around
``densify_and_prune`` as ``train_map`` calls it, summed over the window's
calls and divided by its rounds (a call that dropped Gaussians for want of
capacity is redone after a growth, in the same round)."""

from gsbench import readers

SPANS = [readers.DENSIFY]


def note(args, kwargs, out):
    return {"dropped": out[3].dropped}     # read once the window has closed


def read(ctx, st, window):
    recs = readers.records(ctx, readers.DENSIFY)
    rounds = sum(int(r["dropped"]) == 0 for r in recs)
    return sum(r["ms"] for r in recs) / rounds if rounds else None
