"""Refinement iterations per query at scene scale: ``num_iters`` of the
``RefineResult`` whose pose each window query returned, averaged."""

from gsbench import readers


def read(ctx, st, window):
    its = readers.query_iters(st)
    return sum(its) / len(its) if its else None
