"""Host milliseconds a refinement iteration waits for the device at its
convergence read: the port's ``refine/converge`` spans over the traced
queries, divided by their iterations (``refine_iters``)."""

from gsbench import program_records


def read(ctx, st, window):
    return program_records.per_iteration_ms(ctx, ("refine/converge",))
