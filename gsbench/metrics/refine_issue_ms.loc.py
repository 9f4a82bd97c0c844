"""Host milliseconds a refinement iteration spends issuing its render and
loss, backward, and Adam step with the retraction: the port's
``refine/render``, ``refine/backward`` and ``refine/step`` spans over the
traced queries, divided by their iterations (``refine_iters``). The rebin
and the convergence read are not in it."""

from gsbench import program_records


def read(ctx, st, window):
    return program_records.per_iteration_ms(
        ctx, ("refine/render", "refine/backward", "refine/step"))
