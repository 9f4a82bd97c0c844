"""Stream milliseconds a refinement iteration spends in the per-pair
projection's forward (``render_pose_mode``'s ``render/project`` span:
every stream slot projected under the current pose) over the traced
queries, divided by their iterations (``refine_iters``). The projection's
backward runs inside ``refine/backward`` and is not in it."""

from gsbench import program_records


def read(ctx, st, window):
    u = program_records.units(ctx, "localize/batch")
    if u is None:
        return None
    spans = [s for s in u.spans if s["name"] == "render/project"]
    iters = program_records.counted(u, "refine_iters")
    if not spans or not iters:
        return None
    return sum(program_records.stream_ms(s) for s in spans) / iters
