"""Stream milliseconds of one call of the depth prior's network: the
port's own ``prior/net`` span (``ops/dpt.py::dpt_forward``, DPT_Hybrid at
384x512) over the traced steps, averaged over its calls."""

from gsbench import program_records


def read(ctx, st, window):
    u = program_records.units(ctx, "train/step")
    spans = [] if u is None else [s for s in u.spans
                                  if s["name"] == "prior/net"]
    if not spans:
        return None
    return sum(program_records.stream_ms(s) for s in spans) / len(spans)
