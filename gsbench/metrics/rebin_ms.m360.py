"""Stream milliseconds of a rebin at scene scale: the port's own
``refine/rebin`` span (``build_stream_pair_pack``: preprocess, stream
binning and the per-pair gather) over the traced queries, averaged over
the rebins."""

from gsbench import program_records


def read(ctx, st, window):
    u = program_records.units(ctx, "localize/batch")
    rebins = [] if u is None else [s for s in u.spans
                                   if s["name"] == "refine/rebin"]
    if not rebins:
        return None
    return sum(program_records.stream_ms(s) for s in rebins) / len(rebins)
