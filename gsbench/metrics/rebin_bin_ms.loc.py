"""Stream milliseconds of a rebin's binning: the port's ``rebin/bin`` span
(``bin_stream``: the sorts, ``cummax``, the search and the aligned
layout's writes) over the traced queries, averaged over the rebins."""

from gsbench import program_records


def read(ctx, st, window):
    u = program_records.units(ctx, "localize/batch")
    bins = [] if u is None else [s for s in u.spans
                                 if s["name"] == "rebin/bin"]
    if not bins:
        return None
    return sum(program_records.stream_ms(s) for s in bins) / len(bins)
