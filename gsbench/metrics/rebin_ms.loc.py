"""Milliseconds per rebin: the span around ``build_stream_pair_pack``
(preprocess, stream binning and the gather of pose-independent parameters
per pair), averaged over the window's calls."""

from gsbench import readers

SPANS = [readers.REBIN]


def read(ctx, st, window):
    recs = readers.records(ctx, readers.REBIN)
    return sum(r["ms"] for r in recs) / len(recs) if recs else None
