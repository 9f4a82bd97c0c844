"""Milliseconds of binning per training step: the span around
``rasterize.bins_for`` (the stream binning of raster/binning.py), summed
over the window and divided by its steps."""

from gsbench import readers

SPANS = [readers.BINS]
note = readers.note_camera


def read(ctx, st, window):
    recs = readers.records(ctx, readers.BINS)
    if not recs or not window["attempted"]:
        return None
    return sum(r["ms"] for r in recs) / window["attempted"]
