"""Share of the stream's slots that hold live pairs, at scene scale: the
rebins' live aligned lengths (``kept_al``, noted on each ``refine/rebin``
span) over the slots their streams hold (the ``stream_slots`` counter),
over the traced queries. The per-pair projection runs over every slot."""

from gsbench import program_records


def read(ctx, st, window):
    u = program_records.units(ctx, "localize/batch")
    if u is None:
        return None
    slots = program_records.counted(u, "stream_slots")
    live = [s["notes"]["kept_al"] for s in u.spans
            if s["name"] == "refine/rebin" and "kept_al" in s["notes"]]
    if not slots or not live:
        return None
    return 100.0 * sum(live) / slots
