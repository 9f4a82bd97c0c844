"""Host milliseconds of a pseudo step's pseudo branch in ``train_map``:
the port's ``train/pseudo`` span (the pseudo render without gradients,
its colour's readback, the prior, its readback and upload) over the traced
steps, averaged over the pseudo steps."""

from gsbench import program_records


def read(ctx, st, window):
    u = program_records.units(ctx, "train/step")
    spans = [] if u is None else [s for s in u.spans
                                  if s["name"] == "train/pseudo"]
    if not spans:
        return None
    return sum(program_records.host_ms(s) for s in spans) / len(spans)
