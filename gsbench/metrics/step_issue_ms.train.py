"""Host milliseconds a training step spends in ``train/step`` and its
children (sampling the view, render, loss, backward, Adam) less the image
load, over the traced steps: the capacity audit and the densification
rounds lie outside the span."""

from gsbench import program_records


def read(ctx, st, window):
    u = program_records.units(ctx, "train/step")
    if u is None:
        return None
    load = sum(program_records.host_ms(s) for s in u.spans
               if s["name"] == "train/load")
    return (sum(program_records.host_ms(s) for s in u.roots)
            - load) / len(u.roots)
