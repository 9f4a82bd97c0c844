"""Trace a cell's units with the port's own spans on the card: the split
of the device's idle time by the innermost ``gsloc/`` range, and every
span's host, self and stream time (``utils/profiling.py::trace``).

    python3 -m gsbench.spans_trace --workload <cell> --seed <n> \\
        --units <k> [--first <step>] --out <dir>

The cell's inputs come from the seed as in a run (``drivers/<driver>.py``
``setup``). A localization cell then runs 5 queries, and ``k`` more under
``profiling.trace``; a training cell trains and traces steps ``first``
(default 21, after the cell's warm-up) to ``first + k - 1``, with the
audit and any densification round that follow the last. Writes ``<dir>/trace.json``,
``<dir>/spans.json`` and ``<dir>/digest.json`` (the traced seconds and
units, and ``trace.digest`` of the same profile: busy time, top device
operations, idle gaps by host operation); prints the idle split.
"""

from __future__ import annotations

import os

# as gsbench.run: keep CUPTI set up between profiles
os.environ.setdefault("TEARDOWN_CUPTI", "0")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402


def _timed(fn, dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t


def trace_units(cell, seed: int, units: int, out: str, device="cuda",
                first: int = 21) -> dict:
    """Trace ``units`` units of ``cell`` into ``out``; returns the digest
    written to ``digest.json``."""
    from gs_localization_torch.pipelines import train_map as tm
    from gs_localization_torch.utils import profiling

    from . import registry, run
    from .trace import digest, warm_up

    ctx = run.Ctx(cell, seed, 1.0, False, device, time.time())
    drv = registry.driver(cell.traffic["driver"])
    st = drv.setup(ctx)
    dev = ctx.device
    warm_up(dev)
    box = {}
    if cell.traffic["driver"] == "localize":
        n = len(st.queries)

        def queries(m, k0):
            for k in range(k0, k0 + m):
                drv._call(ctx, st, st.queries[st.order[k % n]])

        queries(5, 0)
        with profiling.trace(out) as prof:
            box["seconds"] = _timed(lambda: queries(units, 5), dev)
    else:
        first = max(first, 2)
        st.tcfg.iterations = first + units - 1

        def hook(it, aux):
            if it == first - 1:
                box["cm"] = profiling.trace(out)
                box["prof"] = box["cm"].__enter__()
                box["t"] = time.perf_counter()

        tm.train_map(st.scene, None, st.tcfg, st.mcfg, st.rcfg,
                     image_loader=lambda info: st.images[info.uid],
                     log_fn=lambda s: None, device=dev, step_hook=hook)
        ctx.sync()
        box["seconds"] = time.perf_counter() - box["t"]
        box["cm"].__exit__(None, None, None)
        prof = box["prof"]
    d = digest(prof, box["seconds"])
    res = {"workload": cell.name, "seed": seed, "units": units,
           "first": first, "seconds": box["seconds"],
           "busy_s": d["busy_s"], "activities": d["activities"],
           "device_ops": d["device_ops"], "idle_gaps": d["idle_gaps"]}
    with open(os.path.join(out, "digest.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, required=True)
    ap.add_argument("--first", type=int, default=21)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from . import registry

    if not torch.cuda.is_available():
        print("gsbench.spans_trace: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = registry.cell(registry.benchmark(), args.workload)
    res = trace_units(cell, args.seed, args.units, args.out, "cuda",
                      args.first)
    with open(os.path.join(args.out, "spans.json")) as f:
        spans = json.load(f)
    dev = spans["device"]
    print(f"{args.workload}: {res['units']} units, {res['seconds']:.3f} s, "
          f"device busy {res['busy_s']:.3f} s, idle {dev['idle_ms']} ms")
    for name, v in sorted(spans["by_name"].items(),
                          key=lambda kv: -(kv[1]["self_device_idle_ms"]
                                           or 0.0)):
        print(f"  {name:20s} x{v['count']:<5d} host {v['host_ms']:9.1f} "
              f"self {v['self_host_ms']:9.1f} stream "
              f"{v['stream_ms'] or 0.0:9.1f} idle (innermost) "
              f"{v['self_device_idle_ms'] or 0.0:9.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
