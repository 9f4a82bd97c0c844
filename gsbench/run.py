"""Run one benchmark cell once and print its result line.

    python3 -m gsbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a traffic mix; the
mix names its driver, which makes the map, the traffic and the reference's
inputs from the seed, warms up, and measures whole units (queries or
training steps) until ``--seconds`` have passed. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read from
spans around the program's functions (installed for the window only) and a
device trace of the window's last units. Either way the run then compares
what the window produced with the plain reference (``reference/``) and
prints each number compared beside its limit, last on standard error and
last in the result line. The last line of standard output is the result.

Needs CUDA with as many cards as the cell asks for; without them it exits
with code 2 and prints no result. It never falls back to the CPU.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(l.split()[1]) for l in f if l.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()

# keep CUPTI set up between the profiler's warm-up start and the traced
# window's (torch tears it down after each profile by default, and a lazy
# re-initialisation near the window's close can start late and record no
# device activity)
os.environ.setdefault("TEARDOWN_CUPTI", "0")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gs_localization_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


class Ctx:
    """What a driver sees of the harness: the cell, the seed, the window's
    clock, the spans and the device trace."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float):
        import torch

        from .spans import Spans
        from .trace import DeviceTrace

        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.spans = Spans(self.device)
        self.device_trace = DeviceTrace(
            self.device, float(self.traffic.get("trace_seconds", 2.0)))
        self.t0 = self.t1 = None
        self.units = 0

    def log(self, line: str) -> None:
        """The program's log lines: not read (what a run needs of the
        program it takes from its results)."""

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_window(self) -> None:
        if self.trace:
            from . import registry
            from .trace import warm_up

            warm_up(self.device)     # the profiler's first start takes seconds

            notes = {}
            for m in self.cell.per_layer:
                mod = registry.metric(m["name"])
                for path in getattr(mod, "SPANS", ()):
                    notes.setdefault(path, [])
                    if hasattr(mod, "note"):
                        notes[path].append(mod.note)
            for path, fns in sorted(notes.items()):
                self.spans.install(path, fns)
        self.sync()
        self.t0 = time.perf_counter()
        self.setup_s = time.time() - self.t_start
        if self.trace:
            self.device_trace.maybe_start(0, self.seconds)

    def unit_done(self) -> bool:
        """Count a finished unit; True once the window is over. A traced
        run's window lasts until the device trace has covered its whole
        length too (a long unit or a slow profiler start near the close
        would leave it short); a traced run reports no end-to-end metric."""
        self.units += 1
        elapsed = time.perf_counter() - self.t0
        if self.trace:
            self.device_trace.maybe_start(self.units, self.seconds - elapsed)
            return elapsed >= self.seconds and self.device_trace.covered()
        return elapsed >= self.seconds

    def end_window(self) -> float:
        self.sync()
        self.t1 = time.perf_counter()
        self.spans.uninstall()
        self.spans.finish()
        if self.trace:
            self.device_trace.stop(self.t1)
        return self.t1 - self.t0


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, limits: dict | None = None,
             control=None) -> dict:
    """Run one cell; returns the result dict (without printing). ``limits``
    replaces the cell's ``checks/<cell>.json`` limits; ``control`` (a
    dtype) puts the reference computed in that dtype in the program's place
    in the comparison (``calibrate``)."""
    import torch

    from . import registry

    t_start = time.time() if t_start is None else t_start
    ctx = Ctx(cell, seed, seconds, trace, device, t_start)
    ctx.limits = registry.limits(cell.name) if limits is None else limits
    drv = registry.driver(cell.traffic["driver"])
    state = drv.setup(ctx)
    window = drv.run_window(ctx, state)
    dev = ctx.device
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    bad = loaded_forbidden()
    if bad:
        raise RuntimeError(f"the run loaded {', '.join(bad)}")

    metrics = {}
    if not trace:
        values = dict(window["end_to_end"], setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = registry.metric(m["name"]).read(ctx, state, window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace and ctx.device_trace.result is not None:
        d = ctx.device_trace.result
        device_info["busy_s"] = d["busy_s"]
        device_info["window_s"] = d["window_s"]
        breakdown = {"device_ops": d["device_ops"],
                     "idle_gaps": d["idle_gaps"]}

    t_check = time.perf_counter()
    checks = drv.check(ctx, state, window, control)
    for c in checks.values():          # a result line holds numbers only
        if not math.isfinite(c["value"]):
            c["value"] = sys.float_info.max
    print(f"gsbench: {cell.name} seed {seed}: set-up {ctx.setup_s:.3f} s, "
          f"window {window['window_s']:.3f} s ({window['attempted']} units), "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": bool(correct and window["failed"] == 0),
              "attempted": int(window["attempted"]),
              "failed": int(window["failed"]),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import registry

    cell = registry.cell(registry.benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"gsbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
