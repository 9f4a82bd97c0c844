"""The readings behind a cell's limits (``checks/<cell>.json``): sound runs
of the program on many seeds, then the control (the plain reference
computed in bfloat16, the precision below the configuration's float32, put
in the program's place) on a few, all in one process.

    python3 -m gsbench.calibrate --workload <cell> --seeds 12 --control 3 \\
        --seconds 10 [--first <seed>] [--config <config> --traffic <mix>]

Prints one JSON line per run and, last, each number's largest sound
reading, smallest control reading and their ratio. ``--fault`` plants one
of ``faults.py``'s faults in the program for every run: its readings are
then the fault's. A cell that ``BENCHMARK.json`` does not list yet is read
from ``--config`` and ``--traffic`` on one chip.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from gsbench import faults, registry, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--first", type=int, default=2_000_000_000)
    ap.add_argument("--fault", choices=[f.__name__ for f in
                                        faults.LOCALIZE + faults.TRAIN],
                    help="plant this fault in the program for every run")
    ap.add_argument("--config", help="configuration of an unlisted cell")
    ap.add_argument("--traffic", help="traffic mix of an unlisted cell")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gsbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = registry.benchmark()
    if args.config and args.workload not in {w["name"] for w in
                                             bench["workloads"]}:
        bench = dict(bench, workloads=bench["workloads"] + [
            {"name": args.workload, "config": args.config,
             "traffic": args.traffic, "chips": 1}])
    cell = registry.cell(bench, args.workload)
    no_limit = {k: math.inf for k in registry.limits(cell.name)}
    sound, control = {}, {}
    runs = [(args.first + 7919 * i, None) for i in range(args.seeds)]
    runs += [(args.first + 104729 * (i + 1), torch.bfloat16)
             for i in range(args.control)]
    patches = faults.Patches()
    if args.fault:
        getattr(faults, args.fault)(patches)
    for seed, ctl in runs:
        t0 = time.perf_counter()
        res = run.run_cell(cell, seed, args.seconds, False, "cuda",
                           limits=no_limit, control=ctl)
        vals = {k: c["value"] for k, c in res["checks"].items()}
        into = sound if ctl is None else control
        for k, v in vals.items():
            into.setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, "control": ctl is not None,
                          "checks": vals, "metrics": res["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    patches.undo()
    for k in sorted(set(sound) | set(control)):
        lo = max(sound.get(k, [float("nan")]))
        hi = min(control.get(k, [float("nan")]))
        print(json.dumps({"number": k, "lower": lo, "upper": hi,
                          "ratio": hi / lo if lo else math.inf}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
