"""What the port recorded of itself in a traced window: the spans and
counters of ``gs_localization_torch.utils.profiling``, which record only
while a ``torch.profiler`` is recording, so in a traced run they cover the
units the device trace covers. The readers of the in-program metrics take
their bodies from here.

A unit is what one ``localize/batch`` or ``train/step`` span serves (a
batch's query names, a training iteration); every span of the unit shares
its id, so a unit's counts are the counts of all its spans. A program
without the recorder (a commit before it) gives nothing, and the readers
return None.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional


class Units(NamedTuple):
    roots: List[dict]     # the units' root spans, in order
    spans: List[dict]     # every span of those units


def recorded(ctx) -> Optional[List[dict]]:
    """The closed spans the program recorded since the device trace of
    this run began, or None."""
    from gs_localization_torch.utils import profiling

    records = getattr(profiling, "records", None)
    t0 = getattr(ctx.device_trace, "t0", None)
    if records is None or t0 is None:
        return None
    # the trace's start on the spans' clock (time.time_ns)
    start_ns = time.time_ns() - int((time.perf_counter() - t0) * 1e9)
    return [s for s in records()["spans"]
            if s["host_end_ns"] is not None
            and s["host_start_ns"] >= start_ns - 100_000_000]


def units(ctx, root: str) -> Optional[Units]:
    """The recorded units whose root span is named ``root``, or None."""
    spans = recorded(ctx)
    if not spans:
        return None
    roots = [s for s in spans if s["name"] == root]
    if not roots:
        return None
    ids = {s["unit"] for s in roots}
    return Units(roots, [s for s in spans if s["unit"] in ids])


def host_ms(s: dict) -> float:
    return (s["host_end_ns"] - s["host_start_ns"]) / 1e6


def stream_ms(s: dict) -> float:
    """The span's stream time; its host time where no card timed it (a
    run on the CPU)."""
    return host_ms(s) if s["stream_ms"] is None else s["stream_ms"]


def counted(u: Units, prefix: str) -> int:
    """The units' counts whose names start with ``prefix``."""
    return sum(v for s in u.spans for k, v in s["counts"].items()
               if k.startswith(prefix))


def queries(u: Units) -> int:
    return sum(s["notes"].get("queries", 1) for s in u.roots)


def per_query(ctx, prefix: str, scale: float = 1.0) -> Optional[float]:
    """Counts starting with ``prefix`` a localization query, × ``scale``."""
    u = units(ctx, "localize/batch")
    if u is None:
        return None
    return scale * counted(u, prefix) / queries(u)


def per_iteration_ms(ctx, names) -> Optional[float]:
    """Host ms of the spans named in ``names`` a refinement iteration."""
    u = units(ctx, "localize/batch")
    iters = None if u is None else counted(u, "refine_iters")
    if not iters:
        return None
    return sum(host_ms(s) for s in u.spans if s["name"] in names) / iters
