"""Profiling: spans and counters inside the port, and a profiler trace.

Spans and counters record only while a ``torch.profiler`` is recording
(``torch.autograd._profiler_enabled()``), so the port has no setting for
them: a profile of any block records the program's phases with it. With
recording off, ``span`` returns one shared null context and ``count`` and
``note`` return at once: nothing is allocated, read from the device or
waited for.

- ``span(name, unit=None)``: a context manager around one phase. While
  recording it opens the profiler range ``gsloc/<name>``, so the range
  lands in the profiler's trace beside the kernels, on one clock, and
  keeps a record: ``id``, ``name``, ``parent`` (the innermost
  open span's id), ``unit`` (the unit of work the span serves, such as a
  batch's query names or a training iteration; inherited from the
  innermost open span when not given), ``host_start_ns`` and
  ``host_end_ns`` (``time.time_ns()``, the clock of the profiler's
  ``start_ns()``), ``counts`` (what ``count`` added while the span was the
  innermost open one), ``notes`` (what ``note`` gave it) and, once the
  CUDA runtime is up, ``stream_ms``: two CUDA events recorded on the
  current stream at entry and exit, the stream time from the span's first
  queued operation to its last, which counts the device's waits for the
  host inside it. A span never synchronises: the events are read by
  ``records()``. A span's self time is its duration less what its
  children cover. The range is a plain CPU range
  (``torch._C._profiler._RecordFunctionFast``), not
  ``torch.profiler.record_function``'s user annotation, which the
  profiler also lays over the device timeline as a device event and which
  would then count as device activity in every reading of device busy
  and idle time.
- ``count(name, n=1)``: add the host integer ``n`` to a counter and to the
  innermost open span's ``counts``. The port counts ``host_sync/<site>``
  (the host waits for the device: a value read to the host on every
  device, and on CUDA an operation that blocks though it reads nothing,
  such as a boolean-mask index or a copy from pageable memory),
  ``upload_bytes`` (host arrays copied into tensors) and the work counters
  named where they are made.
- ``upload(a, device)``: a float32 copy of host array ``a`` on ``device``,
  counted in ``upload_bytes``.
- ``host_read(site, t)``: ``t.item()``, counted as ``host_sync/<site>``;
  ``count_wait(site, device, n=1)``: ``n`` operations that wait for a CUDA
  device though they read nothing, counted the same way.
- ``note(**fields)``: add fields to the innermost open span's ``notes``.
  A field may be a device tensor of one element, kept as it is (no wait)
  and read to the host by ``records()``.
- ``records()``: a snapshot ``{"spans": [...], "counters": {...}}``, spans
  in the order they opened. Call it once the device is synchronised: an
  event the stream has not reached reads ``stream_ms`` None. ``reset()``
  drops what was recorded.
- ``trace(log_dir)``: ``torch.profiler`` over the block (CPU, and CUDA when
  a card is present), recording from a reset. On exit it writes
  ``<log_dir>/trace.json`` (a Chrome trace, ``gsloc/`` ranges included)
  and ``<log_dir>/spans.json``::

      {"spans": [...], "counters": {...},        # records()
       "by_name": {name: {"count", "host_ms", "self_host_ms", "stream_ms",
                          "device_idle_ms", "self_device_idle_ms"}},
       "device": {"activities", "busy_ms", "window_ms", "idle_ms"}}

  ``device_idle_ms`` is the time inside the name's ``gsloc/`` ranges, as
  the profile timed them, in which the device ran nothing (the ranges less
  the union of the profile's kernel, copy and set intervals: one clock);
  ``self_device_idle_ms`` is that less what the spans' children cover, the
  idle time filed under the name as the innermost ``gsloc/`` range. The
  window runs from the profile's first event to its last; ``idle_ms`` less
  the root spans' ``device_idle_ms`` is the idle time outside every span.
  Device figures are None when the profile holds no device activity.

The JAX package's ``enable_persistent_compile_cache`` has no counterpart:
the port compiles nothing at run time beyond its kernel library, which is
built once and kept under a name keyed by a hash of its sources
(``gs_localization_torch/_kernels.py``).
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class _Recorder:
    """What the spans and counters of this process recorded."""

    def __init__(self):
        self.spans: List[dict] = []
        self.counters: Dict[str, int] = {}
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> List[dict]:
        """This thread's open spans, innermost last."""
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "unit", "rec", "rf")

    def __init__(self, name: str, unit):
        self.name, self.unit = name, unit

    def __enter__(self):
        stack = _REC.stack()
        top = stack[-1] if stack else None
        rec = {"id": next(_REC.ids), "name": self.name,
               "parent": None if top is None else top["id"],
               "unit": (self.unit if self.unit is not None
                        else None if top is None else top["unit"]),
               "counts": {}, "notes": {}, "host_end_ns": None}
        self.rf = torch._C._profiler._RecordFunctionFast("gsloc/" + self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["_events"] = (ev,)
        rec["host_start_ns"] = time.time_ns()
        stack.append(rec)
        _REC.spans.append(rec)
        self.rec = rec

    def __exit__(self, *exc):
        rec = self.rec
        rec["host_end_ns"] = time.time_ns()
        if "_events" in rec:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["_events"] += (ev,)
        self.rf.__exit__(*exc)
        _REC.stack().pop()
        return False


def span(name: str, unit=None):
    """A context manager around one phase named ``name``; ``unit`` names
    the unit of work it serves (module docstring)."""
    if not _enabled():
        return _NULL
    return _Span(name, unit)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to counter ``name`` while recording."""
    if not _enabled():
        return
    _REC.counters[name] = _REC.counters.get(name, 0) + n
    stack = _REC.stack()
    if stack:
        counts = stack[-1]["counts"]
        counts[name] = counts.get(name, 0) + n


def host_read(site: str, t: torch.Tensor):
    """``t.item()``: one value read to the host, which waits for the
    device; counted as ``host_sync/<site>``."""
    count("host_sync/" + site)
    return t.item()


def upload(a, device) -> torch.Tensor:
    """A float32 copy of host array ``a`` on ``device``, counted in
    ``upload_bytes``."""
    a = np.asarray(a, np.float32)
    count("upload_bytes", a.nbytes)
    return torch.tensor(a, device=device)


def count_wait(site: str, device: torch.device, n: int = 1) -> None:
    """Count ``n`` operations at ``site`` that wait for the device on CUDA
    though they read nothing to the host (a boolean-mask index or
    ``nonzero``, a copy from pageable memory) as ``host_sync/<site>``;
    nothing on the CPU, where they wait for nothing."""
    if device.type == "cuda":
        count("host_sync/" + site, n)


def note(**fields) -> None:
    """Add ``fields`` (host values, or one-element tensors read by
    ``records()``) to the innermost open span's notes while recording."""
    if not _enabled():
        return
    stack = _REC.stack()
    if stack:
        stack[-1]["notes"].update(fields)


def _stream_ms(rec: dict) -> Optional[float]:
    ev = rec.get("_events", ())
    if len(ev) != 2 or not ev[1].query():
        return None
    return ev[0].elapsed_time(ev[1])


def _host(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def records() -> dict:
    """A snapshot of the spans and counters recorded since the last
    ``reset()`` (module docstring)."""
    spans = []
    for rec in list(_REC.spans):
        out = {k: v for k, v in rec.items() if k != "_events"}
        out["counts"] = dict(rec["counts"])
        out["notes"] = {k: _host(v) for k, v in rec["notes"].items()}
        out["stream_ms"] = _stream_ms(rec)
        spans.append(out)
    return {"spans": spans, "counters": dict(_REC.counters)}


def reset() -> None:
    """Drop every span and counter recorded so far."""
    _REC.spans = []
    _REC.counters = {}


def self_host_ms(spans: List[dict]) -> Dict[int, float]:
    """Each closed span's host duration less what its children cover, by
    id (children run one after another on their parent's thread)."""
    dur = {s["id"]: (s["host_end_ns"] - s["host_start_ns"]) / 1e6
           for s in spans if s["host_end_ns"] is not None}
    own = dict(dur)
    for s in spans:
        if s["parent"] in own and s["id"] in dur:
            own[s["parent"]] -= dur[s["id"]]
    return own


def _profile_times(prof):
    """From one profile: the union of its device intervals (ns, sorted),
    its ``gsloc/`` ranges by span name (start order) and its first and
    last instant, all on the profile's clock."""
    from torch.autograd import DeviceType

    ivs, ranges, lo, hi = [], {}, None, None
    for ev in prof.profiler.kineto_results.events():
        try:
            s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        except AttributeError:                  # older kineto bindings
            s, e = 1000 * ev.start_us(), 1000 * (ev.start_us()
                                                  + ev.duration_us())
        lo = s if lo is None else min(lo, s)
        hi = e if hi is None else max(hi, e)
        if ev.device_type() == DeviceType.CUDA:
            ivs.append((s, e))
        elif ev.name().startswith("gsloc/"):
            ranges.setdefault(ev.name()[6:], []).append((s, e))
    merged: List[List[int]] = []
    for s, e in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for r in ranges.values():
        r.sort()
    return merged, ranges, (lo or 0, hi or 0)


def _paired(spans: List[dict], ranges: Dict[str, list]) -> Dict[int, tuple]:
    """Each span's own ``gsloc/`` range in the profile, by id: the k-th
    span of a name opened is that name's k-th range (a name whose counts
    differ is left out)."""
    mine: Dict[str, List[dict]] = {}
    for s in spans:
        mine.setdefault(s["name"], []).append(s)
    out = {}
    for name, recs in mine.items():
        if len(ranges.get(name, ())) == len(recs):
            out.update((r["id"], v) for r, v in zip(recs, ranges[name]))
    return out


def _busy_within(merged, starts, prefix, s: int, e: int) -> int:
    """Busy ns of the sorted disjoint intervals ``merged`` inside [s, e)."""
    lo = max(bisect.bisect_right(starts, s) - 1, 0)
    hi = bisect.bisect_left(starts, e)
    if e <= s or lo >= hi:
        return 0
    total = prefix[hi] - prefix[lo]
    a, b = merged[lo]
    total -= max(0, min(b, s) - a)          # the first's part before s
    a, b = merged[hi - 1]
    total -= max(0, b - max(a, e))          # the last's part after e
    return total


def summarize(rec: dict, merged: List[List[int]],
              ranges: Dict[int, tuple], window: tuple = (0, 0)) -> dict:
    """``spans.json``'s content from ``records()``, a profile's merged
    device intervals, each span's range on the profile's clock by id and
    the profile's first and last instant (module docstring)."""
    spans = [s for s in rec["spans"] if s["host_end_ns"] is not None]
    own = self_host_ms(spans)
    idle = {}
    if merged:
        starts = [a for a, _ in merged]
        prefix = [0]
        for a, b in merged:
            prefix.append(prefix[-1] + b - a)
        for sid, (lo, hi) in ranges.items():
            idle[sid] = (hi - lo - _busy_within(merged, starts, prefix,
                                                 lo, hi)) / 1e6
    self_idle = dict(idle)
    for s in spans:
        if s["parent"] in self_idle and s["id"] in idle:
            self_idle[s["parent"]] -= idle[s["id"]]
    by_name: Dict[str, dict] = {}
    for s in spans:
        d = by_name.setdefault(s["name"], {
            "count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
            "stream_ms": None, "device_idle_ms": None,
            "self_device_idle_ms": None})
        d["count"] += 1
        d["host_ms"] += (s["host_end_ns"] - s["host_start_ns"]) / 1e6
        d["self_host_ms"] += own[s["id"]]
        for key, v in (("stream_ms", s["stream_ms"]),
                       ("device_idle_ms", idle.get(s["id"])),
                       ("self_device_idle_ms", self_idle.get(s["id"]))):
            if v is not None:
                d[key] = (d[key] or 0.0) + v
    busy = sum(b - a for a, b in merged) / 1e6
    return {"spans": rec["spans"], "counters": rec["counters"],
            "by_name": by_name,
            "device": {"activities": len(merged), "busy_ms": busy,
                       "window_ms": (window[1] - window[0]) / 1e6,
                       "idle_ms": ((window[1] - window[0]) / 1e6 - busy
                                   if merged else None)}}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and record its spans from a reset; yields the
    ``torch.profiler.profile`` object and writes ``trace.json`` and
    ``spans.json`` into ``log_dir`` (module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    rec = records()
    merged, ranges, window = _profile_times(prof)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(summarize(rec, merged, _paired(rec["spans"], ranges),
                            window), f)
