"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over the
first whole units of the window, reduced to what the metrics read.

Busy time is the union of the device's kernel, copy and set intervals;
idle gaps are attributed to the innermost host operation that was running
at their middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _span_ns(ev):
    try:
        return ev.start_ns(), ev.duration_ns()
    except AttributeError:                  # older kineto bindings
        return 1000 * ev.start_us(), 1000 * ev.duration_us()


def _union(intervals):
    busy, end = 0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        busy += e - s
    return busy, merged


def digest(prof, window_s: float, top: int = 10) -> dict:
    """busy_s, window_s, kernels {name: seconds}, device_ops, idle_gaps,
    activities."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, d = _span_ns(ev)
        if ev.device_type() == DeviceType.CUDA:
            dev.append((s, s + d, ev.name()))
        elif ev.name().startswith("aten::") or ev.name().startswith("cuda"):
            host.append((s, s + d, ev.name()))
    kernels: Dict[str, float] = defaultdict(float)
    for s, e, name in dev:
        kernels[name] += (e - s) * 1e-9
    busy_ns, merged = _union([(s, e) for s, e, _ in dev])
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) // 2
        name = "host: Python between operations"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += (s1 - e0) * 1e-9

    def ranked(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return dict(busy_s=busy_ns * 1e-9, window_s=window_s,
                  kernels=dict(kernels), device_ops=ranked(kernels),
                  idle_gaps=ranked(gaps), activities=len(dev))


def warm_up(device: torch.device) -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    initialisation, several seconds) falls outside the window."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.zeros(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class DeviceTrace:
    """Profiles the last whole units of the window: from the first unit
    boundary at which at most ``min_seconds`` of the window remain, until
    the window closes, which in a traced run waits until the trace has run
    ``min_seconds``. The profiler's own processing runs after the close."""

    def __init__(self, device: torch.device, min_seconds: float):
        self.device = device
        self.min_seconds = min_seconds
        self.prof = None
        self.result: Optional[dict] = None
        self.first_unit: Optional[int] = None   # first window unit traced

    def maybe_start(self, next_unit: int, remaining_s: float) -> None:
        if self.prof is None and self.result is None \
                and remaining_s <= self.min_seconds:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.first_unit = next_unit
            self.t0 = time.perf_counter()

    def covered(self) -> bool:
        """The trace has run for ``min_seconds``."""
        return self.prof is not None and (
            time.perf_counter() - self.t0 >= self.min_seconds)

    def stop(self, t_close: float) -> None:
        """Called once the window has closed at ``t_close`` (synchronised)."""
        if self.prof is None:
            return
        self.prof.__exit__(None, None, None)
        self.result = digest(self.prof, t_close - self.t0)
        self.prof = None
