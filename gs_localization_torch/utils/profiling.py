"""Profiling helpers.

- ``StepTimer``: EMA step timing with iterations/s and Mpix/s. PyTorch
  returns before the card finishes, so pass a step's output to
  ``timer.sync(tensor)``: for a tensor on the card the step boundary is a
  CUDA event recorded on the current stream and waited for, and the step
  time is the device time between two boundaries; otherwise (a CPU tensor,
  or none) it is the host clock between two calls.
- ``trace(log_dir)``: ``torch.profiler`` over the block (CPU, and CUDA when
  a card is present), written as a Chrome trace to
  ``<log_dir>/trace.json``.

The JAX package's ``enable_persistent_compile_cache`` has no counterpart:
the port compiles nothing at run time beyond its kernel library, which is
built once and kept under a name keyed by a hash of its sources
(``gs_localization_torch/_kernels.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StepTimer:
    def __init__(self, ema: float = 0.6,
                 pixels_per_step: Optional[int] = None):
        self._ema_coef = ema
        self._pixels = pixels_per_step
        self._last_host: Optional[float] = None
        self._last_event: Optional[torch.cuda.Event] = None
        self.ema_ms: Optional[float] = None
        self.steps = 0

    def sync(self, tensor: Optional[torch.Tensor] = None) -> None:
        """Mark a step boundary after the work that produced ``tensor``."""
        event = None
        if tensor is not None and tensor.is_cuda:
            with torch.cuda.device(tensor.device):
                event = torch.cuda.Event(enable_timing=True)
                event.record()
            event.synchronize()
        now = time.perf_counter()
        if event is not None and self._last_event is not None:
            dt = self._last_event.elapsed_time(event)
        elif self._last_host is not None:
            dt = (now - self._last_host) * 1e3
        else:
            dt = None
        if dt is not None:
            self.ema_ms = dt if self.ema_ms is None else (
                self._ema_coef * dt + (1 - self._ema_coef) * self.ema_ms)
            self.steps += 1
        self._last_host, self._last_event = now, event

    @property
    def iters_per_s(self) -> Optional[float]:
        return None if not self.ema_ms else 1000.0 / self.ema_ms

    @property
    def mpix_per_s(self) -> Optional[float]:
        if not self.ema_ms or not self._pixels:
            return None
        return self._pixels / (self.ema_ms / 1e3) / 1e6

    def summary(self) -> str:
        parts = [f"{self.ema_ms:.1f} ms/it"] if self.ema_ms else []
        if self.iters_per_s:
            parts.append(f"{self.iters_per_s:.1f} it/s")
        if self.mpix_per_s:
            parts.append(f"{self.mpix_per_s:.1f} Mpix/s")
        return " | ".join(parts) if parts else "n/a"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
