"""Spans around the program's public functions, installed for a traced run.

A span replaces a module attribute (``package.module.function``) with a
wrapper that records a CUDA event on the current stream, calls the
function, and records a second event, and keeps whatever small notes the
metrics that read it take from the call (``note(args, kwargs, result) ->
dict``; a note keeps device values as tensors and never reads them, so that
no span waits for the device). The events' elapsed milliseconds are read
once the window has closed and the device is synchronised (``finish``):
the stream time from the call's first queued operation to its last, which
counts the device's waits for the host inside the call. The program looks
these functions up at call time, so the wrapper sees every call. Nothing is
installed in an untraced run.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch


class Spans:
    def __init__(self, device: torch.device):
        self.device = device
        self.records: Dict[str, List[dict]] = defaultdict(list)
        self._installed = []

    def install(self, path: str, notes: List[Callable]) -> None:
        mod_name, attr = path.rsplit(".", 1)
        mod = importlib.import_module(mod_name)
        inner = getattr(mod, attr)
        records = self.records[path]
        cuda = self.device.type == "cuda"

        def span(*args, **kwargs):
            rec = {}
            if cuda:
                rec["events"] = (torch.cuda.Event(enable_timing=True),
                                 torch.cuda.Event(enable_timing=True))
                rec["events"][0].record()
            else:
                t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            if cuda:
                rec["events"][1].record()
            else:
                rec["ms"] = 1e3 * (time.perf_counter() - t0)
            for note in notes:
                rec.update(note(args, kwargs, out))
            records.append(rec)
            return out

        setattr(mod, attr, span)
        self._installed.append((mod, attr, inner))

    def uninstall(self) -> None:
        for mod, attr, inner in reversed(self._installed):
            setattr(mod, attr, inner)
        self._installed.clear()

    def finish(self) -> None:
        """Read each call's elapsed milliseconds (the device is synchronised
        by then)."""
        for recs in self.records.values():
            for rec in recs:
                ev = rec.pop("events", None)
                if ev is not None:
                    rec["ms"] = ev[0].elapsed_time(ev[1])
