"""Metrics logging: a JSONL scalar stream and timestamped stdout lines.

``MetricsLogger`` appends one JSON object per scalar to
``<log_dir>/metrics.jsonl`` (``{"t", "step", "tag", "value"}``), a
dependency-free stand-in for TensorBoard writers that converts to their
format simply.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import IO, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 also_stdout: bool = False):
        self._f: Optional[IO] = None
        self._stdout = also_stdout
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"t": time.time(), "step": int(step), "tag": tag,
               "value": float(value)}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        if self._stdout:
            print(f"[{step}] {tag} = {value:.6g}")

    def scalars(self, values: dict, step: int) -> None:
        """Each value that converts to a float (tensors of one element
        included); the others are skipped."""
        for k, v in values.items():
            try:
                self.scalar(k, float(v), step)
            except (TypeError, ValueError, RuntimeError):
                pass

    def flush(self) -> None:
        if self._f:
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def timestamped_print(msg: str) -> None:
    now = datetime.datetime.now().strftime("%d/%m %H:%M:%S")
    print(f"{msg} [{now}]")
