"""Build and load the hand-written CUDA kernels.

``csrc/stream_blend.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface, at first use, into ``build/torch_kernels/`` beside the
package, keyed by a hash of the source and the flags. The library is loaded
with ``ctypes``. Nothing here runs at import time, so the package imports
on a machine with neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "stream_blend.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# no --use_fast_math: the blend gates are threshold tests
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of gs_localization_torch are built from source at first use")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{SOURCE.stem}_{digest}.so"


def build() -> Optional[float]:
    """Compile the library if it is missing. Returns the seconds ``nvcc``
    took, or None when the library was already built."""
    out = library_path()
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        build()
        _LIB = ctypes.CDLL(str(library_path()))
    return _LIB
