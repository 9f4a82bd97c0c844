"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` (the stream blend K1/K2 and the pregathered blend
K3/K4, which share ``csrc/blend_common.cuh``; binning's slot-owner and
stream-placement kernels, ``csrc/binning.cu``; pose mode's projection P1
and its adjoint P2, ``csrc/pose_project.cu``) is compiled by ``nvcc`` at
first use, one process per source, all started together, and the objects
are linked into one shared library with a plain C interface in
``build/torch_kernels/`` beside the package. The library's name carries a
hash of every source and header and of the flags. It is loaded with
``ctypes``. Nothing here runs at import time, so the package imports on a
machine with neither ``nvcc`` nor a GPU.
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
from typing import List, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# no --use_fast_math: the blend gates are threshold tests
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of gs_localization_torch are built from source at first use")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libgsl_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    errors = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}: exit {proc.returncode}\n"
                          f"{out}{err}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def build() -> Optional[float]:
    """Compile the library if it is missing. Returns the seconds the build
    took, or None when the library was already built."""
    out = library_path()
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(obj)
        _run(procs)
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(lib, out)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        build()
        _LIB = ctypes.CDLL(str(library_path()))
        _LIB.gsl_error_string.argtypes = [ctypes.c_int]
        _LIB.gsl_error_string.restype = ctypes.c_char_p
        _LIB.gsl_kernel_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
        _LIB.gsl_kernel_info.restype = ctypes.c_int
    return _LIB


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's wrapper checks before passing its pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.gsl_error_string(rc).decode()})")


KERNELS = ("K1 stream_fwd", "K2 stream_bwd", "K3 pregathered_fwd",
           "K4 pregathered_bwd", "P1 pose_project_fwd", "P2 pose_project_bwd")


def kernel_info() -> dict:
    """For each of K1-K4 and P1/P2 (P2: its first pass), what the CUDA
    runtime reports: CTAs per SM at 256 threads
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread,
    shared memory per CTA (bytes; all use static shared memory only, the
    same at every chunk) and local memory per thread (spills, bytes)."""
    lib = load()
    info = {}
    for which, name in enumerate(KERNELS):
        out = (ctypes.c_int * 4)()
        rc = lib.gsl_kernel_info(which, out)
        if rc != 0:
            raise RuntimeError(f"kernel info of {name}: CUDA error {rc} "
                               f"({lib.gsl_error_string(rc).decode()})")
        info[name] = dict(ctas_per_sm=out[0], regs=out[1], smem=out[2],
                          local=out[3])
    return info
