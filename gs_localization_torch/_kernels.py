"""Build, bind and launch the hand-written CUDA kernels.

Every ``csrc/*.cu`` (the stream blend K1/K2 and the pregathered blend
K3/K4, which share ``csrc/blend_common.cuh``; binning's slot-owner and
stream-placement kernels B1/B2, ``csrc/binning.cu``; pose mode's projection
P1 and its adjoint P2, ``csrc/pose_project.cu``; the refinement's pose
algebra A1/A2, V1/V2 and S1, ``csrc/pose_algebra.cu``) is compiled by
``nvcc`` at first use, one process per source, all started together, and
the objects are linked into one shared library with a plain C interface in
``build/torch_kernels/`` beside the package. The library's name carries a
hash of every source and header and of the flags. It is loaded with
``ctypes``. Nothing here runs at import time, so the package imports on a
machine with neither ``nvcc`` nor a GPU.

``TABLE`` holds one entry per C entry point: its C symbol, its argument
kinds, how a failed launch is described, the ``LAUNCHES`` key it is
counted under and, for a kernel whose occupancy ``kernel_info`` reports,
its label and the info function of its own ``.cu``. ``load`` binds every
symbol from it once; ``launch`` is the one place a kernel is called from
Python. The module that owns a kernel keeps its input checks, its output
allocation, the choice between the kernel and its plain version, and its
autograd ``Function``.

Adding a kernel: write its ``.cu`` with its C entry point in an ``extern
"C"`` block (the last parameter ``void* cuda_stream``, an ``int`` return
that is a ``cudaError_t``) and, to report its occupancy, an ``int
gsl_<name>_info(int which, int* out)`` there too; add its entry to
``TABLE``; call ``launch`` from its module's wrapper; add its tests. Nothing
else names it: ``LAUNCHES`` takes its key from the table, and
``tests/test_torch_kernel_abi.py`` holds the table to the sources.
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
from typing import Dict, List, NamedTuple, Optional

import torch

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


class Entry(NamedTuple):
    """A C entry point. ``args`` holds one kind per parameter before the
    trailing ``cudaStream_t``: ``p`` a pointer (a tensor's ``data_ptr``),
    ``i`` an ``int``, ``f`` a ``float``. ``counter`` is the ``LAUNCHES`` key
    when it is not the entry's own name. ``info`` is (label, info symbol,
    index) for a kernel that ``kernel_info`` reports."""
    symbol: str
    args: str
    what: str
    counter: Optional[str] = None
    info: Optional[tuple] = None


TABLE: Dict[str, Entry] = {
    "stream_fwd": Entry("gsl_stream_fwd", "ppppiiiippppp",
                        "stream blend forward launch",
                        info=("K1", "gsl_stream_info", 0)),
    "stream_bwd": Entry("gsl_stream_bwd", "ppppiiiipppppp",
                        "stream blend backward launch",
                        info=("K2", "gsl_stream_info", 1)),
    "pregathered_fwd": Entry("gsl_pregathered_fwd", "ppppiiiiippppp",
                             "pregathered blend forward launch",
                             info=("K3", "gsl_pregathered_info", 0)),
    "pregathered_bwd": Entry("gsl_pregathered_bwd", "ppppiiiiippppppp",
                             "pregathered blend backward launch",
                             info=("K4", "gsl_pregathered_info", 1)),
    "bin_owner": Entry("gsl_bin_owner", "piip", "slot owner launch"),
    "bin_place": Entry("gsl_bin_place", "ppppppiiiiiippp",
                       "stream placement launch"),
    # bin_place on int64 sort keys
    "bin_place64": Entry("gsl_bin_place64", "ppppppiiiiiippp",
                         "stream placement launch", counter="bin_place"),
    "pose_project_fwd": Entry("gsl_pose_project_fwd", "ppppiiifp",
                              "pose projection forward launch",
                              info=("P1", "gsl_pose_project_info", 0)),
    # P2: its first pass is the one kernel_info reports
    "pose_project_bwd": Entry("gsl_pose_project_bwd", "pppppiiipip",
                              "pose projection backward launch",
                              info=("P2", "gsl_pose_project_info", 1)),
    # the refinement's pose algebra, csrc/pose_algebra.cu: A1/A2, V1/V2, S1
    "se3_apply_fwd": Entry("gsl_se3_apply_fwd", "ppp",
                           "se3 retraction forward launch"),
    "se3_apply_bwd": Entry("gsl_se3_apply_bwd", "ppppp",
                           "se3 retraction backward launch"),
    "pose_vectors_fwd": Entry("gsl_pose_vectors_fwd", "pppppiiffpp",
                              "camera vectors forward launch"),
    "pose_vectors_bwd": Entry("gsl_pose_vectors_bwd", "ppppiiffpp",
                              "camera vectors backward launch"),
    "refine_adam": Entry("gsl_refine_adam", "pppppppppffffffff",
                         "refinement Adam step launch"),
}

# Launch counters of the hand-written kernels: ``launch`` adds one per
# launch, and nothing else does.
LAUNCHES: Dict[str, int] = dict.fromkeys(
    (e.counter or name for name, e in TABLE.items()), 0)

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
# name -> (function, the pointer arguments' positions, the argument count,
# what, counter)
_BOUND: Dict[str, tuple] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, with every entry
    point of ``TABLE`` and the helpers bound."""
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.gsl_error_string.argtypes = [ctypes.c_int]
        lib.gsl_error_string.restype = ctypes.c_char_p
        for name, e in TABLE.items():
            fn = getattr(lib, e.symbol)
            fn.argtypes = [_CTYPES[k] for k in e.args] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _BOUND[name] = (fn, [i for i, k in enumerate(e.args) if k == "p"],
                            len(e.args), e.what, e.counter or name)
            if e.info:
                info = getattr(lib, e.info[1])
                info.argtypes = [ctypes.c_int, ctypes.c_void_p]
                info.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def launch(name: str, device, *args) -> None:
    """Call ``TABLE[name]``'s entry point on ``device``'s current stream:
    tensors as their ``data_ptr()``, ints and floats as they are. Raises
    ``RuntimeError`` on a nonzero return; counts the launch in
    ``LAUNCHES``."""
    if _LIB is None:
        load()
    fn, ptrs, n, what, counter = _BOUND[name]
    if len(args) != n:
        raise TypeError(f"{name} takes {n} arguments, got {len(args)}")
    args = list(args)
    for i in ptrs:
        args[i] = args[i].data_ptr()
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    raise_on(rc, what)
    LAUNCHES[counter] += 1


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


def raise_on(rc: int, what: str) -> None:
    """Raise if a call returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({load().gsl_error_string(rc).decode()})")


def kernel_info() -> dict:
    """For each kernel of ``TABLE`` with an ``info`` (K1-K4, P1 and P2's
    first pass), what the CUDA runtime reports: CTAs per SM at 256 threads
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread,
    shared memory per CTA (bytes; all use static shared memory only, the
    same at every chunk) and local memory per thread (spills, bytes)."""
    lib = load()
    info = {}
    for name, e in TABLE.items():
        if e.info:
            label, symbol, which = e.info
            out = (ctypes.c_int * 4)()
            raise_on(getattr(lib, symbol)(which, out),
                     f"kernel info of {label} {name}")
            info[f"{label} {name}"] = dict(ctas_per_sm=out[0], regs=out[1],
                                           smem=out[2], local=out[3])
    return info
