"""gs_localization_torch — the PyTorch/CUDA port of gs_localization_tpu.

Same sub-packages and module names as the JAX package, so each counterpart
is found by path:

- ``core``      : cameras, SE(3), spherical harmonics, Gaussian parameters.
- ``raster``    : preprocess, binning (pair stream or per-tile id matrix), the
                  stream and pregathered blends (hand-written CUDA kernels
                  for sm_90a, plain PyTorch on the CPU), pose mode.
- ``data``      : Gaussian map PLY files, COLMAP models and databases,
                  scenes (COLMAP, 7-Scenes, Blender), RGB-D point clouds,
                  the native threaded image loader.
- ``ops``       : image-gradient tracking masks, SSIM, LPIPS, k-NN
                  distances, undistortion, JAX's image resize, the
                  DPT_Hybrid and MiDaS depth priors.
- ``mapping``   : map training: losses, per-group Adam, densification,
                  few-shot pseudo views.
- ``loc``       : gradient-descent pose refinement.
- ``sfm``       : the SfM front end: classical (Harris / SIFT features,
                  matching, retrieval, triangulation, PnP, bundle
                  adjustment, incremental mapping) and learned
                  (SuperPoint, SuperGlue, LightGlue, LoFTR, D2-Net, R2D2,
                  DISK, NetVLAD, DIR, OpenIBL, EigenPlaces; the checkpoint
                  manifest and hloc's conf registry), pose-error metrics,
                  pose-result files.
- ``pipelines`` : query localization, map training, SfM initialization,
                  the scene runner.
- ``utils``     : configs, metrics logging, profiling, a web viewer.

Device policy: entry points that create tensors take ``device="cuda"`` by
default and raise when CUDA is absent; pass ``device="cpu"`` to run the plain
PyTorch versions. Everything downstream follows the device of its tensors: a
CPU tensor takes the plain version of a kernel, a CUDA tensor launches the
kernel or raises. Nothing falls back silently. Everything is float32: the
networks hold their convolutions and matmuls to float32 (no TF32) with
``float32_exact``.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

__version__ = "0.1.0"

# Launch counters of the hand-written kernels: each wrapper adds one where
# it launches its kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {"stream_fwd": 0, "stream_bwd": 0,
                            "pregathered_fwd": 0, "pregathered_bwd": 0,
                            "bin_owner": 0, "bin_place": 0}


def _init_cpu_vector_math() -> None:
    """Initialise MKL's vector math on one thread.

    On the CPU, ``torch.exp``/``torch.log`` of float32 tensors run MKL's
    vector math library, which initialises itself at its first call. When
    that first call is large enough for ATen to split it over its thread
    pool, the threads race through the initialisation, and in about one
    process in six one thread's share comes out with a relative error of
    ~1.5e-4 instead of ~1 ulp; every later call is exact. The plain kernel
    versions then lie off the JAX kernels by more than their tolerance in
    that process only. A call below ATen's parallel grain runs on the
    calling thread and initialises the library before any large call."""
    torch.exp(torch.zeros(8))


_init_cpu_vector_math()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gs_localization_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def float32_exact():
    """Run cuDNN convolutions and cuBLAS matmuls in float32 inside the block.

    A float32 ``conv2d`` on the card runs in TF32 (a 10-bit mantissa)
    while ``torch.backends.cudnn.allow_tf32`` is True, PyTorch's default,
    so a network's output would depend on the caller's process flags. The
    networks hold float32 themselves with this block, and restore the
    flags after it."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
