"""``jax.image.resize`` for PyTorch tensors (bilinear and cubic).

The depth priors resize with ``jax.image.resize``: for each axis whose size
changes, a dense (in, out) weight matrix over the half-pixel sample grid,
contracted with the tensor. Its cubic is Keys' kernel with a = -0.5 (not
``F.interpolate``'s -0.75); when it downscales with ``antialias`` the
kernel is stretched by the scale, a low-pass filter; each output's weights
are renormalised over the in-bounds taps. ``F.interpolate`` computes none
of these the same way, so this module builds the same matrices and applies
them as float32 matmuls.

The matrices are float32 computed as XLA computes them under ``jit``
(``jax.image.resize`` is jitted): the sample position and the kernel's
polynomial are fused multiply-adds, rounded once. Built in float64 instead,
or in plain float32 steps, they lie up to 2.4e-5 and 1.3e-5 off JAX's
where 384 rows are upsampled to 480, and so does the resized image.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the float64 product of two float32
    values is exact)."""
    return (np.float64(a) * np.asarray(b, np.float64) + c).astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    near = _fma(_fma(1.5, x, -2.5) * x, x, 1.0)
    far = _fma(_fma(_fma(-0.5, x, 2.5), x, -4.0), x, 2.0)
    out = np.where(x >= 1.0, far, near)
    return np.where(x >= 2.0, np.float32(0.0), out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), 1.0 - np.abs(x))


_KERNELS = {"bilinear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int, method: str,
                  antialias: bool) -> np.ndarray:
    """(n_in, n_out) float32 resampling weights, as JAX's
    ``compute_weight_mat`` with scale n_out / n_in and no translation."""
    f32 = np.float32
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0) if antialias else 1.0)
    sample_f = _fma(f32(inv_scale), np.arange(n_out, dtype=f32) + f32(0.5),
                    -0.5)
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = kernel(x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > f32(1000.0 * _EPS32),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(x: torch.Tensor, shape: Sequence[int], method: str,
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, shape, method, antialias)`` for ``method``
    "bilinear" or "cubic": each axis whose size changes is contracted with
    its weight matrix, in axis order."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} for a {x.ndim}-d tensor")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = torch.from_numpy(weight_matrix(n_in, int(n_out), method,
                                           antialias)).to(x.device)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
