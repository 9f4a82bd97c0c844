"""Image-gradient ops for tracking masks.

The reference Scharr pipeline: 3x3 Scharr kernels normalized by 1/32,
reflect padding, a validity mask requiring all 3x3 neighbors |v| > eps, and
the edge mask ``|grad| > median(|grad|) * edge_threshold``. Keypoint box
masks mark a box around each keypoint.

Images are (H, W) or (H, W, C) float tensors. The 3x3 stencils are written
as shifted adds, not ``conv2d``: on the card a float32 convolution runs in
TF32 by default, which can flip mask bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_SCHARR_Y = np.array([[3, 0, -3], [10, 0, -10], [3, 0, -3]], np.float32) / 32.0
_SCHARR_X = np.array([[3, 10, 3], [0, 0, 0], [-3, -10, -3]], np.float32) / 32.0


def _reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]


def _stencil3x3(padded: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Correlation of a padded (H+2, W+2) image with a 3x3 kernel, as a sum
    of shifted copies in row-major tap order."""
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    out = torch.zeros((h, w), dtype=padded.dtype, device=padded.device)
    for i in range(3):
        for j in range(3):
            k = float(kernel[i, j])
            if k != 0.0:
                out = out + k * padded[i:i + h, j:j + w]
    return out


def image_gradient(gray: torch.Tensor):
    """(grad_v, grad_h) Scharr gradients of an (H, W) image."""
    padded = _reflect_pad(gray, 1)
    return _stencil3x3(padded, _SCHARR_X), _stencil3x3(padded, _SCHARR_Y)


def image_gradient_mask(gray: torch.Tensor, eps: float = 0.01) -> torch.Tensor:
    """True where all 3x3 neighbors have |v| > eps (both Scharr taps valid)."""
    ind = (torch.abs(_reflect_pad(gray, 1)) > eps).to(torch.float32)
    return _stencil3x3(ind, np.ones((3, 3), np.float32)) == 9.0


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy/JAX median: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def compute_grad_mask(rgb: torch.Tensor,
                      edge_threshold: float = 1.1) -> torch.Tensor:
    """Edge mask: |Scharr grad| > median * edge_threshold. rgb: (H, W, 3)."""
    gray = torch.mean(rgb, dim=-1)
    gv, gh = image_gradient(gray)
    mv = image_gradient_mask(gray).to(gray.dtype)
    intensity = torch.sqrt((gv * mv) ** 2 + (gh * mv) ** 2)
    return intensity > _median(intensity) * edge_threshold


def keypoint_box_mask(keypoints: torch.Tensor, width: int, height: int,
                      k: int = 10,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """True in a (2*(k//2)+1)^2 box around each keypoint (N, 2) xy pixels;
    out-of-range keypoints are dropped."""
    kp = torch.round(keypoints).to(torch.int64)
    ok = ((kp[:, 0] >= 0) & (kp[:, 0] < width)
          & (kp[:, 1] >= 0) & (kp[:, 1] < height))
    if valid is not None:
        ok = ok & valid
    img = torch.zeros((height, width), dtype=torch.float32,
                      device=keypoints.device)
    img[kp[ok, 1], kp[ok, 0]] = 1.0
    half = k // 2
    box = F.max_pool2d(img[None, None], kernel_size=2 * half + 1, stride=1,
                       padding=half)[0, 0]
    return box > 0.0
