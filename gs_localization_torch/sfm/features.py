"""Local features: Harris-corner keypoints + patch descriptors, and the
tiny-image global descriptor.

The classical stand-in for hloc's learned extractors when no weights are
available: Shi-Tomasi / Harris on a smoothed image, with bias/gain-normalized
image patches as descriptors (SSD-matchable). Everything is fixed-shape
(top-K keypoints with score masking) and runs on the device of its input
tensor.

The separable Gaussian filters are sums of shifted copies of a zero-padded
image, not ``conv2d``: on the card a float32 convolution runs in TF32 by
default, which moves the response by more than its tolerance. The top-K is a
stable descending sort, which, like ``lax.top_k``, takes equal values lowest
index first (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


class Features(NamedTuple):
    keypoints: torch.Tensor     # (K, 2) xy pixel coords
    scores: torch.Tensor        # (K,) detector response (0 => invalid slot)
    descriptors: torch.Tensor   # (K, D) L2-normalized
    # optional per-keypoint geometry (SIFT-style extractors); feed the
    # AdaLAM scale-rate / orientation-difference gates (sfm/adalam.py)
    scales: Optional[torch.Tensor] = None        # (K,) blur scale
    orientations: Optional[torch.Tensor] = None  # (K,) radians


def _gauss_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter_axis(img: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """SAME zero-padded correlation of an (H, W) image with the 1-D taps
    ``k`` along ``axis``, as a sum of shifted copies in tap order."""
    r = len(k) // 2
    n = img.shape[axis]
    pad = (0, 0, r, r) if axis == 0 else (r, r)
    padded = F.pad(img, pad)
    out = torch.zeros_like(img)
    for i, tap in enumerate(k):
        out = out + float(tap) * padded.narrow(axis, i, n)
    return out


def _sep_conv(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable symmetric filter on (H, W) with SAME zero padding (rows,
    then columns, as the JAX package's two convolutions)."""
    return _filter_axis(_filter_axis(img, k, 0), k, 1)


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last dimension,
    equal values lowest index first (``lax.top_k``'s order)."""
    if k > x.shape[-1]:
        raise ValueError(f"top-{k} of {x.shape[-1]} entries")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def extract_harris_features(
    image: torch.Tensor,              # (H, W) grayscale float [0,1]
    num_keypoints: int = 1024,
    nms_radius: int = 4,
    patch_radius: int = 5,
    k_harris: float = 0.04,
    device="cuda",
) -> Features:
    """Harris keypoints of a grayscale image. A tensor runs on its own
    device; a numpy array goes to ``device``."""
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.asarray(image, np.float32),
                                device=resolve_device(device))
    image = image.to(torch.float32)
    h, w = image.shape
    smooth = _sep_conv(image, _gauss_kernel(1.0, 2))
    dx = (torch.roll(smooth, -1, 1) - torch.roll(smooth, 1, 1)) * 0.5
    dy = (torch.roll(smooth, -1, 0) - torch.roll(smooth, 1, 0)) * 0.5
    g = _gauss_kernel(1.5, 3)
    ixx = _sep_conv(dx * dx, g)
    iyy = _sep_conv(dy * dy, g)
    ixy = _sep_conv(dx * dy, g)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    response = det - k_harris * tr * tr

    # NMS: keep local maxima within (2r+1)^2 windows (max_pool2d pads with
    # -inf, as reduce_window's SAME padding does)
    win = 2 * nms_radius + 1
    maxed = F.max_pool2d(response[None, None], win, stride=1,
                         padding=nms_radius)[0, 0]
    is_max = (response >= maxed) & (response > 0)
    # suppress borders (patch must fit)
    b = max(patch_radius, nms_radius) + 1
    yy = torch.arange(h, device=image.device)[:, None]
    xx = torch.arange(w, device=image.device)[None, :]
    interior = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    score_map = torch.where(is_max & interior, response, 0.0)

    scores, idx = top_k_stable(score_map.reshape(-1), num_keypoints)
    ys = idx // w
    xs = idx % w
    kps = torch.stack([xs, ys], dim=1).to(torch.float32)

    # descriptors: normalized (2r+1)^2 patches of the smoothed image
    d = 2 * patch_radius + 1
    off = torch.arange(-patch_radius, patch_radius + 1, device=image.device)
    py = torch.clamp(ys[:, None, None] + off[None, :, None], 0, h - 1)
    px = torch.clamp(xs[:, None, None] + off[None, None, :], 0, w - 1)
    patches = smooth[py, px].reshape(num_keypoints, d * d)
    patches = patches - torch.mean(patches, dim=1, keepdim=True)
    desc = patches * torch.rsqrt(torch.clamp_min(
        torch.sum(patches**2, dim=1, keepdim=True), 1e-12))

    valid = scores > 0
    return Features(
        keypoints=torch.where(valid[:, None], kps, -1.0),
        scores=torch.where(valid, scores, 0.0),
        descriptors=torch.where(valid[:, None], desc, 0.0),
    )


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])


def tiny_image_descriptor(rgb: torch.Tensor, size: int = 16) -> torch.Tensor:
    """Global descriptor: blurred, downsampled, whitened thumbnail.

    A classical stand-in for NetVLAD retrieval (pairs_from_retrieval) that
    works surprisingly well for scene-level nearest neighbors indoors.
    """
    gray = rgb_to_gray(rgb)
    h, w = gray.shape
    gray = _sep_conv(gray, _gauss_kernel(max(h, w) / (2.0 * size), 5))
    # sample positions in float32, truncated, as the JAX package's
    ar = torch.arange(size, dtype=torch.float32, device=gray.device) + 0.5
    ys = (ar * (h / size)).to(torch.int64)
    xs = (ar * (w / size)).to(torch.int64)
    v = gray[ys[:, None], xs[None, :]].reshape(-1)
    v = v - torch.mean(v)
    return v * torch.rsqrt(torch.clamp_min(torch.sum(v * v), 1e-12))
