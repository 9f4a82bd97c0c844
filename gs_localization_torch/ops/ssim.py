"""SSIM with an 11-tap sigma-1.5 Gaussian window.

Per-channel separable Gaussian blur with zero ("SAME") padding of
window // 2, C1 = 0.01^2, C2 = 0.03^2, as the JAX package's ``ssim``.
Images are (H, W, C) float in [0, 1].

Each 1-D blur is a product with a banded (n, n) matrix of the window's taps
rather than a convolution: matrix products stay in full float32 on the card
by default, where cuDNN's convolutions would round through TF32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band(n: int, window_size: int, sigma: float,
          device: torch.device) -> torch.Tensor:
    """(n, n) matrix B with (B @ x)[i] = sum_t w[t] x[i + t - window//2],
    terms outside [0, n) dropped (zero padding)."""
    w = _gaussian_window(window_size, sigma)
    pad = window_size // 2
    band = np.zeros((n, n), np.float32)
    for t in range(window_size):
        off = t - pad
        i = np.arange(max(0, -off), min(n, n - off))
        band[i, i + off] = w[t]
    return torch.tensor(band, device=device)


def _blur(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, zero padding. img: (H, W, C)."""
    h, w = img.shape[:2]
    bh = _band(h, window_size, sigma, img.device)
    bw = _band(w, window_size, sigma, img.device)
    x = torch.einsum("ij,jwc->iwc", bh, img)          # along H
    return torch.einsum("ij,hjc->hic", bw, x)         # along W


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair."""
    c1 = 0.01**2
    c2 = 0.03**2
    # the five blurs as one, over the channels stacked
    mu1, mu2, b11, b22, b12 = torch.chunk(_blur(
        torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                  dim=-1), window_size, sigma), 5, dim=-1)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = b11 - mu1_sq
    sigma2_sq = b22 - mu2_sq
    sigma12 = b12 - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)
