"""Classical DoG + SIFT (rootsift) features in PyTorch — no weights needed.

The equivalent of hloc's ``dog``/``sift`` extractor confs, which delegate to
pycolmap's VLFeat SIFT (C++): a Gaussian scale-space pyramid, DoG extrema
detection with peak (0.01) and edge (r=10) tests, orientation assignment
from a 36-bin gradient histogram, and the 4x4x8 gradient-histogram SIFT
descriptor with 0.2 clipping and L1-root ("rootsift") normalization. The
same algorithm as the JAX package's ``sfm/sift.py``, on the device of the
input tensor:

- the Gaussian blurs are sums of shifted copies of a zero-padded image (up
  to 2*ceil(3 sigma)+1 = 25 taps), not ``conv2d``, which runs in TF32 on the
  card by default;
- the 3x3x3 extremum test is ``max_pool3d`` over (scale, y, x) with padding
  1 (which pads with -inf), and ``-max_pool3d(-x)`` for the minimum;
- extrema become a masked top-K (a stable descending sort: equal values
  lowest index first, as ``lax.top_k``);
- orientation and descriptor are one batched computation over the K
  keypoints: (K, 16, 16) sample grids, bilinear gathers, and the 36-bin and
  4x4x8 histograms as ``scatter_add_`` into flat (K*36) and (K*128)
  buffers. On the card those adds are atomics, so their order and last bits
  vary, and an orientation (the argmax of the smoothed histogram) can flip
  at a near-tie.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from .features import Features, _filter_axis, top_k_stable

N_SCALES = 3            # sampled scales per octave
SIGMA0 = 1.6
PEAK_THRESHOLD = 0.01   # hloc conf default
EDGE_R = 10.0
N_ORI_BINS = 36
DESC_WIDTH = 4          # 4x4 spatial bins
DESC_ORI = 8
# The orientation of histogram bin b, (b + 0.5) / 36 * 2 pi - pi, as XLA
# computes that expression in float32: its constants folded into one
# multiplier and the product fused with the subtraction. A table of the 36
# values gives the JAX package's orientations bit for bit, on any device.
_BIN_STEP = np.float32(np.float32(1.0 / N_ORI_BINS) * 2) * np.float32(np.pi)
_ORI_OF_BIN = ((np.arange(N_ORI_BINS) + 0.5) * np.float64(_BIN_STEP)
               - np.float64(np.float32(np.pi))).astype(np.float32)


def _gauss_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    r = max(1, int(np.ceil(3 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return _filter_axis(_filter_axis(img, k, 0), k, 1)


class _OctaveKps(NamedTuple):
    xy: torch.Tensor        # (K, 2) octave-local float coords
    score: torch.Tensor     # (K,) |DoG|
    sigma: torch.Tensor     # (K,) blur level (octave-local)


def _flat(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1)[idx]


def _detect_octave(dogs, k_per_octave: int) -> _OctaveKps:
    """3x3x3 extrema of the middle DoG slices, peak + edge tested."""
    D = torch.stack(dogs)                       # (S+1, H, W)
    h, w = D.shape[1:]
    dev = D.device
    kps_xy, kps_sc, kps_sg = [], [], []
    for s in range(1, D.shape[0] - 1):
        d = D[s]
        cube = D[s - 1:s + 2][None, None]       # (1, 1, 3, H, W)
        stackn = F.max_pool3d(cube, 3, stride=1, padding=1)[0, 0, 1]
        stackx = -F.max_pool3d(-cube, 3, stride=1, padding=1)[0, 0, 1]
        is_ext = ((d >= stackn) | (d <= stackx)) & (torch.abs(d)
                                                    > PEAK_THRESHOLD)
        # 2x2 spatial Hessian edge test (Lowe §4.1)
        dxx = torch.roll(d, -1, 1) + torch.roll(d, 1, 1) - 2 * d
        dyy = torch.roll(d, -1, 0) + torch.roll(d, 1, 0) - 2 * d
        dxy = 0.25 * (torch.roll(d, (-1, -1), (0, 1))
                      + torch.roll(d, (1, 1), (0, 1))
                      - torch.roll(d, (-1, 1), (0, 1))
                      - torch.roll(d, (1, -1), (0, 1)))
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        not_edge = (det > 0) & (tr * tr / det
                                < (EDGE_R + 1) ** 2 / EDGE_R)
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        interior = (yy >= 4) & (yy < h - 4) & (xx >= 4) & (xx < w - 4)
        score = torch.where(is_ext & not_edge & interior, torch.abs(d), 0.0)
        vals, idx = top_k_stable(score.reshape(-1), k_per_octave)
        ys = (idx // w).to(torch.float32)
        xs = (idx % w).to(torch.float32)
        # quadratic sub-pixel refinement in x, y
        n = h * w
        gx = 0.5 * (_flat(d, torch.clamp(idx + 1, 0, n - 1))
                    - _flat(d, torch.clamp(idx - 1, 0, n - 1)))
        gy = 0.5 * (_flat(d, torch.clamp(idx + w, 0, n - 1))
                    - _flat(d, torch.clamp(idx - w, 0, n - 1)))
        hxx = _flat(dxx, idx)
        hyy = _flat(dyy, idx)
        off_x = torch.clamp(
            -gx / torch.where(torch.abs(hxx) > 1e-8, hxx, 1e-8), -0.5, 0.5)
        off_y = torch.clamp(
            -gy / torch.where(torch.abs(hyy) > 1e-8, hyy, 1e-8), -0.5, 0.5)
        kps_xy.append(torch.stack([xs + off_x, ys + off_y], 1))
        kps_sc.append(vals)
        kps_sg.append(torch.full((k_per_octave,),
                                 SIGMA0 * 2.0 ** (s / N_SCALES), device=dev))
    return _OctaveKps(xy=torch.cat(kps_xy), score=torch.cat(kps_sc),
                      sigma=torch.cat(kps_sg))


def _orientation_and_desc(gauss_img: torch.Tensor, xy: torch.Tensor,
                          sigma: torch.Tensor):
    """Dominant orientation (K,) + 128-d SIFT descriptors (K, 128) of the
    keypoints xy (K, 2) at blur levels sigma (K,)."""
    h, w = gauss_img.shape
    dev = gauss_img.device
    R = 8                                        # fixed half-window (16x16)
    k_n = xy.shape[0]
    g = gauss_img.reshape(-1)

    def sample(pts):
        x = torch.clamp(pts[..., 0], 0.0, w - 1.001)
        y = torch.clamp(pts[..., 1], 0.0, h - 1.001)
        x0 = x.to(torch.int64)
        y0 = y.to(torch.int64)
        fx, fy = x - x0, y - y0
        at = y0 * w + x0
        return (g[at] * (1 - fx) * (1 - fy) + g[at + 1] * fx * (1 - fy)
                + g[at + w] * (1 - fx) * fy + g[at + w + 1] * fx * fy)

    # orientation: 36-bin histogram of gradient angles in the window
    gy_, gx_ = torch.meshgrid(
        torch.arange(-R, R, dtype=torch.float32, device=dev),
        torch.arange(-R, R, dtype=torch.float32, device=dev), indexing="ij")
    ex = torch.tensor([1.0, 0.0], device=dev)
    ey = torch.tensor([0.0, 1.0], device=dev)
    sig = sigma[:, None, None]
    base = xy[:, None, None, :] + torch.stack([gx_, gy_], -1)
    dx = sample(base + ex) - sample(base - ex)
    dy = sample(base + ey) - sample(base - ey)
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)                   # [-pi, pi]
    wgt = mag * torch.exp(-(gx_ ** 2 + gy_ ** 2) / (2 * (1.5 * sig) ** 2))
    bins = ((ang + np.pi) / (2 * np.pi) * N_ORI_BINS).to(torch.int64)
    bins = torch.clamp(bins, 0, N_ORI_BINS - 1)
    row = torch.arange(k_n, device=dev)[:, None, None]
    hist = torch.zeros(k_n * N_ORI_BINS, device=dev).scatter_add_(
        0, (row * N_ORI_BINS + bins).reshape(-1), wgt.reshape(-1))
    hist = hist.reshape(k_n, N_ORI_BINS)
    # smooth and take the peak
    hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    ori = torch.as_tensor(_ORI_OF_BIN, device=dev)[torch.argmax(hist, dim=1)]

    # descriptor: rotate the sampling grid by +ori (keypoint frame -> image
    # frame), matching the "image angle - ori" reduction of gradient
    # directions below
    c = torch.cos(ori)[:, None, None]
    s = torch.sin(ori)[:, None, None]
    rx = c * gx_ - s * gy_
    ry = s * gx_ + c * gy_
    pts = xy[:, None, None, :] + torch.stack([rx, ry], -1)
    ddx = sample(pts + ex) - sample(pts - ex)
    ddy = sample(pts + ey) - sample(pts - ey)
    dmag = torch.sqrt(ddx * ddx + ddy * ddy)
    dang = torch.atan2(ddy, ddx) - ori[:, None, None]
    dang = torch.remainder(dang + np.pi, 2 * np.pi)     # [0, 2pi), floor-mod
    dwgt = dmag * torch.exp(-(gx_ ** 2 + gy_ ** 2) / (2 * (0.5 * 2 * R) ** 2))

    # soft-assign to 4x4 spatial x 8 orientation bins
    sx = (gx_ + R) / (2 * R) * DESC_WIDTH - 0.5   # [-0.5, 3.5]
    sy = (gy_ + R) / (2 * R) * DESC_WIDTH - 0.5
    so = dang / (2 * np.pi) * DESC_ORI
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    o0 = torch.floor(so).to(torch.int64)
    fx, fy, fo = sx - x0, sy - y0, so - o0
    desc = torch.zeros(k_n * DESC_WIDTH * DESC_WIDTH * DESC_ORI, device=dev)
    cell = DESC_WIDTH * DESC_WIDTH * DESC_ORI
    for ix, wx in ((x0, 1 - fx), (x0 + 1, fx)):
        for iy, wy in ((y0, 1 - fy), (y0 + 1, fy)):
            for io, wo in ((o0 % DESC_ORI, 1 - fo),
                           ((o0 + 1) % DESC_ORI, fo)):
                valid = (ix >= 0) & (ix < DESC_WIDTH) & (iy >= 0) \
                    & (iy < DESC_WIDTH)
                wv = torch.where(valid, dwgt * wx * wy * wo, 0.0)
                at = (row * cell + (torch.clamp(iy, 0, 3) * DESC_WIDTH
                                    + torch.clamp(ix, 0, 3)) * DESC_ORI + io)
                desc.scatter_add_(0, at.reshape(-1), wv.reshape(-1))
    v = desc.reshape(k_n, cell)
    v = v / torch.clamp_min(torch.linalg.norm(v, dim=1, keepdim=True), 1e-12)
    v = torch.clamp_max(v, 0.2)                  # Lowe clipping
    v = v / torch.clamp_min(torch.linalg.norm(v, dim=1, keepdim=True), 1e-12)
    # rootsift (hloc dog.py)
    v = v / (torch.sum(torch.abs(v), dim=1, keepdim=True) + 1e-6)
    v = torch.sqrt(torch.clamp_min(v, 1e-6))
    v = v / (torch.linalg.norm(v, dim=1, keepdim=True) + 1e-6)
    return v, ori


def extract_sift(image_gray, num_keypoints: int = 1024, n_octaves: int = 3,
                 device="cuda") -> Features:
    """(H, W) grayscale in [0, 1] -> rootsift Features (128-d). A tensor
    runs on its own device; a numpy array goes to ``device``."""
    if not isinstance(image_gray, torch.Tensor):
        image_gray = torch.as_tensor(np.asarray(image_gray, np.float32),
                                     device=resolve_device(device))
    base = image_gray.to(torch.float32)
    per_oct = max(num_keypoints // n_octaves, 16)
    all_xy, all_score, all_desc = [], [], []
    all_ori, all_scale = [], []
    for o in range(n_octaves):
        sigmas = [SIGMA0 * 2.0 ** (s / N_SCALES)
                  for s in range(N_SCALES + 2)]
        gs = [_gauss_blur(base, sig) for sig in sigmas]
        dogs = [gs[i + 1] - gs[i] for i in range(len(gs) - 1)]
        det = _detect_octave(dogs, per_oct)
        # describe on the octave's mid-blur image
        desc, ori = _orientation_and_desc(gs[len(gs) // 2], det.xy,
                                          det.sigma)
        scale_f = float(2 ** o)
        all_xy.append(det.xy * scale_f)
        all_score.append(det.score)
        all_desc.append(desc)
        all_ori.append(ori)
        all_scale.append(det.sigma * scale_f)
        if o + 1 < n_octaves:
            base = gs[N_SCALES][::2, ::2]
    xy = torch.cat(all_xy)
    score = torch.cat(all_score)
    desc = torch.cat(all_desc)
    ori = torch.cat(all_ori)
    scale = torch.cat(all_scale)
    vals, idx = top_k_stable(score, num_keypoints)
    valid = vals > 0
    return Features(
        keypoints=torch.where(valid[:, None], xy[idx], -1.0),
        scores=torch.where(valid, vals, 0.0),
        descriptors=torch.where(valid[:, None], desc[idx], 0.0),
        scales=torch.where(valid, scale[idx], 0.0),
        orientations=torch.where(valid, ori[idx], 0.0),
    )
