"""D2-Net detect-and-describe features, on the port.

hloc's ``d2net-ss`` extractor (the single-scale path) as the JAX package's
``sfm/d2net.py`` computes it: a VGG16 stack cut at conv4_3, whose conv4
block is dilated after a stride-1 2x2 average pool, on caffe-normalised
BGR input; hard detection (the channel-wise max, a 3x3 local max and the
Hessian edge test at edge_threshold 5); the inverse-Hessian sub-pixel
step; and bilinear descriptor sampling.

The detection decides keypoints by equality (``f == max``) and by
``tr^2 / det <= thr`` on exact values, so the 3x3 derivative stencils are
sums of shifted copies of the zero-padded map, tap by tap (as the Harris
filters in ``features.py``), not ``conv2d``, which runs in TF32 on the
card by default. The fixed capacity is a stable descending sort over all
h * w * 512 scores, equal values lowest index first (``lax.top_k``'s
order).

``D2Net`` carries the official submodule names
(``dense_feature_extraction.model.{i}``), so the ``model`` dict of
``d2_tf.pth`` loads by name (``load_d2net``); ``d2net_from_jax_params``
carries the JAX package's params over.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import float32_exact, resolve_device
from .features import Features, top_k_stable

# the official Sequential's indices of the 10 convs (pool / relu between)
TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)
CONV_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512)
# pools BEFORE conv i: 2x2 / 2 max pools before convs 2 and 4, a 2x2 / 1
# average pool before conv 7; convs 7-9 are dilation 2
MAXPOOL_BEFORE = (False, False, True, False, True, False, False, False,
                  False, False)
AVGPOOL_BEFORE = (False, False, False, False, False, False, False, True,
                  False, False)
DILATION = (1, 1, 1, 1, 1, 1, 1, 2, 2, 2)
EDGE_THRESHOLD = 5.0
_BGR_MEAN = np.array([103.939, 116.779, 123.68], np.float32)

_DII = np.array([[0, 1, 0], [0, -2, 0], [0, 1, 0]], np.float32)
_DIJ = 0.25 * np.array([[1, 0, -1], [0, 0, 0], [-1, 0, 1]], np.float32)
_DJJ = np.array([[0, 0, 0], [1, -2, 1], [0, 0, 0]], np.float32)
_DI = np.array([[0, -0.5, 0], [0, 0, 0], [0, 0.5, 0]], np.float32)
_DJ = np.array([[0, 0, 0], [-0.5, 0, 0.5], [0, 0, 0]], np.float32)


class _DenseFeatureExtraction(nn.Module):
    def __init__(self, dev):
        super().__init__()
        layers, cin = [], 3
        for i, cout in enumerate(CONV_CHANNELS):
            if MAXPOOL_BEFORE[i]:
                layers.append(nn.MaxPool2d(2, 2))
            if AVGPOOL_BEFORE[i]:
                layers.append(nn.AvgPool2d(2, 1))
            layers.append(nn.Conv2d(cin, cout, 3, padding=DILATION[i],
                                    dilation=DILATION[i], device=dev))
            if i < len(CONV_CHANNELS) - 1:
                layers.append(nn.ReLU())
            cin = cout
        self.model = nn.Sequential(*layers)


class D2Net(nn.Module):
    """The weights of D2-Net under the official names; the forward is
    ``dense_features``."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.dense_feature_extraction = _DenseFeatureExtraction(
            resolve_device(device))
        self.requires_grad_(False)
        self.eval()

    def convs(self) -> List[nn.Conv2d]:
        model = self.dense_feature_extraction.model
        return [model[i] for i in TORCH_CONV_IDX]


def dense_features(net: D2Net, image: torch.Tensor,
                   use_relu: bool = True) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] -> (H/4 - 1, W/4 - 1, 512) caffe-style
    features (the stride-1 average pool drops a row and a column)."""
    mean = torch.from_numpy(_BGR_MEAN).to(image.device)
    x = torch.flip(image, dims=(-1,)) * 255.0 - mean    # RGB -> BGR, caffe
    x = x.permute(2, 0, 1)[None]
    for i, conv in enumerate(net.convs()):
        if MAXPOOL_BEFORE[i]:
            x = F.max_pool2d(x, 2, 2)
        if AVGPOOL_BEFORE[i]:
            h, w = x.shape[2:]
            x = (x[:, :, :h - 1, :w - 1] + x[:, :, :h - 1, 1:]
                 + x[:, :, 1:, :w - 1] + x[:, :, 1:, 1:]) / 4.0
        x = F.conv2d(x, conv.weight, conv.bias, padding=DILATION[i],
                     dilation=DILATION[i])
        if i < len(CONV_CHANNELS) - 1:
            x = F.relu(x)
    if use_relu:
        x = F.relu(x)
    return x[0].permute(1, 2, 0)


def _stencil(f: torch.Tensor, kernel3: np.ndarray) -> torch.Tensor:
    """Per-channel 3x3 correlation with zero padding ((H, W, C) ->
    (H, W, C)): the shifted copies of the padded map, tap by tap."""
    h, w, _ = f.shape
    padded = F.pad(f, (0, 0, 1, 1, 1, 1))
    out = torch.zeros_like(f)
    for a in range(3):
        for b in range(3):
            tap = float(kernel3[a, b])
            if tap != 0.0:
                out = out + tap * padded[a:a + h, b:b + w]
    return out


def _hessian(f: torch.Tensor):
    dii, dij, djj = _stencil(f, _DII), _stencil(f, _DIJ), _stencil(f, _DJJ)
    return dii, dij, djj, dii * djj - dij * dij


def hard_detection(f: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, C) bool detection mask."""
    depth_max = f == torch.amax(f, dim=-1, keepdim=True)
    local = F.max_pool2d(f.permute(2, 0, 1)[None], 3, stride=1,
                         padding=1)[0].permute(1, 2, 0)
    local_max = f == local
    dii, _, djj, det = _hessian(f)
    tr = dii + djj
    thr = (EDGE_THRESHOLD + 1) ** 2 / EDGE_THRESHOLD
    not_edge = (tr * tr / det <= thr) & (det > 0)
    return depth_max & local_max & not_edge


def localization(f: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, C, 2) inverse-Hessian displacement (i, j)."""
    dii, dij, djj, det = _hessian(f)
    di, dj = _stencil(f, _DI), _stencil(f, _DJ)
    step_i = -(djj * di - dij * dj) / det
    step_j = -(-dij * di + dii * dj) / det
    return torch.stack([step_i, step_j], -1)


@torch.no_grad()
def extract_d2net(net: D2Net, image: torch.Tensor, num_keypoints: int = 1024,
                  use_relu: bool = True) -> Features:
    """Single-scale D2-Net extraction of an (H, W, 3) RGB image in [0, 1]
    on the net's device."""
    with float32_exact():
        f = dense_features(net, image, use_relu)          # (h, w, 512)
    h, w, c = f.shape
    detected = hard_detection(f)
    disp = localization(f)
    ok = (detected & (torch.abs(disp[..., 0]) < 0.5)
          & (torch.abs(disp[..., 1]) < 0.5))
    # the score is the raw feature value at the detection
    score = torch.where(ok & torch.isfinite(disp).all(-1), f, -torch.inf)
    vals, idx = top_k_stable(score.reshape(-1), num_keypoints)
    valid = torch.isfinite(vals)
    ji = (idx // c) % w
    ii = idx // (c * w)
    d_i = disp.reshape(-1, 2)[idx]
    # dead slots' displacements may be inf / nan: their outputs are masked,
    # and they must not reach an integer cast
    fi = torch.where(valid, ii.to(torch.float32) + d_i[:, 0], 0.0)
    fj = torch.where(valid, ji.to(torch.float32) + d_i[:, 1], 0.0)

    # bilinear descriptor sampling at feature-map positions
    i0 = torch.clamp(torch.floor(fi), 0, h - 2).to(torch.int64)
    j0 = torch.clamp(torch.floor(fj), 0, w - 2).to(torch.int64)
    ti = torch.clamp(fi - i0, 0.0, 1.0)[:, None]
    tj = torch.clamp(fj - j0, 0.0, 1.0)[:, None]
    d00, d01 = f[i0, j0], f[i0, j0 + 1]
    d10, d11 = f[i0 + 1, j0], f[i0 + 1, j0 + 1]
    desc = (d00 * (1 - ti) * (1 - tj) + d01 * (1 - ti) * tj
            + d10 * ti * (1 - tj) + d11 * ti * tj)
    desc = desc * torch.rsqrt(torch.clamp_min(
        torch.sum(desc * desc, -1, keepdim=True), 1e-12))

    # feature map -> image: two upscale steps (x * 2 + 0.5 each: 4x + 1.5)
    xs = fj * 4.0 + 1.5
    ys = fi * 4.0 + 1.5
    return Features(
        keypoints=torch.where(valid[:, None], torch.stack([xs, ys], 1),
                              -1.0),
        scores=torch.where(valid, vals, 0.0),
        descriptors=torch.where(valid[:, None], desc, 0.0),
    )


def d2net_from_jax_params(params: List[Dict[str, Any]],
                          device="cuda") -> D2Net:
    """The JAX package's params (a list of {kernel HWIO, bias}) -> the net."""
    net = D2Net(device)
    for conv, p in zip(net.convs(), params):
        conv.weight.copy_(torch.tensor(np.asarray(
            p["kernel"], np.float32).transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))
    return net


def load_d2net(state_dict: Dict[str, Any], device="cuda") -> D2Net:
    """The ``model`` dict of the official ``d2_tf.pth``
    (``dense_feature_extraction.model.{i}.{weight,bias}``) -> the net,
    loaded strictly."""
    net = D2Net(device)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                         for k, v in state_dict.items()}, strict=True)
    return net
