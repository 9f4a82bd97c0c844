"""SuperPoint keypoint detector / descriptor, on the port.

The public SuperPoint architecture (DeTone et al., CVPR-W 2018) as the JAX
package's ``sfm/superpoint.py`` computes it: a shared VGG-style encoder (4
conv blocks, 3 max-pools), a 65-channel detector head (8x8 cell softmax
with a dustbin) and a 256-d descriptor head, L2-normalised and sampled
bilinearly at the keypoints. The submodules carry the official names
(``conv1a`` ... ``convDb``), so ``superpoint_v1.pth`` loads with
``load_state_dict(strict=True)`` (``load_superpoint``);
``superpoint_from_jax_params`` carries the JAX package's flax params over.

The convolutions are ``F.conv2d`` (cuDNN on the card) under
``float32_exact``; the top-k is ``top_k_stable`` (``lax.top_k``'s order
among equal scores, where ``torch.topk`` promises none).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import float32_exact, resolve_device
from .features import Features, top_k_stable

_CONVS = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
          ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
          ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
          ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
          ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
          ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))


class SuperPointNet(nn.Module):
    """(H, W) grayscale in [0, 1] -> (scores (H, W), descriptors
    (H/8, W/8, 256))."""

    def __init__(self, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        for name, cin, cout, k in _CONVS:
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2,
                                          device=dev))
        self.requires_grad_(False)
        self.eval()

    def forward(self, image: torch.Tensor):
        relu = F.relu
        with float32_exact():
            x = image[None, None]
            x = relu(self.conv1b(relu(self.conv1a(x))))
            x = F.max_pool2d(x, 2, 2)
            x = relu(self.conv2b(relu(self.conv2a(x))))
            x = F.max_pool2d(x, 2, 2)
            x = relu(self.conv3b(relu(self.conv3a(x))))
            x = F.max_pool2d(x, 2, 2)
            x = relu(self.conv4b(relu(self.conv4a(x))))

            d = self.convPb(relu(self.convPa(x)))         # (1, 65, h, w)
            d = torch.softmax(d, dim=1)[:, :64]
            _, _, hc, wc = d.shape
            d = d.permute(0, 2, 3, 1).reshape(1, hc, wc, 8, 8)
            scores = d.permute(0, 1, 3, 2, 4).reshape(hc * 8, wc * 8)

            e = self.convDb(relu(self.convDa(x)))[0].permute(1, 2, 0)
            e = e * torch.rsqrt(torch.clamp_min(
                torch.sum(e * e, dim=-1, keepdim=True), 1e-12))
        return scores, e


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Iterated non-maximum suppression, the reference algorithm: the
    local-max mask, then 2 rounds that re-admit maxima of the suppressed
    complement. ``max_pool2d`` pads with -inf, as ``reduce_window``'s SAME
    padding does."""
    win = 2 * radius + 1

    def max_pool(x):
        return F.max_pool2d(x[None, None], win, stride=1,
                            padding=radius)[0, 0]

    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.to(torch.float32)) > 0
        supp_scores = torch.where(supp_mask, 0.0, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, 0.0)


def postprocess(scores: torch.Tensor, desc_coarse: torch.Tensor,
                num_keypoints: int = 1024, nms_radius: int = 4,
                score_threshold: float = 0.005, border: int = 4) -> Features:
    h, w = scores.shape
    s = simple_nms(scores, nms_radius)
    yy = torch.arange(h, device=s.device)[:, None]
    xx = torch.arange(w, device=s.device)[None, :]
    interior = ((yy >= border) & (yy < h - border)
                & (xx >= border) & (xx < w - border))
    s = torch.where(interior & (s > score_threshold), s, 0.0)
    vals, idx = top_k_stable(s.reshape(-1), num_keypoints)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)

    # bilinear sample of the coarse grid at the keypoints, with the
    # reference's coordinate map ((kp - s/2 + 0.5) / (dim*s - s/2 - 0.5)
    # -> [-1, 1], grid_sample align_corners=True => u = t * (dim_c - 1))
    hc, wc, _ = desc_coarse.shape
    gx = torch.clamp((xs - 3.5) / (wc * 8.0 - 4.5) * (wc - 1), 0.0,
                     wc - 1.001)
    gy = torch.clamp((ys - 3.5) / (hc * 8.0 - 4.5) * (hc - 1), 0.0,
                     hc - 1.001)
    x0 = gx.to(torch.int64)
    y0 = gy.to(torch.int64)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    x1 = torch.clamp_max(x0 + 1, wc - 1)
    y1 = torch.clamp_max(y0 + 1, hc - 1)
    desc = (desc_coarse[y0, x0] * (1 - fx) * (1 - fy)
            + desc_coarse[y0, x1] * fx * (1 - fy)
            + desc_coarse[y1, x0] * (1 - fx) * fy
            + desc_coarse[y1, x1] * fx * fy)
    desc = desc * torch.rsqrt(torch.clamp_min(
        torch.sum(desc * desc, dim=-1, keepdim=True), 1e-12))

    valid = vals > 0
    return Features(
        keypoints=torch.where(valid[:, None], torch.stack([xs, ys], 1),
                              -1.0),
        scores=torch.where(valid, vals, 0.0),
        descriptors=torch.where(valid[:, None], desc, 0.0),
    )


@torch.no_grad()
def extract_superpoint(net: SuperPointNet, image_gray: torch.Tensor,
                       num_keypoints: int = 1024, nms_radius: int = 4,
                       score_threshold: float = 0.005) -> Features:
    """Keypoints of an (H, W) grayscale tensor on the net's device."""
    scores, desc = net(image_gray)
    return postprocess(scores, desc, num_keypoints, nms_radius,
                       score_threshold)


def superpoint_from_jax_params(params: Dict[str, Any],
                               device="cuda") -> SuperPointNet:
    """The JAX package's flax params (numpy; kernels HWIO) -> the net."""
    net = SuperPointNet(device)
    for name, *_ in _CONVS:
        conv = getattr(net, name)
        kernel = np.asarray(params[name]["kernel"], np.float32)
        conv.weight.copy_(torch.tensor(kernel.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.tensor(np.asarray(params[name]["bias"],
                                                np.float32)))
    return net


def load_superpoint(state_dict: Dict[str, Any], device="cuda"
                    ) -> SuperPointNet:
    """An official ``superpoint_v1.pth`` state dict (``conv1a.weight`` ...
    ``convDb.bias``) -> the net, loaded strictly."""
    net = SuperPointNet(device)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                         for k, v in state_dict.items()}, strict=True)
    return net
