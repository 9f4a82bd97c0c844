"""DISK keypoint extractor (a thin U-Net and a window NMS), on the port.

The published DISK architecture (Tyszkiewicz et al., NeurIPS 2020) as the
JAX package's ``sfm/disk.py`` computes it: a thin U-Net of 5x5 convs,
``down = [16, 32, 64, 64, 64]``, ``up = [64, 64, 64, 129]``, on RGB in
[0, 1] (H, W divisible by 16). A down block is a 2x2 mean pool (not in the
first block) and one pre-activation unit: instance norm without affine
terms, per-channel PReLU, conv. An up block is a 2x nearest upsample, the
concatenation with the skip, and one unit. Channels 0-127 of the output
are dense descriptors, channel 128 the detection heatmap. Keypoints are
``heat >= its window max`` (window 5), above the score threshold, the top
``n`` by a stable sort (equal scores lowest pixel first, ``lax.top_k``'s
order); descriptors are read at the keypoint pixels and L2-normalised.

Two conventions differ from the other extractors on purpose, as in JAX:
dead slots' keypoints are 0.0 (not -1), and the descriptor norm's floor is
1e-8.

``DiskNet`` carries the module paths the JAX converter reads
(``unet.path_down.{i}.unit.{gate,conv}``,
``unet.path_up.{i}.unit.{gate,conv}``), so a state dict in that layout
loads by name (``load_disk``); ``disk_from_jax_params`` carries the JAX
package's params over.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import float32_exact, resolve_device
from .features import Features, top_k_stable

DOWN = [16, 32, 64, 64, 64]
UP = [64, 64, 64, 129]
DESC_DIM = 128
KERNEL = 5
IN_EPS = 1e-5


class _ConvUnit(nn.Module):
    def __init__(self, cin, cout, first, dev):
        super().__init__()
        if not first:
            self.gate = nn.PReLU(cin, device=dev)
        self.conv = nn.Conv2d(cin, cout, KERNEL, padding=KERNEL // 2,
                              device=dev)


class _Block(nn.Module):
    def __init__(self, cin, cout, first, dev):
        super().__init__()
        self.unit = _ConvUnit(cin, cout, first, dev)


class _Unet(nn.Module):
    def __init__(self, dev):
        super().__init__()
        downs, cin = [], 3
        for i, cout in enumerate(DOWN):
            downs.append(_Block(cin, cout, i == 0, dev))
            cin = cout
        self.path_down = nn.ModuleList(downs)
        ups, bot = [], DOWN[-1]
        for i, cout in enumerate(UP):
            ups.append(_Block(bot + DOWN[len(DOWN) - 2 - i], cout, False,
                              dev))
            bot = cout
        self.path_up = nn.ModuleList(ups)


class DiskNet(nn.Module):
    """The weights of DISK under the converter's names; the forward is
    ``unet_forward``."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.unet = _Unet(resolve_device(device))
        self.requires_grad_(False)
        self.eval()


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False) of (1, C, H, W)."""
    mu = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=(2, 3), keepdim=True)
    return (x - mu) * torch.rsqrt(var + IN_EPS)


def _unit(u: _ConvUnit, x: torch.Tensor) -> torch.Tensor:
    """Instance norm -> PReLU -> 5x5 conv (the first block: the conv)."""
    if hasattr(u, "gate"):
        x = _instance_norm(x)
        x = torch.where(x >= 0, x, u.gate.weight[:, None, None] * x)
    return F.conv2d(x, u.conv.weight, u.conv.bias, padding=KERNEL // 2)


def _avg_pool2(x):
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def _upsample2(x):
    return torch.repeat_interleave(torch.repeat_interleave(x, 2, dim=2), 2,
                                   dim=3)


def unet_forward(net: DiskNet, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) in [0, 1] -> (H, W, 129) dense output."""
    x = image.to(torch.float32).permute(2, 0, 1)[None]
    skips = []
    for i, blk in enumerate(net.unet.path_down):
        if i > 0:
            x = _avg_pool2(x)
        x = _unit(blk.unit, x)
        skips.append(x)
    y = skips[-1]
    for i, blk in enumerate(net.unet.path_up):
        y = torch.cat([_upsample2(y), skips[len(DOWN) - 2 - i]], dim=1)
        y = _unit(blk.unit, y)
    return y[0].permute(1, 2, 0)


@torch.no_grad()
def extract_disk(net: DiskNet, image: torch.Tensor, num_keypoints: int = 2048,
                 window_size: int = 5, score_threshold: float = 0.0
                 ) -> Features:
    """DISK keypoints of an (H, W, 3) RGB image in [0, 1] on the net's
    device."""
    with float32_exact():
        dense = unet_forward(net, image)
    desc_map = dense[..., :DESC_DIM]
    heat = dense[..., DESC_DIM]
    pad = window_size // 2
    mx = F.max_pool2d(heat[None, None], window_size, stride=1,
                      padding=pad)[0, 0]
    keep = (heat >= mx) & (heat > score_threshold)
    score = torch.where(keep, heat, -torch.inf)
    h, w = score.shape
    vals, idx = top_k_stable(score.reshape(-1), num_keypoints)
    ys, xs = idx // w, idx % w
    valid = torch.isfinite(vals)
    kpts = torch.stack([xs, ys], dim=-1).to(torch.float32)
    desc = desc_map[ys, xs]
    desc = desc / torch.clamp_min(torch.linalg.norm(desc, dim=-1,
                                                    keepdim=True), 1e-8)
    return Features(
        keypoints=torch.where(valid[:, None], kpts, 0.0),
        scores=torch.where(valid, vals, 0.0),
        descriptors=torch.where(valid[:, None], desc, 0.0),
    )


def disk_from_jax_params(params: Dict[str, Any], device="cuda") -> DiskNet:
    """The JAX package's params (numpy; ``w`` OIHW, ``b``, ``prelu``) ->
    the net."""
    net = DiskNet(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    for path, ps in ((net.unet.path_down, params["down"]),
                     (net.unet.path_up, params["up"])):
        for blk, p in zip(path, ps):
            blk.unit.conv.weight.copy_(t(p["w"]))
            blk.unit.conv.bias.copy_(t(p["b"]))
            if "prelu" in p:
                blk.unit.gate.weight.copy_(t(p["prelu"]))
    return net


def load_disk(state_dict: Dict[str, Any], device="cuda") -> DiskNet:
    """A DISK state dict in the converter's layout
    (``unet.path_{down,up}.{i}.unit.{gate.weight,conv.weight,conv.bias}``)
    -> the net, loaded strictly."""
    net = DiskNet(device)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                         for k, v in state_dict.items()}, strict=True)
    return net
