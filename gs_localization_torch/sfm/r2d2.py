"""R2D2 (reliable and repeatable) features, on the port.

hloc's R2D2 extractor (``Quad_L2Net_ConfCFS``) as the JAX package's
``sfm/r2d2.py`` computes it: a fully convolutional dilated L2-Net (each
"stride" becomes a doubling of the dilation, so the output is at full
resolution) with 128-d L2-normalised descriptors, batch norm in inference
form without affine terms, a 2-class reliability head (softmax, class 1)
and a softplus repeatability head x / (1 + x), both on the squared
features; detection is a 3x3 local maximum of the repeatability, by
equality, with the thresholds 0.7 / 0.7, and a stable top-k (equal scores
lowest pixel first, ``lax.top_k``'s order). Single scale.

``R2D2Net`` carries the official submodule names (``ops.{i}``, ``clf``,
``sal``), so the ``state_dict`` of ``r2d2_WASF_N16.pt`` loads by name
(``load_r2d2``, which cuts the ``module.`` prefix the released file
carries); ``r2d2_from_jax_params`` carries the JAX package's params over.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import float32_exact, resolve_device
from ..ops.param_tree import load_named
from .features import Features, top_k_stable

# (out_ch, kernel, dilation, has_bn, has_relu) per conv, dilated mode
PLAN = (
    (32, 3, 1, True, True),
    (32, 3, 1, True, True),
    (64, 3, 1, True, True),     # "stride 2": the dilation doubles after
    (64, 3, 2, True, True),
    (128, 3, 2, True, True),    # the dilation doubles after
    (128, 3, 4, True, True),
    (128, 2, 4, True, False),   # 2x2 convs in place of the 8x8
    (128, 2, 8, True, False),
    (128, 2, 16, False, False),
)
# the official ``ops`` index of each conv (bn / relu are modules of their own)
TORCH_OPS_IDX = (0, 3, 6, 9, 12, 15, 18, 20, 22)
BN_EPS = 1e-5
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _pad(k: int, d: int) -> int:
    return ((k - 1) * d) // 2


class R2D2Net(nn.Module):
    """The weights of R2D2 under the official names; the forward is
    ``r2d2_forward``."""

    def __init__(self, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        ops, cin = [], 3
        for cout, k, d, has_bn, has_relu in PLAN:
            ops.append(nn.Conv2d(cin, cout, k, padding=_pad(k, d),
                                 dilation=d, device=dev))
            if has_bn:
                ops.append(nn.BatchNorm2d(cout, affine=False, device=dev))
            if has_relu:
                ops.append(nn.ReLU())
            cin = cout
        self.ops = nn.ModuleList(ops)
        self.clf = nn.Conv2d(128, 2, 1, device=dev)
        self.sal = nn.Conv2d(128, 1, 1, device=dev)
        self.requires_grad_(False)
        self.eval()


def _bn(bn: nn.BatchNorm2d, x):
    """Batch norm without affine terms: the running statistics only."""
    return ((x - bn.running_mean[:, None, None])
            * torch.rsqrt(bn.running_var + BN_EPS)[:, None, None])


def r2d2_forward(net: R2D2Net, image: torch.Tensor):
    """(H, W, 3) RGB in [0, 1] -> (desc (H, W, 128), reliability (H, W),
    repeatability (H, W))."""
    mean = torch.from_numpy(_MEAN).to(image.device)
    std = torch.from_numpy(_STD).to(image.device)
    x = ((image - mean) / std).permute(2, 0, 1)[None]
    for i, (_, k, d, has_bn, has_relu) in zip(TORCH_OPS_IDX, PLAN):
        conv = net.ops[i]
        x = F.conv2d(x, conv.weight, conv.bias, padding=_pad(k, d),
                     dilation=d)
        if has_bn:
            x = _bn(net.ops[i + 1], x)
        if has_relu:
            x = F.relu(x)
    desc = x * torch.rsqrt(torch.clamp_min(
        torch.sum(x * x, 1, keepdim=True), 1e-24))
    # the confidence heads run on the squared features
    xsq = x * x
    rel = torch.softmax(net.clf(xsq), dim=1)[0, 1]
    sal = net.sal(xsq)[0, 0]
    sp = torch.logaddexp(sal, torch.zeros_like(sal))       # softplus
    rep = sp / (1.0 + sp)
    return desc[0].permute(1, 2, 0), rel, rep


@torch.no_grad()
def extract_r2d2(net: R2D2Net, image: torch.Tensor, num_keypoints: int = 1024,
                 reliability_threshold: float = 0.7,
                 repeatability_threshold: float = 0.7) -> Features:
    """Single-scale R2D2 extraction of an (H, W, 3) RGB image in [0, 1] on
    the net's device, with the 3x3 non-maximum suppression."""
    with float32_exact():
        desc, rel, rep = r2d2_forward(net, image)
    h, w = rep.shape
    local = F.max_pool2d(rep[None, None], 3, stride=1, padding=1)[0, 0]
    keep = ((rep == local) & (rep >= repeatability_threshold)
            & (rel >= reliability_threshold))
    score = torch.where(keep, rel * rep, -torch.inf)
    vals, idx = top_k_stable(score.reshape(-1), num_keypoints)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    d = desc.reshape(-1, 128)[idx]
    valid = torch.isfinite(vals)
    return Features(
        keypoints=torch.where(valid[:, None], torch.stack([xs, ys], 1),
                              -1.0),
        scores=torch.where(valid, vals, 0.0),
        descriptors=torch.where(valid[:, None], d, 0.0),
    )


def r2d2_from_jax_params(params: Dict[str, Any], device="cuda") -> R2D2Net:
    """The JAX package's params (numpy; kernels HWIO) -> the net."""
    net = R2D2Net(device)

    def conv(c, p):
        c.weight.copy_(torch.tensor(np.asarray(
            p["kernel"], np.float32).transpose(3, 2, 0, 1)))
        c.bias.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))

    for i, p in zip(TORCH_OPS_IDX, params["convs"]):
        conv(net.ops[i], p)
        if "bn" in p:
            bn = net.ops[i + 1]
            bn.running_mean.copy_(torch.tensor(np.asarray(p["bn"]["mean"])))
            bn.running_var.copy_(torch.tensor(np.asarray(p["bn"]["var"])))
    conv(net.clf, params["clf"])
    conv(net.sal, params["sal"])
    return net


def load_r2d2(state_dict: Dict[str, Any], device="cuda") -> R2D2Net:
    """The ``state_dict`` of the official ``r2d2_WASF_N16.pt`` (keys with
    or without the ``module.`` prefix) -> the net. Every weight and
    statistic must be present; the batch norms' ``num_batches_tracked``
    counters may be absent."""
    return load_named(R2D2Net(device), state_dict, "r2d2", prefix="module.")
