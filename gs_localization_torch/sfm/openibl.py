"""OpenIBL (SFRS ``vgg16_netvlad``) global descriptor, on the port.

hloc's OpenIBL extractor as the JAX package's ``sfm/openibl.py`` computes
it: input ``(img - mean) * 255`` (the hloc wrapper's mean, std 1 / 255);
torchvision's VGG16 ``features`` cut before the last ReLU and max pool, so
the map ends at conv5_3 without a ReLU; 64-cluster NetVLAD pooling
(channel L2, a bias-free 1x1 conv -> softmax cluster scores, residuals to
the centroids, intra-normalisation per cluster, a cluster-major flatten,
L2). The output has 512 * 64 = 32,768 dimensions and no whitening.

``OpenIBLNet`` carries the hub model's names (``base_model.{i}`` for
torchvision's conv indices, ``net_vlad.conv``, ``net_vlad.centroids``), so
its state dict loads by name (``load_openibl``); ``openibl_from_jax_params``
carries the JAX package's params over.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import float32_exact, resolve_device

NUM_CLUSTERS = 64
FEATURE_DIM = 512

# the hloc wrapper's constants
RGB_MEAN = np.array(
    [0.48501960784313836, 0.4579568627450961, 0.4076039215686255],
    np.float32)
RGB_STD = np.float32(1.0 / 255.0)

# torchvision's VGG16 convs, with a max pool before the convs marked; the
# hub model keeps relu5_2 and stops after conv5_3
VGG16_CONVS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
POOL_BEFORE = (False, False, True, False, True, False, False, True,
               False, False, True, False, False)
CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


class _NetVLAD(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.conv = nn.Conv2d(FEATURE_DIM, NUM_CLUSTERS, 1, bias=False,
                              device=dev)
        self.centroids = nn.Parameter(torch.zeros(NUM_CLUSTERS, FEATURE_DIM,
                                                  device=dev))


class OpenIBLNet(nn.Module):
    """The weights of ``vgg16_netvlad`` under the hub model's names; the
    forward is ``openibl_descriptor``."""

    def __init__(self, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        layers, cin = [], 3
        for i, cout in enumerate(VGG16_CONVS):
            if POOL_BEFORE[i]:
                layers.append(nn.MaxPool2d(2, 2))
            layers.append(nn.Conv2d(cin, cout, 3, padding=1, device=dev))
            if i < len(VGG16_CONVS) - 1:
                layers.append(nn.ReLU())
            cin = cout
        self.base_model = nn.Sequential(*layers)
        self.net_vlad = _NetVLAD(dev)
        self.requires_grad_(False)
        self.eval()


def backbone_features(net: OpenIBLNet, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] -> (H/16 * W/16, 512) conv5_3 features."""
    mean = torch.from_numpy(RGB_MEAN).to(image.device)
    x = ((image.to(torch.float32) - mean) / RGB_STD).permute(2, 0, 1)[None]
    for i, idx in enumerate(CONV_IDX):
        if POOL_BEFORE[i]:
            x = F.max_pool2d(x, 2, 2)
        conv = net.base_model[idx]
        x = F.conv2d(x, conv.weight, conv.bias, padding=1)
        if i < len(VGG16_CONVS) - 1:
            x = F.relu(x)
    return x[0].permute(1, 2, 0).reshape(-1, FEATURE_DIM)


def vlad_pool(net: OpenIBLNet, feats: torch.Tensor) -> torch.Tensor:
    """(N, 512) -> (64 * 512,) SFRS-style VLAD (cluster-major flatten)."""
    f = feats * torch.rsqrt(torch.clamp_min(
        torch.sum(feats * feats, -1, keepdim=True), 1e-24))
    score_w = net.net_vlad.conv.weight[:, :, 0, 0].T                 # (C, K)
    scores = torch.softmax(f @ score_w, dim=-1)                      # (N, K)
    vlad = torch.einsum("nk,nd->kd", scores, f) \
        - net.net_vlad.centroids * torch.sum(scores, 0)[:, None]
    vlad = vlad * torch.rsqrt(torch.clamp_min(
        torch.sum(vlad * vlad, -1, keepdim=True), 1e-24))
    v = vlad.reshape(-1)
    return v / torch.clamp_min(torch.linalg.norm(v), 1e-12)


@torch.no_grad()
def openibl_descriptor(net: OpenIBLNet, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] on the net's device -> (32768,)
    L2-normalised descriptor."""
    with float32_exact():
        return vlad_pool(net, backbone_features(net, image))


def openibl_from_jax_params(params: Dict[str, Any],
                            device="cuda") -> OpenIBLNet:
    """The JAX package's params (numpy; kernels OIHW, ``score_w`` (C, K),
    ``centroids`` (K, C)) -> the net."""
    net = OpenIBLNet(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    for idx, p in zip(CONV_IDX, params["features"]):
        net.base_model[idx].weight.copy_(t(p["kernel"]))
        net.base_model[idx].bias.copy_(t(p["bias"]))
    net.net_vlad.conv.weight.copy_(
        t(np.asarray(params["score_w"]).T[:, :, None, None]))
    net.net_vlad.centroids.copy_(t(params["centroids"]))
    return net


def load_openibl(state_dict: Dict[str, Any], device="cuda") -> OpenIBLNet:
    """The ``vgg16_netvlad`` state dict (``base_model.{i}.*``,
    ``net_vlad.conv.weight``, ``net_vlad.centroids``) -> the net, loaded
    strictly."""
    net = OpenIBLNet(device)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                         for k, v in state_dict.items()}, strict=True)
    return net
