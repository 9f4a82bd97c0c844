"""EigenPlaces / CosPlace global descriptors, on the port.

hloc's EigenPlaces extractor as the JAX package's ``sfm/eigenplaces.py``
computes it. EigenPlaces and CosPlace share one architecture: a
torchvision ResNet cut after layer4 (the backbone of ``dir.py``), then
channel-wise L2 normalisation, GeM pooling (learned p, 3 by default), a
linear layer to ``fc_output_dim`` and L2 normalisation, on ImageNet-
normalised input. It differs from DIR's head by the channel normalisation
before GeM and by having no whitening.

``EigenPlacesNet`` carries the hub model's names (``backbone.{0,1,4..7}``,
``aggregation.1.p``, ``aggregation.3.{weight,bias}``), so its state dict
loads by name (``load_eigenplaces``); ``eigenplaces_from_jax_params``
carries the JAX package's params over.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .. import float32_exact, resolve_device
from ..ops.param_tree import load_named
from .dir import (FEATURES_DIM, GeM, arch_of, gem_pool, load_resnet_params,
                  resnet_forward, resnet_layers)


class EigenPlacesNet(nn.Module):
    """The hub model's layout: ``backbone`` (conv1, bn1, ReLU, max pool,
    layer1-4) and ``aggregation`` (L2, GeM, flatten, linear, L2); the
    forward is ``eigenplaces_descriptor``."""

    def __init__(self, arch: str = "resnet50", fc_output_dim: int = 2048,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.arch = arch
        self.backbone = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, device=dev),
            nn.BatchNorm2d(64, device=dev), nn.ReLU(),
            nn.MaxPool2d(3, 2, 1), *resnet_layers(arch, dev))
        self.aggregation = nn.Sequential(
            nn.Identity(), GeM(dev), nn.Flatten(),
            nn.Linear(FEATURES_DIM[arch], fc_output_dim, device=dev),
            nn.Identity())
        self.requires_grad_(False)
        self.eval()

    def stem_and_layers(self):
        bb = self.backbone
        return bb[0], bb[1], list(bb[4:8])


@torch.no_grad()
def eigenplaces_descriptor(net: EigenPlacesNet, image: torch.Tensor
                           ) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] on the net's device -> (fc_output_dim,)
    L2-normalised descriptor."""
    conv1, bn1, layers = net.stem_and_layers()
    fc = net.aggregation[3]
    with float32_exact():
        feat = resnet_forward(conv1, bn1, layers, image)        # (h, w, C)
        feat = feat * torch.rsqrt(torch.clamp_min(
            torch.sum(feat * feat, -1, keepdim=True), 1e-24))
        d = gem_pool(feat, net.aggregation[1].p)
        d = d @ fc.weight.T + fc.bias
    return d / torch.clamp_min(torch.linalg.norm(d), 1e-12)


def eigenplaces_from_jax_params(params: Dict[str, Any],
                                device="cuda") -> EigenPlacesNet:
    """The JAX package's params (the ``dir.py`` tree) -> the net."""
    fc_w = np.asarray(params["fc_w"], np.float32)
    net = EigenPlacesNet(arch_of(params), fc_w.shape[0], device)
    load_resnet_params(*net.stem_and_layers(), params)
    net.aggregation[3].weight.copy_(torch.tensor(fc_w))
    net.aggregation[3].bias.copy_(torch.tensor(
        np.asarray(params["fc_b"], np.float32)))
    net.aggregation[1].p.fill_(float(params["gemp"]))
    return net


def load_eigenplaces(state_dict: Dict[str, Any], arch: str = "resnet50",
                     device="cuda") -> EigenPlacesNet:
    """An EigenPlaces / CosPlace hub state dict -> the net. Every weight
    and statistic must be present; ``aggregation.1.p`` defaults to 3 and
    the batch norms' ``num_batches_tracked`` counters may be absent."""
    net = EigenPlacesNet(arch, np.shape(state_dict["aggregation.3.weight"])[0],
                         device)
    return load_named(net, state_dict, "eigenplaces",
                      optional=("aggregation.1.p",))
