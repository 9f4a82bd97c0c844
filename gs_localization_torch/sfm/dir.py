"""DIR (deep image retrieval, ResNet-AP-GeM) global descriptor, on the
port.

hloc's DIR extractor (Resnet-101-AP-GeM with the Landmarks_clean PCA
whitening) as the JAX package's ``sfm/dir.py`` computes it:

- backbone: a standard ResNet (conv 7x7 / 2, batch norm, ReLU, max pool
  3x3 / 2, four stages); ``ARCHS`` holds resnet18 / 50 / 101 / 152;
- head: GeM pooling with the learned exponent p
  (``mean(clamp(x, 1e-6) ** p) ** (1 / p)``), fc, L2;
- input: ImageNet mean / std;
- optional PCA whitening: ``(d - mean) @ components[:v].T / (m *
  var[:v] ** p')``, then L2 (hloc: p' = 0.25, all components, m = 1).

``DirNet`` carries dirtorch's names (``conv1``, ``bn1``,
``layer{1..4}.{i}.{conv,bn}{1..3}``, ``downsample.{0,1}``, ``fc``,
``adpool.p``), so the ``state_dict`` of ``Resnet101-AP-GeM-LM18.pt``
loads by name (``load_dir``, which cuts the ``module.`` prefix the
released file carries); ``dir_from_jax_params`` carries the JAX package's
params over. The whitening is a dict of arrays (``load_pca_from_sklearn``
reads any object with sklearn's PCA attributes).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import float32_exact, resolve_device
from ..ops.param_tree import load_named

RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)
BN_EPS = 1e-5
GEM_EPS = 1e-6

# block-structure table: name -> (block kind, stage depths)
ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}
# backbone feature dims after layer4
FEATURES_DIM = {"resnet18": 512, "resnet50": 2048, "resnet101": 2048,
                "resnet152": 2048}


class _Block(nn.Module):
    """A basic (two 3x3) or bottleneck (1x1, 3x3, 1x1) block; the stride
    sits on the 3x3 conv that the block's first conv is (basic) or follows
    (bottleneck)."""

    def __init__(self, kind, cin, width, stride, dev):
        super().__init__()
        cout = width * (4 if kind == "bottleneck" else 1)
        plan = (((1, cin, width), (3, width, width), (1, width, cout))
                if kind == "bottleneck" else
                ((3, cin, width), (3, width, width)))
        for i, (k, a, b) in enumerate(plan, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(a, b, k, padding=k // 2,
                                                bias=False, device=dev))
            setattr(self, f"bn{i}", nn.BatchNorm2d(b, device=dev))
        self.kind = kind
        self.stride = stride
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, bias=False, device=dev),
                nn.BatchNorm2d(cout, device=dev))


def resnet_layers(arch: str, dev) -> List[nn.Sequential]:
    """The four stages of ``arch``, torchvision's layout."""
    kind, depths = ARCHS[arch]
    expansion = 4 if kind == "bottleneck" else 1
    stages, cin, width = [], 64, 64
    for li, depth in enumerate(depths):
        blocks = []
        for bi in range(depth):
            stride = 2 if (li > 0 and bi == 0) else 1
            blocks.append(_Block(kind, cin, width, stride, dev))
            cin = width * expansion
        stages.append(nn.Sequential(*blocks))
        width *= 2
    return stages


class GeM(nn.Module):
    def __init__(self, dev, p: float = 3.0):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), p, device=dev))


class DirNet(nn.Module):
    """ResNet-AP-GeM under dirtorch's names; ``pca`` (None or a dict of
    tensors: mean, components, variance, whiten) is the optional
    whitening. The forward is ``dir_descriptor``."""

    def __init__(self, arch: str = "resnet101", out_dim: int = 2048,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.arch = arch
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                               device=dev)
        self.bn1 = nn.BatchNorm2d(64, device=dev)
        for i, stage in enumerate(resnet_layers(arch, dev), start=1):
            setattr(self, f"layer{i}", stage)
        self.fc = nn.Linear(FEATURES_DIM[arch], out_dim, device=dev)
        self.adpool = GeM(dev)
        self.pca: Optional[Dict[str, Any]] = None
        self.requires_grad_(False)
        self.eval()

    def set_pca(self, pca: Optional[Dict[str, Any]]) -> "DirNet":
        """Whitening arrays (``load_pca_from_sklearn``'s dict) on the net's
        device, or None for none."""
        dev = self.fc.weight.device
        self.pca = None if pca is None else {
            k: (bool(v) if k == "whiten" else
                torch.tensor(np.asarray(v, np.float32), device=dev))
            for k, v in pca.items()}
        return self


# ----------------------------------------------------------- layer math
def _bn(bn: nn.BatchNorm2d, x):
    def c(v):
        return v[:, None, None]
    inv = torch.rsqrt(bn.running_var + BN_EPS)
    return (x - c(bn.running_mean)) * c(inv * bn.weight) + c(bn.bias)


def _conv(conv: nn.Conv2d, x, stride=1):
    return F.conv2d(x, conv.weight, stride=stride,
                    padding=conv.kernel_size[0] // 2)


def _block(blk: _Block, x):
    r = x
    if blk.kind == "bottleneck":
        y = F.relu(_bn(blk.bn1, _conv(blk.conv1, x)))
        y = F.relu(_bn(blk.bn2, _conv(blk.conv2, y, blk.stride)))
        y = _bn(blk.bn3, _conv(blk.conv3, y))
    else:
        y = F.relu(_bn(blk.bn1, _conv(blk.conv1, x, blk.stride)))
        y = _bn(blk.bn2, _conv(blk.conv2, y))
    if hasattr(blk, "downsample"):
        r = _bn(blk.downsample[1], _conv(blk.downsample[0], x, blk.stride))
    return F.relu(y + r)


def resnet_forward(conv1: nn.Conv2d, bn1: nn.BatchNorm2d,
                   layers, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] -> (h, w, C) final-stage feature map."""
    mean = torch.from_numpy(RGB_MEAN).to(image.device)
    std = torch.from_numpy(RGB_STD).to(image.device)
    x = ((image.to(torch.float32) - mean) / std).permute(2, 0, 1)[None]
    x = F.relu(_bn(bn1, _conv(conv1, x, 2)))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage in layers:
        for blk in stage:
            x = _block(blk, x)
    return x[0].permute(1, 2, 0)


def backbone_forward(net: DirNet, image: torch.Tensor) -> torch.Tensor:
    return resnet_forward(net.conv1, net.bn1,
                          [getattr(net, f"layer{i}") for i in range(1, 5)],
                          image)


def gem_pool(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(h, w, C) -> (C,) generalised-mean pooling."""
    xp = torch.pow(torch.clamp_min(x, GEM_EPS), p)
    return torch.pow(torch.mean(xp, dim=(0, 1)), 1.0 / p)


def whiten(x: torch.Tensor, pca: Dict[str, Any], whitenp: float = 0.25,
           whitenv: Optional[int] = None, whitenm: float = 1.0
           ) -> torch.Tensor:
    """PCA-whiten the rows of (B, D) (dirtorch's ``whiten_features``)."""
    x = x - pca["mean"]
    y = x @ pca["components"][:whitenv].T
    if pca.get("whiten", True):
        y = y / (whitenm * torch.pow(pca["variance"][:whitenv], whitenp))
    return y / torch.clamp_min(torch.linalg.norm(y, dim=-1, keepdim=True),
                               1e-12)


@torch.no_grad()
def dir_descriptor(net: DirNet, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] on the net's device -> (D,) L2-normalised
    global descriptor."""
    with float32_exact():
        d = gem_pool(backbone_forward(net, image), net.adpool.p)
        d = d @ net.fc.weight.T + net.fc.bias
        d = d / torch.clamp_min(torch.linalg.norm(d), 1e-12)
        if net.pca is not None:
            d = whiten(d[None], net.pca)[0]
    return d


# ------------------------------------------------------------ convert
def load_resnet_params(conv1, bn1, layers, params: Dict[str, Any]) -> None:
    """Copy the JAX package's ResNet params (``conv1``, ``bn1``,
    ``layers``; kernels OIHW, bn {scale, bias, mean, var}) into modules."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def bn(b, p):
        b.weight.copy_(t(p["scale"]))
        b.bias.copy_(t(p["bias"]))
        b.running_mean.copy_(t(p["mean"]))
        b.running_var.copy_(t(p["var"]))

    conv1.weight.copy_(t(params["conv1"]))
    bn(bn1, params["bn1"])
    for stage, ps in zip(layers, params["layers"]):
        for blk, p in zip(stage, ps):
            for i in (1, 2, 3):
                if f"conv{i}" in p:
                    getattr(blk, f"conv{i}").weight.copy_(t(p[f"conv{i}"]))
                    bn(getattr(blk, f"bn{i}"), p[f"bn{i}"])
            if "down_w" in p:
                blk.downsample[0].weight.copy_(t(p["down_w"]))
                bn(blk.downsample[1], p["down_bn"])


def arch_of(params: Dict[str, Any]) -> str:
    """The ``ARCHS`` name of a JAX params tree (block kind, stage depths)."""
    depths = tuple(len(s) for s in params["layers"])
    return next(a for a, (kind, d) in ARCHS.items()
                if (kind, d) == (params["block"], depths))


def dir_from_jax_params(params: Dict[str, Any], device="cuda") -> DirNet:
    """The JAX package's params (``block``, ``conv1``, ``bn1``,
    ``layers``, ``fc_w``, ``fc_b``, ``gemp``, ``pca``) -> the net."""
    fc_w = np.asarray(params["fc_w"], np.float32)
    net = DirNet(arch_of(params), fc_w.shape[0], device)
    load_resnet_params(net.conv1, net.bn1,
                       [getattr(net, f"layer{i}") for i in range(1, 5)],
                       params)
    net.fc.weight.copy_(torch.tensor(fc_w))
    net.fc.bias.copy_(torch.tensor(np.asarray(params["fc_b"], np.float32)))
    net.adpool.p.fill_(float(params["gemp"]))
    return net.set_pca(params.get("pca"))


def load_dir(state_dict: Dict[str, Any], arch: str = "resnet101",
             pca: Optional[Dict[str, Any]] = None, device="cuda") -> DirNet:
    """dirtorch's ``ResNet_RMAC`` state dict (keys with or without the
    ``module.`` prefix) -> the net, with ``pca`` as its whitening. Every
    weight and statistic must be present; ``adpool.p`` defaults to 3 and
    the batch norms' ``num_batches_tracked`` counters may be absent."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    net = DirNet(arch, np.shape(sd["fc.weight"])[0], device)
    load_named(net, sd, "dir", optional=("adpool.p",))
    return net.set_pca(pca)


def load_pca_from_sklearn(pca_obj: Any) -> Dict[str, Any]:
    """An object with sklearn's PCA attributes (as dirtorch checkpoints
    store under ``pca['Landmarks_clean']``) -> whitening arrays."""
    return {
        "mean": np.asarray(pca_obj.mean_, np.float32),
        "components": np.asarray(pca_obj.components_, np.float32),
        "variance": np.asarray(pca_obj.explained_variance_, np.float32),
        "whiten": bool(getattr(pca_obj, "whiten", True)),
    }
