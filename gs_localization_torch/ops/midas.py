"""MiDaS v2.1 monocular depth (ResNeXt101-WSL + fusion decoder), on the
port.

The fallback depth prior, as the JAX package's ``ops/midas.py`` computes
it: a ResNeXt101 32x8d backbone with inference batch norm, four 256-channel
feature-fusion blocks (residual conv units, 2x align-corners upsampling)
and the head (conv, 2x bilinear upsampling, conv + ReLU, 1x1 + ReLU: non-
negative inverse depth). ``estimate_depth`` resizes to 384x512 and back
with ``ops.resize.resize`` (``jax.image.resize``'s Keys cubic), and the
head's 2x bilinear upsampling is that resize too.

Weights: ``midas_from_jax_params`` (the JAX package's params tree; the
stage depths are read off it) or ``convert_torch_weights_midas`` (the
``midas_v21-f6b98070.pt`` state dict), held in a ``ParamTree``; the
convolutions are ``F.conv2d`` under ``float32_exact``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import float32_exact, resolve_device
from .param_tree import ParamTree
from .resize import resize

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
STAGE_BLOCKS = (3, 4, 23, 3)
STAGE_CH = (256, 512, 1024, 2048)
GROUPS = 32
FEAT = 256
BN_EPS = 1e-5
NET_SIZE = (384, 512)


class MiDaS(ParamTree):
    """The JAX package's MiDaS params tree (``pretrained``, ``scratch``) as
    frozen parameters; the forward is ``midas_forward``."""

    def __init__(self, params: Dict[str, Any], device="cuda"):
        super().__init__(params, resolve_device(device))
        self.requires_grad_(False)
        self.eval()

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return midas_forward(self, image)


def _conv(x, kernel, stride=1, pad=None, groups=1):
    k = kernel.shape[2]
    return F.conv2d(x, kernel, stride=stride,
                    padding=k // 2 if pad is None else pad, groups=groups)


def _bias(b):
    return b[None, :, None, None]


def _bn(p, x):
    """Inference batch norm in the JAX package's operation order."""
    inv = torch.rsqrt(p["var"] + BN_EPS)
    return (x - _bias(p["mean"])) * _bias(inv) * _bias(p["gamma"]) \
        + _bias(p["beta"])


def _bottleneck(p, x, stride):
    y = F.relu(_bn(p["bn1"], _conv(x, p["conv1"], 1, pad=0)))
    y = F.relu(_bn(p["bn2"], _conv(y, p["conv2"], stride, groups=GROUPS)))
    y = _bn(p["bn3"], _conv(y, p["conv3"], 1, pad=0))
    if "down" in p:
        x = _bn(p["down_bn"], _conv(x, p["down"], stride, pad=0))
    return F.relu(x + y)


def backbone(p, x):
    """NCHW input -> the four stage outputs (1/4 .. 1/32)."""
    x = F.relu(_bn(p["bn1"], _conv(x, p["conv1"], 2, pad=3)))
    x = F.max_pool2d(x, 3, 2, padding=1)       # pads with -inf
    outs = []
    for s, blocks in enumerate(p["layers"]):
        for i, bp in enumerate(blocks):
            x = _bottleneck(bp, x, 2 if (i == 0 and s > 0) else 1)
        outs.append(x)
    return outs


def _residual_conv_unit(p, x):
    y = _conv(F.relu(x), p["conv1"], 1) + _bias(p["b1"])
    y = _conv(F.relu(y), p["conv2"], 1) + _bias(p["b2"])
    return x + y


def _fusion(p, x, skip=None):
    if skip is not None:
        x = x + _residual_conv_unit(p["rcu1"], skip)
    x = _residual_conv_unit(p["rcu2"], x)
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


@torch.no_grad()
def midas_forward(params: MiDaS, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] (H, W % 32 == 0) on the net's device ->
    (H, W) inverse depth."""
    mean = torch.tensor(_MEAN, device=image.device)
    std = torch.tensor(_STD, device=image.device)
    with float32_exact():
        x = ((image - mean) / std).permute(2, 0, 1)[None]
        l1, l2, l3, l4 = backbone(params["pretrained"], x)
        s = params["scratch"]
        r1 = _conv(l1, s["layer1_rn"], 1)
        r2 = _conv(l2, s["layer2_rn"], 1)
        r3 = _conv(l3, s["layer3_rn"], 1)
        r4 = _conv(l4, s["layer4_rn"], 1)
        p4 = _fusion(s["refinenet4"], r4)
        p3 = _fusion(s["refinenet3"], p4, r3)
        p2 = _fusion(s["refinenet2"], p3, r2)
        p1 = _fusion(s["refinenet1"], p2, r1)
        y = _conv(p1, s["out1"], 1) + _bias(s["out1_b"])
        n, c, h, w = y.shape
        y = resize(y, (n, c, 2 * h, 2 * w), "bilinear")
        y = F.relu(_conv(y, s["out2"], 1) + _bias(s["out2_b"]))
        y = F.relu(_conv(y, s["out3"], 1, pad=0) + _bias(s["out3_b"]))
    return y[0, 0]


@torch.no_grad()
def estimate_depth(params: MiDaS, image: torch.Tensor, out_h: int,
                   out_w: int):
    """The reference protocol: the net at 384x512, Keys-cubic resizes both
    ways (antialiased where they downscale)."""
    with float32_exact():
        x = resize(image, (*NET_SIZE, 3), "cubic")
        d = midas_forward(params, x)
        return resize(d, (out_h, out_w), "cubic")


def make_midas_estimator(params: MiDaS):
    """-> ``depth_estimator(rgb (H, W, 3) numpy) -> (H, W) numpy`` for
    ``train_map``; the image goes to the net's device."""
    dev = params["pretrained"]["conv1"].device

    def estimator(rgb: np.ndarray) -> np.ndarray:
        h, w = rgb.shape[:2]
        x = torch.as_tensor(np.asarray(rgb, np.float32), device=dev)
        return estimate_depth(params, x, h, w).cpu().numpy()

    return estimator


def init_params(rng: np.random.Generator,
                stage_blocks=STAGE_BLOCKS) -> Dict[str, Any]:
    """Random weights (numpy), the JAX package's ``init_params`` draws:
    He-scaled HWIO kernels, identity batch norms, zero biases."""
    f32 = np.float32

    def conv(k, cin, cout, groups=1):
        return (rng.standard_normal((k, k, cin // groups, cout))
                * np.sqrt(2.0 / (k * k * cin / groups))).astype(f32)

    def bnp(c):
        return {"gamma": np.ones(c, f32), "beta": np.zeros(c, f32),
                "mean": np.zeros(c, f32), "var": np.ones(c, f32)}

    def bottleneck(cin, cmid, cout, downsample):
        p = {"conv1": conv(1, cin, cmid), "bn1": bnp(cmid),
             "conv2": conv(3, cmid, cmid, GROUPS), "bn2": bnp(cmid),
             "conv3": conv(1, cmid, cout), "bn3": bnp(cout)}
        if downsample:
            p["down"] = conv(1, cin, cout)
            p["down_bn"] = bnp(cout)
        return p

    layers, cin = [], 64
    for s, nb in enumerate(stage_blocks):
        cout = STAGE_CH[s]
        cmid = cout // 2            # resnext 32x8d width
        blocks = [bottleneck(cin, cmid, cout, True)]
        for _ in range(nb - 1):
            blocks.append(bottleneck(cout, cmid, cout, False))
        layers.append(blocks)
        cin = cout

    def rcu():
        return {"conv1": conv(3, FEAT, FEAT), "b1": np.zeros(FEAT, f32),
                "conv2": conv(3, FEAT, FEAT), "b2": np.zeros(FEAT, f32)}

    scratch = {f"layer{k + 1}_rn": conv(3, STAGE_CH[k], FEAT)
               for k in range(4)}
    for k in range(1, 5):
        scratch[f"refinenet{k}"] = {"rcu1": rcu(), "rcu2": rcu()}
    scratch.update({
        "out1": conv(3, FEAT, 128), "out1_b": np.zeros(128, f32),
        "out2": conv(3, 128, 32), "out2_b": np.zeros(32, f32),
        "out3": conv(1, 32, 1), "out3_b": np.zeros(1, f32)})
    return {"pretrained": {"conv1": conv(7, 3, 64), "bn1": bnp(64),
                           "layers": layers},
            "scratch": scratch}


def midas_from_jax_params(params: Dict[str, Any], device="cuda") -> MiDaS:
    """The JAX package's params tree (numpy; conv kernels HWIO) -> the
    net."""
    return MiDaS(params, device)


def convert_torch_weights_midas(state_dict: Dict[str, Any]
                                ) -> Dict[str, Any]:
    """The official ``midas_v21`` state dict -> the JAX package's params
    tree (numpy), for ``midas_from_jax_params``.

    Layout: ``pretrained.layer1`` = Sequential(conv1, bn1, relu, maxpool,
    layer1) of torchvision's resnext101_32x8d (indices 0, 1 and 4 hold
    weights), ``pretrained.layer{2,3,4}`` the plain stages;
    ``scratch.layer{k}_rn``, ``scratch.refinenet{k}.resConfUnit{1,2}
    .conv{1,2}``, ``scratch.output_conv.{0,2,4}``. The blocks per stage are
    read off the keys."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                        else v, np.float32)
          for k, v in state_dict.items()}

    def conv_t(key):
        return sd[key].transpose(2, 3, 1, 0)

    def bn_t(prefix):
        return {"gamma": sd[f"{prefix}.weight"],
                "beta": sd[f"{prefix}.bias"],
                "mean": sd[f"{prefix}.running_mean"],
                "var": sd[f"{prefix}.running_var"]}

    def block(prefix):
        p = {"conv1": conv_t(f"{prefix}.conv1.weight"),
             "bn1": bn_t(f"{prefix}.bn1"),
             "conv2": conv_t(f"{prefix}.conv2.weight"),
             "bn2": bn_t(f"{prefix}.bn2"),
             "conv3": conv_t(f"{prefix}.conv3.weight"),
             "bn3": bn_t(f"{prefix}.bn3")}
        if f"{prefix}.downsample.0.weight" in sd:
            p["down"] = conv_t(f"{prefix}.downsample.0.weight")
            p["down_bn"] = bn_t(f"{prefix}.downsample.1")
        return p

    layers = []
    for prefix in ("pretrained.layer1.4", "pretrained.layer2",
                   "pretrained.layer3", "pretrained.layer4"):
        n = 0
        while f"{prefix}.{n}.conv1.weight" in sd:
            n += 1
        if n == 0:
            raise KeyError(f"no blocks under {prefix}")
        layers.append([block(f"{prefix}.{i}") for i in range(n)])

    def rcu(prefix):
        return {"conv1": conv_t(f"{prefix}.conv1.weight"),
                "b1": sd[f"{prefix}.conv1.bias"],
                "conv2": conv_t(f"{prefix}.conv2.weight"),
                "b2": sd[f"{prefix}.conv2.bias"]}

    scratch: Dict[str, Any] = {}
    for k in range(1, 5):
        scratch[f"layer{k}_rn"] = conv_t(f"scratch.layer{k}_rn.weight")
        scratch[f"refinenet{k}"] = {
            "rcu1": rcu(f"scratch.refinenet{k}.resConfUnit1"),
            "rcu2": rcu(f"scratch.refinenet{k}.resConfUnit2")}
    for j, name in ((0, "out1"), (2, "out2"), (4, "out3")):
        scratch[name] = conv_t(f"scratch.output_conv.{j}.weight")
        scratch[f"{name}_b"] = sd[f"scratch.output_conv.{j}.bias"]
    return {"pretrained": {"conv1": conv_t("pretrained.layer1.0.weight"),
                           "bn1": bn_t("pretrained.layer1.1"),
                           "layers": layers},
            "scratch": scratch}


def midas_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A params tree as an official MiDaS v2.1 state dict (numpy; the
    inverse of ``convert_torch_weights_midas``)."""
    sd: Dict[str, np.ndarray] = {}

    def put(key, a):
        a = np.asarray(a, np.float32)
        sd[key] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a

    def put_bn(prefix, p):
        for suffix, key in (("weight", "gamma"), ("bias", "beta"),
                            ("running_mean", "mean"), ("running_var", "var")):
            put(f"{prefix}.{suffix}", p[key])

    p = params["pretrained"]
    put("pretrained.layer1.0.weight", p["conv1"])
    put_bn("pretrained.layer1.1", p["bn1"])
    for prefix, blocks in zip(("pretrained.layer1.4", "pretrained.layer2",
                               "pretrained.layer3", "pretrained.layer4"),
                              p["layers"]):
        for i, blk in enumerate(blocks):
            pre = f"{prefix}.{i}"
            for c in (1, 2, 3):
                put(f"{pre}.conv{c}.weight", blk[f"conv{c}"])
                put_bn(f"{pre}.bn{c}", blk[f"bn{c}"])
            if "down" in blk:
                put(f"{pre}.downsample.0.weight", blk["down"])
                put_bn(f"{pre}.downsample.1", blk["down_bn"])
    s = params["scratch"]
    for k in range(1, 5):
        put(f"scratch.layer{k}_rn.weight", s[f"layer{k}_rn"])
        for r in (1, 2):
            unit = s[f"refinenet{k}"][f"rcu{r}"]
            pre = f"scratch.refinenet{k}.resConfUnit{r}"
            for c in (1, 2):
                put(f"{pre}.conv{c}.weight", unit[f"conv{c}"])
                put(f"{pre}.conv{c}.bias", unit[f"b{c}"])
    for j, name in ((0, "out1"), (2, "out2"), (4, "out3")):
        put(f"scratch.output_conv.{j}.weight", s[name])
        put(f"scratch.output_conv.{j}.bias", s[f"{name}_b"])
    return sd


def load_midas(state_dict: Dict[str, Any], device="cuda") -> MiDaS:
    """A ``midas_v21-f6b98070.pt`` state dict -> the net."""
    return MiDaS(convert_torch_weights_midas(state_dict), device)
