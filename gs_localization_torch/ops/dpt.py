"""MiDaS DPT_Hybrid (R50 + ViT-B/16 + DPT decoder) monocular depth, on the
port.

The reference's pseudo-depth prior, as the JAX package's ``ops/dpt.py``
computes it:

- hybrid backbone: ResNetV2 stem + 3 stages (3, 4, 9 bottlenecks,
  weight-standardised convs + GroupNorm(32), TF-"same" asymmetric
  padding), a 1x1 patch embedding of the /16 map into 768-d tokens, a cls
  token, bilinearly resized position embeddings, and 12 pre-LN ViT-B
  blocks (12 heads, MLP 3,072, exact GELU, LN eps 1e-6);
- taps: ResNet stages 1-2 (/4, /8) and transformer blocks 9 and 12;
- readout "project": the cls token concatenated onto every patch token,
  Linear(1536 -> 768) + GELU; tap 4 adds a stride-2 3x3 conv (/32);
- decoder: per-tap 3x3 convs to 256 channels, four fusion blocks (residual
  conv units, 2x align-corners upsampling, 1x1 out conv) and the
  monodepth head (non-negative inverse depth).

``estimate_depth`` resizes to 384x512 and back with ``ops.resize.resize``
(``jax.image.resize``'s Keys cubic, antialiased when it downscales; not
``F.interpolate``'s bicubic). Weights: ``dpt_from_jax_params`` (the JAX
package's params tree) or ``convert_torch_weights_dpt`` (the torch.hub /
``dpt_hybrid-midas-501f0c75.pt`` state dict), held in a ``ParamTree``. The
convolutions are ``F.conv2d`` under ``float32_exact``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import float32_exact, resolve_device
from ..utils.profiling import count, span
from .param_tree import ParamTree
from .resize import resize

_MEAN = (0.5, 0.5, 0.5)
_STD = (0.5, 0.5, 0.5)
EMBED = 768
HEADS = 12
MLP = 3072
FEAT = 256
STAGE_BLOCKS = (3, 4, 9)
STAGE_CH = (256, 512, 1024)
GN_GROUPS = 32
GN_EPS = 1e-5
LN_EPS = 1e-6
WS_EPS = 1e-6          # timm StdConv2d weight-standardisation epsilon
NET_SIZE = (384, 512)  # estimate_depth's network input (H, W)


class DPT(ParamTree):
    """The JAX package's DPT params tree (``pretrained``, ``scratch``) as
    frozen parameters; the forward is ``dpt_forward``."""

    def __init__(self, params: Dict[str, Any], device="cuda"):
        super().__init__(params, resolve_device(device))
        self.requires_grad_(False)
        self.eval()

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return dpt_forward(self, image)


# ----------------------------------------------------------- conv helpers --
def _pad_same(h: int, k: int, s: int) -> Tuple[int, int]:
    """TF-'same' padding (timm StdConv2dSame): asymmetric, bottom / right
    heavy."""
    pad = max((-(-h // s) - 1) * s + k - h, 0)
    return pad // 2, pad - pad // 2


def _std_conv(x, w, stride=1):
    """Weight-standardised conv (OIHW kernel; mean and variance over the
    in-channel and spatial axes), TF-same padding."""
    mu = torch.mean(w, dim=(1, 2, 3), keepdim=True)
    var = torch.var(w, dim=(1, 2, 3), keepdim=True, unbiased=False)
    w = (w - mu) * torch.rsqrt(var + WS_EPS)
    k = w.shape[2]
    ph = _pad_same(x.shape[2], k, stride)
    pw = _pad_same(x.shape[3], k, stride)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _conv(x, w, b=None, stride=1, pad=None):
    """Plain conv, symmetric padding (default k // 2)."""
    k = w.shape[2]
    return F.conv2d(x, w, b, stride=stride,
                    padding=k // 2 if pad is None else pad)


def _gn(p, x, act=True):
    """GroupNorm(32) + optional ReLU (timm GroupNormAct)."""
    y = F.group_norm(x, GN_GROUPS, p["gamma"], p["beta"], eps=GN_EPS)
    return F.relu(y) if act else y


def _ln(p, x):
    return F.layer_norm(x, (x.shape[-1],), p["gamma"], p["beta"], eps=LN_EPS)


# ------------------------------------------------------------- backbone ----
def _bottleneck_v2(p, x, stride):
    """timm ResNetV2 non-preact bottleneck: StdConv + GN(+ReLU) x3,
    act-free norm3, ReLU after the residual add."""
    sc = x
    if "down_w" in p:
        sc = _gn(p["down_gn"], _std_conv(x, p["down_w"], stride), act=False)
    y = _gn(p["gn1"], _std_conv(x, p["conv1"], 1))
    y = _gn(p["gn2"], _std_conv(y, p["conv2"], stride))
    y = _gn(p["gn3"], _std_conv(y, p["conv3"], 1), act=False)
    return F.relu(y + sc)


def _maxpool_same(x, k=3, s=2):
    ph = _pad_same(x.shape[2], k, s)
    pw = _pad_same(x.shape[3], k, s)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=-float("inf"))
    return F.max_pool2d(x, k, s)


def resnet_stem_stages(p, x) -> List[torch.Tensor]:
    """-> [stage0 (/4, 256), stage1 (/8, 512), stage2 (/16, 1024)]."""
    x = _gn(p["stem_gn"], _std_conv(x, p["stem_conv"], 2))
    x = _maxpool_same(x)
    outs = []
    for s, blocks in enumerate(p["stages"]):
        for i, bp in enumerate(blocks):
            x = _bottleneck_v2(bp, x, 2 if (i == 0 and s > 0) else 1)
        outs.append(x)
    return outs


def _attention(p, x):
    """(N, C) tokens, multi-head self-attention."""
    n, c = x.shape
    qkv = (x @ p["qkv_w"].T + p["qkv_b"]).reshape(n, 3, HEADS, c // HEADS)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]                # (N, H, D)
    att = torch.einsum("nhd,mhd->hnm", q * (c // HEADS) ** -0.5, k)
    att = torch.softmax(att, dim=-1)
    y = torch.einsum("hnm,mhd->nhd", att, v).reshape(n, c)
    return y @ p["proj_w"].T + p["proj_b"]


def _vit_block(p, x):
    x = x + _attention(p["attn"], _ln(p["ln1"], x))
    h = F.gelu(_ln(p["ln2"], x) @ p["fc1_w"].T + p["fc1_b"])
    return x + (h @ p["fc2_w"].T + p["fc2_b"])


def _resize_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(1, 1 + g0*g0, C) -> (1 + gh*gw, C), the grid part resized
    bilinearly without antialiasing (F.interpolate align_corners=False
    semantics, as JAX's resize computes them)."""
    cls, grid = pos[0, :1], pos[0, 1:]
    g0 = int(round(float(np.sqrt(grid.shape[0]))))
    grid = resize(grid.reshape(g0, g0, -1), (gh, gw, grid.shape[-1]),
                  "bilinear", antialias=False)
    return torch.cat([cls, grid.reshape(gh * gw, -1)], dim=0)


def hybrid_backbone(p, x) -> List[torch.Tensor]:
    """-> [l1 (/4, 256), l2 (/8, 512), t9 tokens, t12 tokens]: NCHW maps
    and (1 + N, C) tokens; the token taps are blocks 9 and 12."""
    s0, s1, s2 = resnet_stem_stages(p["resnet"], x)
    _, _, gh, gw = s2.shape
    tok = _conv(s2, p["embed_w"], p["embed_b"], pad=0)[0]
    tok = tok.permute(1, 2, 0).reshape(-1, EMBED)
    tok = torch.cat([p["cls_token"], tok], dim=0)
    tok = tok + _resize_pos_embed(p["pos_embed"], gh, gw)
    taps = []
    for i, bp in enumerate(p["blocks"]):
        tok = _vit_block(bp, tok)
        if i in (8, 11):
            taps.append(tok)
    return [s0, s1, taps[0], taps[1]]


def _project_readout(p, tok, gh, gw):
    """Tokens (1+N, C) -> (1, C, gh, gw): the cls token concatenated onto
    each patch token, Linear(2C -> C) + GELU (DPT ProjectReadout)."""
    cls, patches = tok[:1], tok[1:]
    cat = torch.cat([patches, cls.expand_as(patches)], dim=-1)
    y = F.gelu(cat @ p["w"].T + p["b"])
    return y.reshape(gh, gw, EMBED).permute(2, 0, 1)[None]


# -------------------------------------------------------------- decoder ----
def _upsample2_ac(x):
    """2x bilinear, align_corners=True."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def _rcu(p, x):
    """ResidualConvUnit_custom (bn=False): relu-conv-relu-conv + skip."""
    y = _conv(F.relu(x), p["conv1_w"], p["conv1_b"])
    y = _conv(F.relu(y), p["conv2_w"], p["conv2_b"])
    return x + y


def _fusion(p, x, skip=None):
    """FeatureFusionBlock_custom: optional skip RCU, RCU, 2x up, 1x1 out."""
    if skip is not None:
        x = x + _rcu(p["rcu1"], skip)
    x = _upsample2_ac(_rcu(p["rcu2"], x))
    return _conv(x, p["out_w"], p["out_b"], pad=0)


@torch.no_grad()
def dpt_forward(params: DPT, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] (H, W % 32 == 0) on the net's device ->
    (H, W) inverse depth; span ``prior/net``."""
    mean = torch.tensor(_MEAN, device=image.device)
    std = torch.tensor(_STD, device=image.device)
    with span("prior/net"), float32_exact():
        x = ((image - mean) / std).permute(2, 0, 1)[None]
        p = params["pretrained"]
        l1, l2, t3, t4 = hybrid_backbone(p, x)
        gh, gw = l2.shape[2] // 2, l2.shape[3] // 2
        l3 = _conv(_project_readout(p["readout3"], t3, gh, gw),
                   p["post3_w"], p["post3_b"], pad=0)
        l4 = _project_readout(p["readout4"], t4, gh, gw)
        l4 = _conv(l4, p["post4a_w"], p["post4a_b"], pad=0)
        l4 = _conv(l4, p["post4b_w"], p["post4b_b"], stride=2)
        s = params["scratch"]
        r1 = _conv(l1, s["layer1_rn"])
        r2 = _conv(l2, s["layer2_rn"])
        r3 = _conv(l3, s["layer3_rn"])
        r4 = _conv(l4, s["layer4_rn"])
        p4 = _fusion(s["refinenet4"], r4)
        p3 = _fusion(s["refinenet3"], p4, r3)
        p2 = _fusion(s["refinenet2"], p3, r2)
        p1 = _fusion(s["refinenet1"], p2, r1)
        y = _upsample2_ac(_conv(p1, s["out1_w"], s["out1_b"]))
        y = F.relu(_conv(y, s["out2_w"], s["out2_b"]))
        y = F.relu(_conv(y, s["out3_w"], s["out3_b"], pad=0))
    return y[0, 0]


@torch.no_grad()
def estimate_depth(params: DPT, image: torch.Tensor, out_h: int, out_w: int):
    """The reference protocol: the net at 384x512, Keys-cubic resizes both
    ways (antialiased where they downscale); spans ``prior/resize`` (each
    resize) and ``prior/net``."""
    with float32_exact():
        with span("prior/resize"):
            x = resize(image, (*NET_SIZE, 3), "cubic")
        d = dpt_forward(params, x)
        with span("prior/resize"):
            return resize(d, (out_h, out_w), "cubic")


def make_dpt_estimator(params: DPT):
    """-> ``depth_estimator(rgb (H, W, 3) numpy) -> (H, W) numpy`` for
    ``train_map``; the image goes to the net's device, and the prior's
    readback counts ``host_sync/prior``."""
    dev = params["pretrained"]["embed_b"].device

    def estimator(rgb: np.ndarray) -> np.ndarray:
        h, w = rgb.shape[:2]
        x = torch.as_tensor(np.asarray(rgb, np.float32), device=dev)
        d = estimate_depth(params, x, h, w)
        count("host_sync/prior")
        return d.cpu().numpy()

    return estimator


def dpt_from_jax_params(params: Dict[str, Any], device="cuda") -> DPT:
    """The JAX package's params tree (numpy; conv kernels HWIO, linear
    weights (out, in)) -> the net."""
    return DPT(params, device)


# ------------------------------------------------------------ init/convert -
def init_params(rng: np.random.Generator, depth: int = 12,
                stage_blocks=STAGE_BLOCKS, grid: int = 24) -> Dict[str, Any]:
    """Random weights (numpy), the JAX package's ``init_params`` draws:
    conv kernels HWIO with He scaling, GroupNorm affine near 1 / 0, linear
    weights (out, in) scaled by 1 / sqrt(in)."""
    f32 = np.float32

    def conv(k, cin, cout):
        return (rng.standard_normal((k, k, cin, cout))
                * np.sqrt(2.0 / (k * k * cin))).astype(f32)

    def gnp(c):
        return {"gamma": rng.uniform(0.5, 1.5, c).astype(f32),
                "beta": 0.1 * rng.standard_normal(c).astype(f32)}

    def lin(cin, cout):
        return ((rng.standard_normal((cout, cin))
                 * np.sqrt(1.0 / cin)).astype(f32),
                0.01 * rng.standard_normal(cout).astype(f32))

    stages, cin = [], 64
    for s, nb in enumerate(stage_blocks):
        cout, cmid = STAGE_CH[s], STAGE_CH[s] // 4
        blocks = []
        for i in range(nb):
            blk = {"conv1": conv(1, cin if i == 0 else cout, cmid),
                   "gn1": gnp(cmid),
                   "conv2": conv(3, cmid, cmid), "gn2": gnp(cmid),
                   "conv3": conv(1, cmid, cout), "gn3": gnp(cout)}
            if i == 0:
                blk["down_w"] = conv(1, cin, cout)
                blk["down_gn"] = gnp(cout)
            blocks.append(blk)
        stages.append(blocks)
        cin = cout

    def ln():
        return {"gamma": np.ones(EMBED, f32), "beta": np.zeros(EMBED, f32)}

    def vit_block():
        qkv_w, qkv_b = lin(EMBED, 3 * EMBED)
        proj_w, proj_b = lin(EMBED, EMBED)
        fc1_w, fc1_b = lin(EMBED, MLP)
        fc2_w, fc2_b = lin(MLP, EMBED)
        return {"ln1": ln(),
                "attn": {"qkv_w": qkv_w, "qkv_b": qkv_b,
                         "proj_w": proj_w, "proj_b": proj_b},
                "ln2": ln(),
                "fc1_w": fc1_w, "fc1_b": fc1_b,
                "fc2_w": fc2_w, "fc2_b": fc2_b}

    def readout():
        w, b = lin(2 * EMBED, EMBED)
        return {"w": w, "b": b}

    def zeros(c):
        return np.zeros(c, f32)

    def rcu():
        return {"conv1_w": conv(3, FEAT, FEAT), "conv1_b": zeros(FEAT),
                "conv2_w": conv(3, FEAT, FEAT), "conv2_b": zeros(FEAT)}

    def fusion():
        return {"rcu1": rcu(), "rcu2": rcu(),
                "out_w": conv(1, FEAT, FEAT), "out_b": zeros(FEAT)}

    pretrained = {
        "resnet": {"stem_conv": conv(7, 3, 64), "stem_gn": gnp(64),
                   "stages": stages},
        "embed_w": conv(1, STAGE_CH[-1], EMBED),
        "embed_b": zeros(EMBED),
        "cls_token": 0.02 * rng.standard_normal((1, EMBED)).astype(f32),
        "pos_embed": 0.02 * rng.standard_normal(
            (1, 1 + grid * grid, EMBED)).astype(f32),
        "blocks": [vit_block() for _ in range(depth)],
        "readout3": readout(), "readout4": readout(),
        "post3_w": conv(1, EMBED, EMBED), "post3_b": zeros(EMBED),
        "post4a_w": conv(1, EMBED, EMBED), "post4a_b": zeros(EMBED),
        "post4b_w": conv(3, EMBED, EMBED), "post4b_b": zeros(EMBED),
    }
    scratch = {
        "layer1_rn": conv(3, STAGE_CH[0], FEAT),
        "layer2_rn": conv(3, STAGE_CH[1], FEAT),
        "layer3_rn": conv(3, EMBED, FEAT),
        "layer4_rn": conv(3, EMBED, FEAT),
        "refinenet1": fusion(), "refinenet2": fusion(),
        "refinenet3": fusion(), "refinenet4": fusion(),
        "out1_w": conv(3, FEAT, 128), "out1_b": zeros(128),
        "out2_w": conv(3, 128, 32), "out2_b": zeros(32),
        "out3_w": conv(1, 32, 1), "out3_b": zeros(1),
    }
    return {"pretrained": pretrained, "scratch": scratch}


def dpt_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A params tree as a torch.hub DPT_Hybrid state dict (numpy; the
    inverse of ``convert_torch_weights_dpt``), e.g. to write a
    ``dpt_hybrid-midas-501f0c75.pt`` of random weights."""
    sd: Dict[str, np.ndarray] = {}

    def put(key, a):
        a = np.asarray(a, np.float32)
        sd[key] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a

    def put_affine(prefix, p):
        put(f"{prefix}.weight", p["gamma"])
        put(f"{prefix}.bias", p["beta"])

    bb = "pretrained.model.patch_embed.backbone"
    vm = "pretrained.model"
    pp = "pretrained.act_postprocess"
    p = params["pretrained"]
    put(f"{bb}.stem.conv.weight", p["resnet"]["stem_conv"])
    put_affine(f"{bb}.stem.norm", p["resnet"]["stem_gn"])
    for s, blocks in enumerate(p["resnet"]["stages"]):
        for i, blk in enumerate(blocks):
            pre = f"{bb}.stages.{s}.blocks.{i}"
            for c in (1, 2, 3):
                put(f"{pre}.conv{c}.weight", blk[f"conv{c}"])
                put_affine(f"{pre}.norm{c}", blk[f"gn{c}"])
            if "down_w" in blk:
                put(f"{pre}.downsample.conv.weight", blk["down_w"])
                put_affine(f"{pre}.downsample.norm", blk["down_gn"])
    put(f"{vm}.patch_embed.proj.weight", p["embed_w"])
    put(f"{vm}.patch_embed.proj.bias", p["embed_b"])
    put(f"{vm}.cls_token", np.asarray(p["cls_token"])[None])
    put(f"{vm}.pos_embed", p["pos_embed"])
    for i, blk in enumerate(p["blocks"]):
        pre = f"{vm}.blocks.{i}"
        put_affine(f"{pre}.norm1", blk["ln1"])
        put_affine(f"{pre}.norm2", blk["ln2"])
        for name in ("qkv", "proj"):
            put(f"{pre}.attn.{name}.weight", blk["attn"][f"{name}_w"])
            put(f"{pre}.attn.{name}.bias", blk["attn"][f"{name}_b"])
        for name in ("fc1", "fc2"):
            put(f"{pre}.mlp.{name}.weight", blk[f"{name}_w"])
            put(f"{pre}.mlp.{name}.bias", blk[f"{name}_b"])
    for idx in (3, 4):
        put(f"{pp}{idx}.0.project.0.weight", p[f"readout{idx}"]["w"])
        put(f"{pp}{idx}.0.project.0.bias", p[f"readout{idx}"]["b"])
    for key, name in ((f"{pp}3.3", "post3"), (f"{pp}4.3", "post4a"),
                      (f"{pp}4.4", "post4b")):
        put(f"{key}.weight", p[f"{name}_w"])
        put(f"{key}.bias", p[f"{name}_b"])
    s = params["scratch"]
    for k in range(1, 5):
        rn = f"scratch.refinenet{k}"
        put(f"scratch.layer{k}_rn.weight", s[f"layer{k}_rn"])
        f = s[f"refinenet{k}"]
        for unit, key in (("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2")):
            for c in (1, 2):
                put(f"{rn}.{unit}.conv{c}.weight", f[key][f"conv{c}_w"])
                put(f"{rn}.{unit}.conv{c}.bias", f[key][f"conv{c}_b"])
        put(f"{rn}.out_conv.weight", f["out_w"])
        put(f"{rn}.out_conv.bias", f["out_b"])
    for j, name in ((0, "out1"), (2, "out2"), (4, "out3")):
        put(f"scratch.output_conv.{j}.weight", s[f"{name}_w"])
        put(f"scratch.output_conv.{j}.bias", s[f"{name}_b"])
    return sd


def _count(sd, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def convert_torch_weights_dpt(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """torch.hub DPT_Hybrid (DPTDepthModel) state dict -> the JAX package's
    params tree (numpy), for ``dpt_from_jax_params``. Keys (isl-org/DPT):
    ``pretrained.model.patch_embed.backbone.{stem,stages.*}``,
    ``pretrained.model.{cls_token,pos_embed,blocks.*}``,
    ``pretrained.act_postprocess{3,4}.{0.project.0,3,4}``,
    ``scratch.{layer*_rn,refinenet*,output_conv.*}``; keys DPT does not
    read (the ViT's head and final norm) are ignored. The stage and block
    counts are read off the keys."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                        else v, np.float32)
          for k, v in state_dict.items()}

    def conv_t(key):
        w = sd[key]
        if w.ndim != 4:
            raise ValueError(f"{key}: expected a 4-d kernel, got {w.shape}")
        return w.transpose(2, 3, 1, 0)                     # OIHW -> HWIO

    def gn_t(prefix):
        return {"gamma": sd[f"{prefix}.weight"], "beta": sd[f"{prefix}.bias"]}

    bb = "pretrained.model.patch_embed.backbone"
    stages = []
    for s in range(_count(sd, bb + ".stages.{}.blocks.0.conv1.weight")):
        blocks = []
        n_blocks = _count(sd, f"{bb}.stages.{s}.blocks.{{}}.conv1.weight")
        for i in range(n_blocks):
            pre = f"{bb}.stages.{s}.blocks.{i}"
            blk = {"conv1": conv_t(f"{pre}.conv1.weight"),
                   "gn1": gn_t(f"{pre}.norm1"),
                   "conv2": conv_t(f"{pre}.conv2.weight"),
                   "gn2": gn_t(f"{pre}.norm2"),
                   "conv3": conv_t(f"{pre}.conv3.weight"),
                   "gn3": gn_t(f"{pre}.norm3")}
            if f"{pre}.downsample.conv.weight" in sd:
                blk["down_w"] = conv_t(f"{pre}.downsample.conv.weight")
                blk["down_gn"] = gn_t(f"{pre}.downsample.norm")
            blocks.append(blk)
        stages.append(blocks)

    vm = "pretrained.model"
    blocks = []
    for i in range(_count(sd, vm + ".blocks.{}.norm1.weight")):
        pre = f"{vm}.blocks.{i}"
        blocks.append({
            "ln1": gn_t(f"{pre}.norm1"),
            "attn": {"qkv_w": sd[f"{pre}.attn.qkv.weight"],
                     "qkv_b": sd[f"{pre}.attn.qkv.bias"],
                     "proj_w": sd[f"{pre}.attn.proj.weight"],
                     "proj_b": sd[f"{pre}.attn.proj.bias"]},
            "ln2": gn_t(f"{pre}.norm2"),
            "fc1_w": sd[f"{pre}.mlp.fc1.weight"],
            "fc1_b": sd[f"{pre}.mlp.fc1.bias"],
            "fc2_w": sd[f"{pre}.mlp.fc2.weight"],
            "fc2_b": sd[f"{pre}.mlp.fc2.bias"],
        })
    if len(blocks) != 12:
        raise ValueError(f"expected 12 ViT blocks, got {len(blocks)}")

    def readout(idx):
        pre = f"pretrained.act_postprocess{idx}.0.project.0"
        return {"w": sd[f"{pre}.weight"], "b": sd[f"{pre}.bias"]}

    cls = sd[f"{vm}.cls_token"]
    pos = sd[f"{vm}.pos_embed"]
    if cls.shape != (1, 1, EMBED) or pos.ndim != 3:
        raise ValueError(f"cls_token {cls.shape}, pos_embed {pos.shape}")
    pp = "pretrained.act_postprocess"
    pretrained = {
        "resnet": {"stem_conv": conv_t(f"{bb}.stem.conv.weight"),
                   "stem_gn": gn_t(f"{bb}.stem.norm"),
                   "stages": stages},
        "embed_w": conv_t(f"{vm}.patch_embed.proj.weight"),
        "embed_b": sd[f"{vm}.patch_embed.proj.bias"],
        "cls_token": cls[0],
        "pos_embed": pos,
        "blocks": blocks,
        "readout3": readout(3), "readout4": readout(4),
        "post3_w": conv_t(f"{pp}3.3.weight"), "post3_b": sd[f"{pp}3.3.bias"],
        "post4a_w": conv_t(f"{pp}4.3.weight"),
        "post4a_b": sd[f"{pp}4.3.bias"],
        "post4b_w": conv_t(f"{pp}4.4.weight"),
        "post4b_b": sd[f"{pp}4.4.bias"],
    }

    def rcu(prefix):
        return {"conv1_w": conv_t(f"{prefix}.conv1.weight"),
                "conv1_b": sd[f"{prefix}.conv1.bias"],
                "conv2_w": conv_t(f"{prefix}.conv2.weight"),
                "conv2_b": sd[f"{prefix}.conv2.bias"]}

    scratch: Dict[str, Any] = {}
    for k in range(1, 5):
        rn = f"scratch.refinenet{k}"
        scratch[f"layer{k}_rn"] = conv_t(f"scratch.layer{k}_rn.weight")
        scratch[f"refinenet{k}"] = {
            "rcu1": rcu(f"{rn}.resConfUnit1"),
            "rcu2": rcu(f"{rn}.resConfUnit2"),
            "out_w": conv_t(f"{rn}.out_conv.weight"),
            "out_b": sd[f"{rn}.out_conv.bias"]}
    for j, name in ((0, "out1"), (2, "out2"), (4, "out3")):
        scratch[f"{name}_w"] = conv_t(f"scratch.output_conv.{j}.weight")
        scratch[f"{name}_b"] = sd[f"scratch.output_conv.{j}.bias"]
    return {"pretrained": pretrained, "scratch": scratch}


def load_dpt(state_dict: Dict[str, Any], device="cuda") -> DPT:
    """A ``dpt_hybrid-midas-501f0c75.pt`` state dict -> the net."""
    return DPT(convert_torch_weights_dpt(state_dict), device)
