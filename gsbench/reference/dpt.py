"""Plain MiDaS DPT_Hybrid monocular depth, in any floating dtype.

The benchmark's own statement of the depth prior LoGS trains its few-shot
maps against (``utils/depth_utils.py``: MiDaS ``DPT_Hybrid`` from
torch.hub, frozen), written from the published description: Ranftl,
Bochkovskiy and Koltun, "Vision Transformers for Dense Prediction" (ICCV
2021), with timm's ``vit_base_resnet50_384`` as the backbone and MiDaS's
monodepth head. It reads the checkpoint's own state-dict keys
(``dpt_hybrid-midas-501f0c75.pt``: ``pretrained.model.*``,
``pretrained.act_postprocess{3,4}.*``, ``scratch.*``) and nothing of the
program.

- Backbone: timm's ResNetV2 without pre-activation: a 7x7 stride-2 stem,
  a 3x3 stride-2 max pool, stages of 3, 4 and 9 bottlenecks (256, 512,
  1,024 channels; the first block of stages 2 and 3 strides 2 in its 3x3
  conv); every conv weight-standardised and padded TensorFlow-"same"
  (bottom and right heavy; the pool pads with -inf); GroupNorm(32) after
  each, ReLU after all but the third and the shortcut's, ReLU after the
  residual sum. A 1x1 projection of the /16 map to 768-wide tokens, the
  class token, the 24x24 position embeddings resized bilinearly (half-pixel
  centres) to the token grid, and 12 pre-norm ViT-B blocks (12 heads, MLP
  3,072, exact GELU, LayerNorm eps 1e-6).
- Taps: stages 1 and 2 (/4, /8) and the outputs of blocks 9 and 12; the
  latter two read out by "project" (the class token concatenated onto each
  patch token, Linear(1,536 -> 768) and GELU), then a 1x1 conv (tap 3) or a
  1x1 and a stride-2 3x3 conv (tap 4, /32).
- Decoder: a 3x3 conv of each tap to 256 channels without bias; four
  fusion blocks (residual conv units relu-conv-relu-conv with a skip, 2x
  bilinear upsampling with aligned corners, a 1x1 conv); the head: 3x3 256
  -> 128, 2x upsampling, 3x3 128 -> 32, ReLU, 1x1 32 -> 1, ReLU.

``estimate_depth`` normalises nothing beyond (x - 0.5) / 0.5, resizes the
image to 384x512 and the inverse depth back to the image's size with Keys'
cubic (a = -0.5), antialiased where it shrinks, as separable matrices
built here in float64.

Departures from LoGS, all shared with the program: the resizes are Keys'
cubic, not torch's bicubic (a = -0.75) that MiDaS's transform and LoGS's
``F.interpolate`` call use; the weight standardisation's epsilon is 1e-6
(timm's releases have used 1e-5, 1e-6 and 1e-8 for this backbone); LoGS
also holds every training view's depth to the prior of its image, which
neither this file nor the program computes. The weights are drawn from a
seed, not MiDaS's.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

EMBED, HEADS = 768, 12
GN_GROUPS, GN_EPS, LN_EPS, WS_EPS = 32, 1e-5, 1e-6, 1e-6
NET_SIZE = (384, 512)

BB = "pretrained.model.patch_embed.backbone"
VIT = "pretrained.model"
POST = "pretrained.act_postprocess"


def no_tf32():
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def weights(state_dict, dtype, device) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors in ``dtype`` on ``device``."""
    return {k: torch.as_tensor(v).to(device=device, dtype=dtype)
            for k, v in state_dict.items()}


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    pad = max((-(-n // s) - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, k, s, value=0.0):
    (t, b), (lft, r) = _same(x.shape[2], k, s), _same(x.shape[3], k, s)
    return F.pad(x, (lft, r, t, b), value=value)


def std_conv(x, w, stride=1):
    mu = w.mean(dim=(1, 2, 3), keepdim=True)
    var = ((w - mu) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    w = (w - mu) / torch.sqrt(var + WS_EPS)
    return F.conv2d(_pad_same(x, w.shape[2], stride), w, stride=stride)


def group_norm(sd, key, x, relu=True):
    y = F.group_norm(x, GN_GROUPS, sd[key + ".weight"], sd[key + ".bias"],
                     eps=GN_EPS)
    return F.relu(y) if relu else y


def bottleneck(sd, pre, x, stride):
    if pre + ".downsample.conv.weight" in sd:
        short = group_norm(sd, pre + ".downsample.norm", std_conv(
            x, sd[pre + ".downsample.conv.weight"], stride), relu=False)
    else:
        short = x
    y = group_norm(sd, pre + ".norm1", std_conv(x, sd[pre + ".conv1.weight"]))
    y = group_norm(sd, pre + ".norm2",
                   std_conv(y, sd[pre + ".conv2.weight"], stride))
    y = group_norm(sd, pre + ".norm3", std_conv(y, sd[pre + ".conv3.weight"]),
                   relu=False)
    return F.relu(y + short)


def resnet(sd, x):
    """-> the outputs of stages 1, 2 and 3."""
    x = group_norm(sd, BB + ".stem.norm",
                   std_conv(x, sd[BB + ".stem.conv.weight"], 2))
    x = F.max_pool2d(_pad_same(x, 3, 2, -math.inf), 3, 2)
    outs = []
    s = 0
    while f"{BB}.stages.{s}.blocks.0.conv1.weight" in sd:
        i = 0
        while f"{BB}.stages.{s}.blocks.{i}.conv1.weight" in sd:
            x = bottleneck(sd, f"{BB}.stages.{s}.blocks.{i}", x,
                           2 if (s > 0 and i == 0) else 1)
            i += 1
        outs.append(x)
        s += 1
    return outs


def linear(sd, key, x):
    return x @ sd[key + ".weight"].T + sd[key + ".bias"]


def vit_block(sd, pre, x):
    """(B, N, C) tokens through one pre-norm block."""
    b, n, c = x.shape
    h = F.layer_norm(x, (c,), sd[pre + ".norm1.weight"],
                     sd[pre + ".norm1.bias"], eps=LN_EPS)
    qkv = linear(sd, pre + ".attn.qkv", h).reshape(b, n, 3, HEADS,
                                                   c // HEADS)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)             # (B, H, N, D) each
    att = torch.softmax((q @ k.transpose(-2, -1)) * (c // HEADS) ** -0.5,
                        dim=-1)
    y = (att @ v).transpose(1, 2).reshape(b, n, c)
    x = x + linear(sd, pre + ".attn.proj", y)
    h = F.layer_norm(x, (c,), sd[pre + ".norm2.weight"],
                     sd[pre + ".norm2.bias"], eps=LN_EPS)
    h = linear(sd, pre + ".mlp.fc2",
               F.gelu(linear(sd, pre + ".mlp.fc1", h)))
    return x + h


def pos_embed(sd, gh, gw):
    pos = sd[VIT + ".pos_embed"]                       # (1, 1 + g*g, C)
    g0 = int(round(math.sqrt(pos.shape[1] - 1)))
    grid = pos[:, 1:].reshape(1, g0, g0, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear",
                         align_corners=False)
    return torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], 1)


def readout(sd, idx, tok, gh, gw):
    """Tokens (B, 1 + N, C) -> (B, C, gh, gw): "project" readout."""
    patches = tok[:, 1:]
    cat = torch.cat([patches, tok[:, :1].expand_as(patches)], -1)
    y = F.gelu(linear(sd, f"{POST}{idx}.0.project.0", cat))
    return y.transpose(1, 2).reshape(tok.shape[0], EMBED, gh, gw)


def conv(sd, key, x, stride=1):
    w = sd[key + ".weight"]
    return F.conv2d(x, w, sd.get(key + ".bias"), stride=stride,
                    padding=w.shape[2] // 2)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def rcu(sd, pre, x):
    y = conv(sd, pre + ".conv1", F.relu(x))
    return x + conv(sd, pre + ".conv2", F.relu(y))


def fusion(sd, k, x, skip=None):
    pre = f"scratch.refinenet{k}"
    if skip is not None:
        x = x + rcu(sd, pre + ".resConfUnit1", skip)
    return conv(sd, pre + ".out_conv", up2(rcu(sd, pre + ".resConfUnit2", x)))


def forward(sd, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1], H and W multiples of 32 -> (H, W) inverse
    depth, in ``image``'s dtype (the weights' dtype too)."""
    x = ((image - 0.5) / 0.5).permute(2, 0, 1)[None]
    l1, l2, s3 = resnet(sd, x)
    gh, gw = s3.shape[2], s3.shape[3]
    tok = conv(sd, VIT + ".patch_embed.proj", s3).flatten(2).transpose(1, 2)
    tok = torch.cat([sd[VIT + ".cls_token"], tok], 1) + pos_embed(sd, gh, gw)
    taps = []
    i = 0
    while f"{VIT}.blocks.{i}.norm1.weight" in sd:
        tok = vit_block(sd, f"{VIT}.blocks.{i}", tok)
        if i in (8, 11):
            taps.append(tok)
        i += 1
    l3 = conv(sd, f"{POST}3.3", readout(sd, 3, taps[0], gh, gw))
    l4 = conv(sd, f"{POST}4.3", readout(sd, 4, taps[1], gh, gw))
    l4 = conv(sd, f"{POST}4.4", l4, stride=2)
    r = [conv(sd, f"scratch.layer{k}_rn", t)
         for k, t in zip(range(1, 5), (l1, l2, l3, l4))]
    p = fusion(sd, 4, r[3])
    p = fusion(sd, 3, p, r[2])
    p = fusion(sd, 2, p, r[1])
    p = fusion(sd, 1, p, r[0])
    y = up2(conv(sd, "scratch.output_conv.0", p))
    y = F.relu(conv(sd, "scratch.output_conv.2", y))
    y = F.relu(conv(sd, "scratch.output_conv.4", y))
    return y[0, 0]


def cubic_matrix(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """(n_out, n_in) Keys-cubic (a = -0.5) resampling at half-pixel
    centres; stretched by the scale when it shrinks (antialiasing); each
    row's weights renormalised over the taps inside the image."""
    scale = n_out / n_in
    stretch = max(1.0 / scale, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5
    x = (centre[:, None] - torch.arange(n_in, dtype=torch.float64)[None, :]
         ).abs() / stretch
    near = (1.5 * x - 2.5) * x * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    w = torch.where(x < 1.0, near, torch.where(x < 2.0, far,
                                               torch.zeros_like(x)))
    return (w / w.sum(1, keepdim=True)).to(device=device, dtype=dtype)


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W, ...) -> (h, w, ...) by the cubic matrices, rows then
    columns."""
    rows = cubic_matrix(x.shape[0], h, x.dtype, x.device)
    cols = cubic_matrix(x.shape[1], w, x.dtype, x.device)
    y = torch.tensordot(rows, x, dims=([1], [0]))
    return torch.movedim(torch.tensordot(cols, y, dims=([1], [1])), 0, 1)


def estimate_depth(sd, image: torch.Tensor, size=NET_SIZE) -> torch.Tensor:
    """(H, W, 3) RGB -> (H, W) inverse depth: the net at ``size`` (384x512),
    resized both ways."""
    h, w = image.shape[:2]
    return resize(forward(sd, resize(image, *size)), h, w)
