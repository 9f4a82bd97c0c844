"""LoFTR detector-free dense matcher, on the port.

The LoFTR architecture (Sun et al., CVPR 2021) as the JAX package's
``sfm/loftr.py`` computes it: a ResNet-FPN(8, 2) backbone over grayscale,
a 2D sine positional encoding, a coarse linear-attention transformer
(['self', 'cross'] x 4) on 1/8-resolution 256-d features, dual-softmax
coarse matching (temperature 0.1, mutual nearest neighbour, threshold 0.2,
2 coarse cells of border removed), and fine refinement: 5x5 windows of
1/2-resolution 128-d features around each coarse match, one more
self / cross transformer, and a spatial-softmax expectation for the
sub-pixel offset on image0.

As in JAX:

- the FPN upsamples with ``jax.image.resize``'s bilinear weights
  (``ops/resize.py``);
- the linear attention's three-operand product contracts Q with KV first,
  then scales by the normaliser (JAX's einsum path);
- the variable match count is a fixed capacity (``max_matches``): a
  stable descending sort, equal scores lowest cell first (``lax.top_k``'s
  order; the dead slots, score 0, are all ties);
- the fine windows are one gather with clamped indices, and the fine
  transformer runs on the batch of windows (JAX ``vmap``s it).

``LoFTRNet`` carries the official submodule names (``backbone.*``,
``loftr_coarse.layers.*``, ``fine_preprocess.*``, ``loftr_fine.layers.*``),
so the ``state_dict`` of ``outdoor_ds.ckpt`` loads by name once its
``matcher.`` prefix is cut (``load_loftr``); ``loftr_from_jax_params``
carries the JAX package's params over.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import float32_exact, resolve_device
from ..ops.param_tree import load_named
from ..ops.resize import resize
from .features import top_k_stable

D_COARSE = 256
D_FINE = 128
NHEAD = 8
COARSE_LAYERS = 4          # x ['self', 'cross']
FINE_WINDOW = 5
TEMPERATURE = 0.1
BLOCK_DIMS = (128, 196, 256)
INITIAL_DIM = 128
BN_EPS = 1e-5
LN_EPS = 1e-5


class LoftrMatches(NamedTuple):
    kpts0: torch.Tensor     # (M, 2) sub-pixel in image0
    kpts1: torch.Tensor     # (M, 2) coarse centres in image1
    scores: torch.Tensor    # (M,) dual-softmax confidence; 0 = dead slot


# ------------------------------------------------------------- modules
def _conv(cin, cout, k, stride, dev) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False, device=dev)


class _BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride, dev):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, dev)
        self.conv2 = _conv(cout, cout, 3, 1, dev)
        self.bn1 = nn.BatchNorm2d(cout, device=dev)
        self.bn2 = nn.BatchNorm2d(cout, device=dev)
        self.stride = stride
        if stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride, dev),
                                            nn.BatchNorm2d(cout, device=dev))


def _outconv2_seq(cin, cout, dev) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cin, 3, 1, dev),
                         nn.BatchNorm2d(cin, device=dev), nn.LeakyReLU(),
                         _conv(cin, cout, 3, 1, dev))


class _ResNetFPN(nn.Module):
    def __init__(self, dev):
        super().__init__()
        d1, d2, d3 = BLOCK_DIMS
        self.conv1 = nn.Conv2d(1, INITIAL_DIM, 7, stride=2, padding=3,
                               bias=False, device=dev)
        self.bn1 = nn.BatchNorm2d(INITIAL_DIM, device=dev)
        self.layer1 = nn.Sequential(_BasicBlock(INITIAL_DIM, d1, 1, dev),
                                    _BasicBlock(d1, d1, 1, dev))
        self.layer2 = nn.Sequential(_BasicBlock(d1, d2, 2, dev),
                                    _BasicBlock(d2, d2, 1, dev))
        self.layer3 = nn.Sequential(_BasicBlock(d2, d3, 2, dev),
                                    _BasicBlock(d3, d3, 1, dev))
        self.layer3_outconv = _conv(d3, d3, 1, 1, dev)
        self.layer2_outconv = _conv(d2, d3, 1, 1, dev)
        self.layer2_outconv2 = _outconv2_seq(d3, d2, dev)
        self.layer1_outconv = _conv(d1, d2, 1, 1, dev)
        self.layer1_outconv2 = _outconv2_seq(d2, d1, dev)


class _EncoderLayer(nn.Module):
    def __init__(self, d, dev):
        super().__init__()
        for name in ("q_proj", "k_proj", "v_proj", "merge"):
            setattr(self, name, nn.Linear(d, d, bias=False, device=dev))
        self.mlp = nn.Sequential(
            nn.Linear(2 * d, 2 * d, bias=False, device=dev), nn.ReLU(),
            nn.Linear(2 * d, d, bias=False, device=dev))
        self.norm1 = nn.LayerNorm(d, device=dev)
        self.norm2 = nn.LayerNorm(d, device=dev)
        self.d_model = d


class _Transformer(nn.Module):
    def __init__(self, d, n_layers, dev):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(d, dev)
                                     for _ in range(n_layers)])


class _FinePreprocess(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.down_proj = nn.Linear(D_COARSE, D_FINE, device=dev)
        self.merge_feat = nn.Linear(2 * D_FINE, D_FINE, device=dev)


class LoFTRNet(nn.Module):
    """The weights of LoFTR under the official names; the forward is
    ``loftr_match``."""

    def __init__(self, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.backbone = _ResNetFPN(dev)
        self.loftr_coarse = _Transformer(D_COARSE, 2 * COARSE_LAYERS, dev)
        self.fine_preprocess = _FinePreprocess(dev)
        self.loftr_fine = _Transformer(D_FINE, 2, dev)
        self.requires_grad_(False)
        self.eval()


# ----------------------------------------------------------- layer math
def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Inference batch norm on NCHW, in JAX's operation order."""
    def c(v):
        return v[:, None, None]
    inv = torch.rsqrt(bn.running_var + BN_EPS)
    return (x - c(bn.running_mean)) * c(inv) * c(bn.weight) + c(bn.bias)


def _block(blk: _BasicBlock, x):
    y = F.relu(_bn(blk.bn1, blk.conv1(x)))
    y = _bn(blk.bn2, blk.conv2(y))
    if blk.stride != 1:
        x = _bn(blk.downsample[1], blk.downsample[0](x))
    return F.relu(x + y)


def _up(x, like):
    """``jax.image.resize`` bilinear of NCHW ``x`` to ``like``'s size."""
    return resize(x, (*x.shape[:2], *like.shape[2:]), "bilinear")


def _outconv2(seq: nn.Sequential, x):
    return seq[3](F.leaky_relu(_bn(seq[1], seq[0](x)), 0.01))


def backbone_fpn(net: LoFTRNet, image: torch.Tensor):
    """(H, W) grayscale -> (coarse (H/8, W/8, 256), fine (H/2, W/2, 128))."""
    p = net.backbone
    x = image[None, None]
    x0 = F.relu(_bn(p.bn1, p.conv1(x)))                                # 1/2
    x1 = _block(p.layer1[1], _block(p.layer1[0], x0))                  # 1/2
    x2 = _block(p.layer2[1], _block(p.layer2[0], x1))                  # 1/4
    x3 = _block(p.layer3[1], _block(p.layer3[0], x2))                  # 1/8

    x3_out = p.layer3_outconv(x3)
    x2_out = _outconv2(p.layer2_outconv2,
                       p.layer2_outconv(x2) + _up(x3_out, x2))
    x1_out = _outconv2(p.layer1_outconv2,
                       p.layer1_outconv(x1) + _up(x2_out, x1))
    return x3_out[0].permute(1, 2, 0), x1_out[0].permute(1, 2, 0)


def sine_pos_encoding(h: int, w: int, d_model: int = D_COARSE) -> np.ndarray:
    """(h, w, d) fixed 2D sine encoding (LoFTR's PositionEncodingSine with
    the corrected normalisation)."""
    pe = np.zeros((d_model, h, w), np.float32)
    ypos = np.cumsum(np.ones((h, w), np.float32), 0)[None]
    xpos = np.cumsum(np.ones((h, w), np.float32), 1)[None]
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                 * (-np.log(10000.0) / (d_model // 2)))[:, None, None]
    pe[0::4] = np.sin(xpos * div)
    pe[1::4] = np.cos(xpos * div)
    pe[2::4] = np.sin(ypos * div)
    pe[3::4] = np.cos(ypos * div)
    return pe.transpose(1, 2, 0)


def _linear_attention(q, k, v, eps=1e-6):
    """(B, L, H, D) x (B, S, H, D) x (B, S, H, D) -> (B, L, H, D), the
    elu + 1 feature map."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    s = v.shape[1]
    v = v / s
    KV = torch.einsum("bshd,bshv->bhdv", K, v)
    Z = 1.0 / (torch.einsum("blhd,bhd->blh", Q, torch.sum(K, 1)) + eps)
    return torch.einsum("blhd,bhdv->blhv", Q, KV) * Z[..., None] * s


def _layernorm(ln: nn.LayerNorm, x):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean((x - mu) ** 2, -1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * ln.weight + ln.bias


def _encoder_layer(lyr: _EncoderLayer, x, source):
    """x (B, L, d), source (B, S, d)."""
    d = lyr.d_model
    hd = d // NHEAD
    b, L, S = x.shape[0], x.shape[1], source.shape[1]
    q = (x @ lyr.q_proj.weight.T).reshape(b, L, NHEAD, hd)
    k = (source @ lyr.k_proj.weight.T).reshape(b, S, NHEAD, hd)
    v = (source @ lyr.v_proj.weight.T).reshape(b, S, NHEAD, hd)
    msg = _linear_attention(q, k, v).reshape(b, L, d)
    msg = _layernorm(lyr.norm1, msg @ lyr.merge.weight.T)
    msg = torch.cat([x, msg], -1)
    msg = F.relu(msg @ lyr.mlp[0].weight.T)
    msg = _layernorm(lyr.norm2, msg @ lyr.mlp[2].weight.T)
    return x + msg


def _transformer(tf: _Transformer, f0, f1):
    for i, lyr in enumerate(tf.layers):
        if i % 2 == 0:      # self
            f0 = _encoder_layer(lyr, f0, f0)
            f1 = _encoder_layer(lyr, f1, f1)
        else:               # cross
            f0, f1 = (_encoder_layer(lyr, f0, f1),
                      _encoder_layer(lyr, f1, f0))
    return f0, f1


def _unfold(fmap, cy, cx):
    """(M, W*W, C) windows of ``fmap`` (h, w, C) centred on (cy, cx),
    indices clamped to the map."""
    hf, wf, c = fmap.shape
    off = torch.arange(FINE_WINDOW, device=fmap.device) - FINE_WINDOW // 2
    ys = torch.clamp(cy[:, None] + off, 0, hf - 1)
    xs = torch.clamp(cx[:, None] + off, 0, wf - 1)
    return fmap[ys[:, :, None], xs[:, None, :]].reshape(
        cy.shape[0], FINE_WINDOW * FINE_WINDOW, c)


# --------------------------------------------------------------- forward
@torch.no_grad()
def loftr_match(net: LoFTRNet, image0: torch.Tensor, image1: torch.Tensor,
                max_matches: int = 512,
                match_threshold: float = 0.2) -> LoftrMatches:
    """Dense-match two grayscale images ((H, W) in [0, 1], H, W % 8 == 0)
    on the net's device. As hloc's wrapper does, the sub-pixel expectation
    lands on image0's keypoints."""
    dev = image0.device
    with float32_exact():
        c0, f0 = backbone_fpn(net, image0)
        c1, f1 = backbone_fpn(net, image1)
        hc0, wc0, _ = c0.shape
        hc1, wc1, _ = c1.shape
        pe0 = torch.from_numpy(sine_pos_encoding(hc0, wc0)).to(dev)
        pe1 = torch.from_numpy(sine_pos_encoding(hc1, wc1)).to(dev)
        fc0 = (c0 + pe0).reshape(1, -1, D_COARSE)
        fc1 = (c1 + pe1).reshape(1, -1, D_COARSE)
        fc0, fc1 = _transformer(net.loftr_coarse, fc0, fc1)
        fc0, fc1 = fc0[0], fc1[0]

        # dual-softmax coarse matching
        n0 = fc0 / D_COARSE ** 0.5
        n1 = fc1 / D_COARSE ** 0.5
        sim = (n0 @ n1.T) / TEMPERATURE
        conf = torch.softmax(sim, 1) * torch.softmax(sim, 0)
        idx1 = torch.argmax(conf, dim=1)
        idx0 = torch.argmax(conf, dim=0)
        cells0 = torch.arange(conf.shape[0], device=dev)
        mutual = cells0 == idx0[idx1]
        best = torch.amax(conf, dim=1)
        # border removal (2 coarse cells)
        yy0, xx0 = cells0 // wc0, cells0 % wc0
        inb0 = (xx0 >= 2) & (xx0 < wc0 - 2) & (yy0 >= 2) & (yy0 < hc0 - 2)
        yy1, xx1 = idx1 // wc1, idx1 % wc1
        inb1 = (xx1 >= 2) & (xx1 < wc1 - 2) & (yy1 >= 2) & (yy1 < hc1 - 2)
        keep = mutual & (best > match_threshold) & inb0 & inb1
        score = torch.where(keep, best, 0.0)
        vals, m_idx0 = top_k_stable(score, max_matches)
        m_idx1 = idx1[m_idx0]

        # fine refinement on image0's keypoints; coarse-cell centres at
        # the fine (1/2) resolution are cell * 4
        W = FINE_WINDOW
        fp = net.fine_preprocess
        w0 = _unfold(f0, (m_idx0 // wc0) * 4, (m_idx0 % wc0) * 4)
        w1 = _unfold(f1, (m_idx1 // wc1) * 4, (m_idx1 % wc1) * 4)
        cwin0 = fc0[m_idx0] @ fp.down_proj.weight.T + fp.down_proj.bias
        cwin1 = fc1[m_idx1] @ fp.down_proj.weight.T + fp.down_proj.bias

        def merge(wf, cw):
            cat = torch.cat([wf, cw[:, None, :].expand(wf.shape)], -1)
            return cat @ fp.merge_feat.weight.T + fp.merge_feat.bias

        w0, w1 = _transformer(net.loftr_fine, merge(w0, cwin0),
                              merge(w1, cwin1))

        # the centre of w1 against all of w0, the expectation in w0
        center = w1[:, W * W // 2, :]                         # (M, 128)
        sim_f = torch.einsum("mc,mwc->mw", center, w0) / (D_FINE ** 0.5)
        prob = torch.softmax(sim_f / 1.0, dim=-1)             # (M, WW)
        grid = torch.arange(W * W, device=dev)
        gy = (grid // W - W // 2).to(torch.float32)
        gx = (grid % W - W // 2).to(torch.float32)
        dx = prob @ gx
        dy = prob @ gy

    valid = vals > 0
    # the fine grid's step is 2 px; coarse centres at 8 * cell + 3.5
    kx0 = (m_idx0 % wc0).to(torch.float32) * 8 + 3.5 + dx * 2
    ky0 = (m_idx0 // wc0).to(torch.float32) * 8 + 3.5 + dy * 2
    kx1 = (m_idx1 % wc1).to(torch.float32) * 8 + 3.5
    ky1 = (m_idx1 // wc1).to(torch.float32) * 8 + 3.5
    return LoftrMatches(
        kpts0=torch.where(valid[:, None], torch.stack([kx0, ky0], 1), -1.0),
        kpts1=torch.where(valid[:, None], torch.stack([kx1, ky1], 1), -1.0),
        scores=torch.where(valid, vals, 0.0),
    )


# ------------------------------------------------------------ convert
def loftr_from_jax_params(params: Dict[str, Any], device="cuda") -> LoFTRNet:
    """The JAX package's params (numpy; kernels HWIO, dense (in, out)) ->
    the net."""
    net = LoFTRNet(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def conv(c, k):
        c.weight.copy_(t(np.asarray(k).transpose(3, 2, 0, 1)))

    def bn(b, p):
        b.weight.copy_(t(p["gamma"]))
        b.bias.copy_(t(p["beta"]))
        b.running_mean.copy_(t(p["mean"]))
        b.running_var.copy_(t(p["var"]))

    def block(blk, p):
        conv(blk.conv1, p["conv1"])
        bn(blk.bn1, p["bn1"])
        conv(blk.conv2, p["conv2"])
        bn(blk.bn2, p["bn2"])
        if "down" in p:
            conv(blk.downsample[0], p["down"])
            bn(blk.downsample[1], p["down_bn"])

    pb, bb = params["backbone"], net.backbone
    conv(bb.conv1, pb["conv1"])
    bn(bb.bn1, pb["bn1"])
    for name in ("layer1", "layer2", "layer3"):
        for blk, p in zip(getattr(bb, name), pb[name]):
            block(blk, p)
    for lvl in ("layer3", "layer2", "layer1"):
        conv(getattr(bb, f"{lvl}_outconv"), pb[f"{lvl}_outconv"])
    for lvl in ("layer2", "layer1"):
        seq = getattr(bb, f"{lvl}_outconv2")
        conv(seq[0], pb[f"{lvl}_outconv2_a"])
        bn(seq[1], pb[f"{lvl}_outconv2_bn"])
        conv(seq[3], pb[f"{lvl}_outconv2_b"])

    def enc(lyr, p):
        for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                          ("merge", "merge")):
            getattr(lyr, name).weight.copy_(t(np.asarray(p[key]).T))
        lyr.mlp[0].weight.copy_(t(np.asarray(p["mlp1"]).T))
        lyr.mlp[2].weight.copy_(t(np.asarray(p["mlp2"]).T))
        for name in ("norm1", "norm2"):
            getattr(lyr, name).weight.copy_(t(p[name]["gamma"]))
            getattr(lyr, name).bias.copy_(t(p[name]["beta"]))

    for lyr, p in zip(net.loftr_coarse.layers, params["coarse"]):
        enc(lyr, p)
    for lyr, p in zip(net.loftr_fine.layers, params["fine"]):
        enc(lyr, p)
    fp = params["fine_preprocess"]
    net.fine_preprocess.down_proj.weight.copy_(t(np.asarray(
        fp["down_proj_w"]).T))
    net.fine_preprocess.down_proj.bias.copy_(t(fp["down_proj_b"]))
    net.fine_preprocess.merge_feat.weight.copy_(t(np.asarray(
        fp["merge_w"]).T))
    net.fine_preprocess.merge_feat.bias.copy_(t(fp["merge_b"]))
    return net


def load_loftr(state_dict: Dict[str, Any], device="cuda") -> LoFTRNet:
    """The ``state_dict`` of an official ``{outdoor,indoor}_ds.ckpt``
    (keys under ``matcher.``, or without the prefix) -> the net. Every
    weight and statistic must be present; the batch norms'
    ``num_batches_tracked`` counters may be absent."""
    return load_named(LoFTRNet(device), state_dict, "loftr",
                      prefix="matcher.")
