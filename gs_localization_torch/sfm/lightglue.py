"""LightGlue attentional matcher, on the port.

The public LightGlue architecture (Lindenberger et al., ICCV 2023) as the
JAX package's ``sfm/lightglue.py`` computes it: a learnable Fourier rotary
encoding of the keypoints, 9 layers of rotary self-attention and
bidirectional cross-attention with concat-FFN residuals, and a
sigmoid-matchability double-softmax assignment head. The full static stack
runs, without the adaptive depth / width pruning (the reference's "max
accuracy" setting), and only the last layer's assignment head is read.
Invalid keypoint slots stay in the attention, as in JAX.

``LightGlueNet`` carries the official submodule names (``posenc.Wr``,
``input_proj``, ``transformers.{i}.{self_attn,cross_attn}.*``,
``log_assignment.{i}.*``), so ``superpoint_lightglue.pth`` loads by name
(``load_lightglue``, which also takes the published ``self_attn.{i}.*`` /
``cross_attn.{i}.*`` naming); ``lightglue_from_jax_params`` carries the
JAX package's params over. The attention is the same matmul -> softmax ->
matmul as in JAX (not ``scaled_dot_product_attention``, whose fused paths
sum in another order and may run below float32).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import float32_exact, resolve_device
from ..ops.param_tree import load_named
from .superglue import SuperGlueResult

DIM = 256
NUM_HEADS = 4
HEAD_DIM = DIM // NUM_HEADS
NUM_LAYERS = 9
LN_EPS = 1e-5


def _ffn_seq(dev) -> nn.Sequential:
    """Linear(2d, 2d), LayerNorm, GELU, Linear(2d, d) (indices 0, 1, 3)."""
    return nn.Sequential(nn.Linear(2 * DIM, 2 * DIM, device=dev),
                         nn.LayerNorm(2 * DIM, device=dev), nn.GELU(),
                         nn.Linear(2 * DIM, DIM, device=dev))


class _SelfBlock(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.Wqkv = nn.Linear(DIM, 3 * DIM, device=dev)
        self.out_proj = nn.Linear(DIM, DIM, device=dev)
        self.ffn = _ffn_seq(dev)


class _CrossBlock(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.to_qk = nn.Linear(DIM, DIM, device=dev)
        self.to_v = nn.Linear(DIM, DIM, device=dev)
        self.to_out = nn.Linear(DIM, DIM, device=dev)
        self.ffn = _ffn_seq(dev)


class _TransformerLayer(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.self_attn = _SelfBlock(dev)
        self.cross_attn = _CrossBlock(dev)


class _MatchAssignment(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.matchability = nn.Linear(DIM, 1, device=dev)
        self.final_proj = nn.Linear(DIM, DIM, device=dev)


class _Posenc(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.Wr = nn.Linear(2, HEAD_DIM // 2, bias=False, device=dev)


class LightGlueNet(nn.Module):
    """The weights of LightGlue under the official names; the forward is
    ``lightglue_match``."""

    def __init__(self, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.posenc = _Posenc(dev)
        self.input_proj = nn.Linear(DIM, DIM, device=dev)
        self.transformers = nn.ModuleList([_TransformerLayer(dev)
                                           for _ in range(NUM_LAYERS)])
        self.log_assignment = nn.ModuleList([_MatchAssignment(dev)
                                             for _ in range(NUM_LAYERS)])
        self.requires_grad_(False)
        self.eval()


# ----------------------------------------------------------- layer math
def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ lin.weight.T
    return y if lin.bias is None else y + lin.bias


def _layernorm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean((x - mu) ** 2, -1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * ln.weight + ln.bias


def _ffn(seq: nn.Sequential, x, message):
    h = _linear(seq[0], torch.cat([x, message], -1))
    h = F.gelu(_layernorm(seq[1], h))
    return x + _linear(seq[3], h)


def normalize_keypoints(kpts: torch.Tensor, width: int, height: int):
    """Shift by size / 2, scale by max(size) / 2 (LightGlue's convention)."""
    size = torch.tensor([width, height], dtype=torch.float32,
                        device=kpts.device)
    return (kpts - size / 2) / (torch.max(size) / 2)


def fourier_rotary_encoding(posenc: _Posenc, kpts_norm: torch.Tensor):
    """(N, 2) -> (2, N, HEAD_DIM) cos / sin tables, each value twice."""
    proj = kpts_norm @ posenc.Wr.weight.T                # (N, HEAD_DIM/2)
    cos = torch.repeat_interleave(torch.cos(proj), 2, dim=-1)
    sin = torch.repeat_interleave(torch.sin(proj), 2, dim=-1)
    return torch.stack([cos, sin], 0)


def _rotate_half(x):
    """(..., 2k) -> interleaved (-x2, x1) pairs."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], -1).reshape(*x1.shape[:-1], -1)


def _apply_rotary(enc, t):
    """t: (N, H, HEAD_DIM); enc: (2, N, HEAD_DIM)."""
    cos, sin = enc[0][:, None, :], enc[1][:, None, :]
    return t * cos + _rotate_half(t) * sin


def _self_block(blk: _SelfBlock, x, enc):
    n, d = x.shape
    qkv = _linear(blk.Wqkv, x).reshape(n, NUM_HEADS, 3, HEAD_DIM)
    q = _apply_rotary(enc, qkv[:, :, 0])
    k = _apply_rotary(enc, qkv[:, :, 1])
    v = qkv[:, :, 2]
    logits = torch.einsum("nhd,mhd->hnm", q, k) / float(np.sqrt(HEAD_DIM))
    attn = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("hnm,mhd->nhd", attn, v).reshape(n, d)
    return _ffn(blk.ffn, x, _linear(blk.out_proj, ctx))


def _cross_block(blk: _CrossBlock, x0, x1):
    scale = HEAD_DIM ** -0.25
    qk0 = _linear(blk.to_qk, x0).reshape(-1, NUM_HEADS, HEAD_DIM) * scale
    qk1 = _linear(blk.to_qk, x1).reshape(-1, NUM_HEADS, HEAD_DIM) * scale
    v0 = _linear(blk.to_v, x0).reshape(-1, NUM_HEADS, HEAD_DIM)
    v1 = _linear(blk.to_v, x1).reshape(-1, NUM_HEADS, HEAD_DIM)
    sim = torch.einsum("nhd,mhd->hnm", qk0, qk1)
    m0 = torch.einsum("hnm,mhd->nhd", torch.softmax(sim, -1), v1)
    m1 = torch.einsum("hnm,nhd->mhd", torch.softmax(sim, 1), v0)
    m0 = _linear(blk.to_out, m0.reshape(x0.shape[0], DIM))
    m1 = _linear(blk.to_out, m1.reshape(x1.shape[0], DIM))
    return _ffn(blk.ffn, x0, m0), _ffn(blk.ffn, x1, m1)


def sigmoid_log_double_softmax(sim: torch.Tensor, z0: torch.Tensor,
                               z1: torch.Tensor) -> torch.Tensor:
    """(M, N) similarities and per-point matchability logits -> the
    (M+1, N+1) log assignment with dustbins."""
    m, n = sim.shape
    cert = F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None, :]
    s0 = torch.log_softmax(sim, dim=1)
    s1 = torch.log_softmax(sim, dim=0)
    scores = torch.zeros((m + 1, n + 1), dtype=sim.dtype, device=sim.device)
    scores[:m, :n] = s0 + s1 + cert
    scores[:m, n] = F.logsigmoid(-z0)
    scores[m, :n] = F.logsigmoid(-z1)
    return scores


def match_assignment(head: _MatchAssignment, d0, d1):
    md0 = _linear(head.final_proj, d0) / DIM ** 0.25
    md1 = _linear(head.final_proj, d1) / DIM ** 0.25
    sim = md0 @ md1.T
    z0 = _linear(head.matchability, d0)[:, 0]
    z1 = _linear(head.matchability, d1)[:, 0]
    return sigmoid_log_double_softmax(sim, z0, z1)


# --------------------------------------------------------------- forward
@torch.no_grad()
def lightglue_match(
    net: LightGlueNet,
    kpts0: torch.Tensor, desc0: torch.Tensor,
    kpts1: torch.Tensor, desc1: torch.Tensor,
    width0: int, height0: int, width1: int, height1: int,
    match_threshold: float = 0.1,
) -> SuperGlueResult:
    """Match two keypoint sets on the net's device; desc* are (N, 256)
    SuperPoint descriptors."""
    with float32_exact():
        enc0 = fourier_rotary_encoding(
            net.posenc, normalize_keypoints(kpts0, width0, height0))
        enc1 = fourier_rotary_encoding(
            net.posenc, normalize_keypoints(kpts1, width1, height1))
        d0 = _linear(net.input_proj, desc0)
        d1 = _linear(net.input_proj, desc1)
        for lyr in net.transformers:
            d0 = _self_block(lyr.self_attn, d0, enc0)
            d1 = _self_block(lyr.self_attn, d1, enc1)
            d0, d1 = _cross_block(lyr.cross_attn, d0, d1)
        Z = match_assignment(net.log_assignment[-1], d0, d1)

    Zin = Z[:-1, :-1]
    idx0 = torch.argmax(Zin, dim=1)
    idx1 = torch.argmax(Zin, dim=0)
    n0, n1 = Zin.shape
    mutual0 = torch.arange(n0, device=Z.device) == idx1[idx0]
    mutual1 = torch.arange(n1, device=Z.device) == idx0[idx1]
    ms0 = torch.where(mutual0, torch.exp(torch.amax(Zin, dim=1)), 0.0)
    ms1 = torch.where(mutual1, ms0[idx1], 0.0)
    valid0 = mutual0 & (ms0 > match_threshold)
    valid1 = mutual1 & valid0[idx1]
    return SuperGlueResult(
        matches0=torch.where(valid0, idx0, -1),
        matches1=torch.where(valid1, idx1, -1),
        matching_scores0=ms0,
        matching_scores1=ms1,
    )


# ------------------------------------------------------------ convert
def lightglue_from_jax_params(params: Dict[str, Any],
                              device="cuda") -> LightGlueNet:
    """The JAX package's params (numpy; dense ``w`` as (in, out)) -> the
    net. JAX keeps only the last layer's assignment head; the other eight
    heads, which the static stack does not read, keep their initial
    values."""
    net = LightGlueNet(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def dense(lin, p):
        lin.weight.copy_(t(np.asarray(p["w"]).T))
        if "b" in p:
            lin.bias.copy_(t(p["b"]))

    def ffn(seq, p):
        dense(seq[0], p["fc1"])
        seq[1].weight.copy_(t(p["ln"]["gamma"]))
        seq[1].bias.copy_(t(p["ln"]["beta"]))
        dense(seq[3], p["fc2"])

    dense(net.posenc.Wr, params["posenc"]["Wr"])
    dense(net.input_proj, params["input_proj"])
    for lyr, p in zip(net.transformers, params["layers"]):
        sa, ca = p["self_attn"], p["cross_attn"]
        dense(lyr.self_attn.Wqkv, sa["Wqkv"])
        dense(lyr.self_attn.out_proj, sa["out_proj"])
        ffn(lyr.self_attn.ffn, sa["ffn"])
        for name in ("to_qk", "to_v", "to_out"):
            dense(getattr(lyr.cross_attn, name), ca[name])
        ffn(lyr.cross_attn.ffn, ca["ffn"])
    head = params["log_assignment"]
    dense(net.log_assignment[-1].matchability, head["matchability"])
    dense(net.log_assignment[-1].final_proj, head["final_proj"])
    return net


_PUBLISHED = re.compile(r"^(self_attn|cross_attn)\.(\d+)\.")


def load_lightglue(state_dict: Dict[str, Any], device="cuda") -> LightGlueNet:
    """An official ``superpoint_lightglue.pth`` state dict -> the net.

    Takes the published naming (``self_attn.{i}.*``, ``cross_attn.{i}.*``)
    and the in-code one (``transformers.{i}.self_attn.*``). The
    ``token_confidence.*`` heads serve only the adaptive depth, which the
    static stack does not run, and are not read; every other weight must
    be present."""
    sd = {_PUBLISHED.sub(r"transformers.\2.\1.", k): v
          for k, v in state_dict.items()
          if not k.startswith("token_confidence.")}
    return load_named(LightGlueNet(device), sd, "lightglue")


def lightglue_state_dict(net: LightGlueNet) -> Dict[str, torch.Tensor]:
    """The net's weights under the published naming of
    ``superpoint_lightglue.pth`` (``self_attn.{i}.*``, ``cross_attn.{i}.*``,
    ``log_assignment.{i}.*``)."""
    return {re.sub(r"^transformers\.(\d+)\.(self_attn|cross_attn)\.",
                   r"\2.\1.", k): v.detach().cpu().clone()
            for k, v in net.state_dict().items()}
