"""SuperGlue attentional matcher, on the port.

The public SuperGlue architecture (Sarlin et al., CVPR 2020) as the JAX
package's ``sfm/superglue.py`` computes it: a keypoint MLP encoder, 18
alternating self / cross attention layers (4 heads, dim 256), a final
projection, log-space Sinkhorn optimal transport with a learned dustbin,
and mutual-max + threshold match extraction. Invalid keypoint slots (-1,
score 0) stay in the attention, as in JAX.

``SuperGlueNet`` carries the official submodule names
(``kenc.encoder.*``, ``gnn.layers.N.attn.{proj,merge}``,
``gnn.layers.N.mlp.*``, ``final_proj``, ``bin_score``), so
``superglue_{indoor,outdoor}.pth`` loads by name (``load_superglue``);
``superglue_from_jax_params`` carries the JAX package's params over. The
1x1 ``Conv1d`` weights are applied as float32 matmuls on (N, D) rows, and
batch norm in inference form, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from .. import float32_exact, resolve_device
from ..ops.param_tree import load_named

DIM = 256
NUM_HEADS = 4
KENC_CHANNELS = (3, 32, 64, 128, 256, DIM)
NUM_GNN_LAYERS = 18        # ['self', 'cross'] * 9
BN_EPS = 1e-5


class SuperGlueResult(NamedTuple):
    matches0: torch.Tensor          # (N0,) int64 index into kpts1, -1 = none
    matches1: torch.Tensor          # (N1,)
    matching_scores0: torch.Tensor  # (N0,)
    matching_scores1: torch.Tensor  # (N1,)


def _mlp_seq(channels: Sequence[int], dev) -> nn.Sequential:
    """The official MLP: Conv1d(1x1), BatchNorm1d, ReLU per hidden layer,
    then a plain Conv1d (Sequential indices conv 0, bn 1, relu 2, ...)."""
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], 1,
                                device=dev))
        if i < len(channels) - 1:
            layers.append(nn.BatchNorm1d(channels[i], device=dev))
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class _KeypointEncoder(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.encoder = _mlp_seq(KENC_CHANNELS, dev)


class _MultiHeadedAttention(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.merge = nn.Conv1d(DIM, DIM, 1, device=dev)
        self.proj = nn.ModuleList([nn.Conv1d(DIM, DIM, 1, device=dev)
                                   for _ in range(3)])


class _AttentionalPropagation(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.attn = _MultiHeadedAttention(dev)
        self.mlp = _mlp_seq((2 * DIM, 2 * DIM, DIM), dev)


class _AttentionalGNN(nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.layers = nn.ModuleList([_AttentionalPropagation(dev)
                                     for _ in range(NUM_GNN_LAYERS)])


class SuperGlueNet(nn.Module):
    """The weights of SuperGlue under the official names; the forward is
    ``superglue_match``."""

    def __init__(self, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.kenc = _KeypointEncoder(dev)
        self.gnn = _AttentionalGNN(dev)
        self.final_proj = nn.Conv1d(DIM, DIM, 1, device=dev)
        self.bin_score = nn.Parameter(torch.tensor(1.0, device=dev))
        self.requires_grad_(False)
        self.eval()


# ----------------------------------------------------------- layer math
def _dense(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    return x @ conv.weight[:, :, 0].T + conv.bias


def _bn(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    inv = torch.rsqrt(bn.running_var + BN_EPS)
    return (x - bn.running_mean) * inv * bn.weight + bn.bias


def _mlp(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Rows (N, C_in) through the official MLP, in JAX's operation order."""
    for layer in seq:
        if isinstance(layer, nn.Conv1d):
            x = _dense(layer, x)
        elif isinstance(layer, nn.BatchNorm1d):
            x = _bn(layer, x)
        else:
            x = torch.relu(x)
    return x


def _mha(attn: _MultiHeadedAttention, x, source):
    """4-head attention, queries from x (N, D), keys / values from source.
    The reference views the projection as (head_dim, H): channel
    d_i * H + h."""
    n, d = x.shape
    hd = d // NUM_HEADS
    q = _dense(attn.proj[0], x).reshape(n, hd, NUM_HEADS)
    k = _dense(attn.proj[1], source).reshape(-1, hd, NUM_HEADS)
    v = _dense(attn.proj[2], source).reshape(-1, hd, NUM_HEADS)
    logits = torch.einsum("ndh,mdh->hnm", q, k) / float(np.sqrt(hd))
    prob = torch.softmax(logits, dim=-1)
    msg = torch.einsum("hnm,mdh->ndh", prob, v).reshape(n, d)
    return _dense(attn.merge, msg)


def normalize_keypoints(kpts: torch.Tensor, width: int, height: int):
    """Centre and scale by 0.7 * max(size)."""
    size = torch.tensor([width, height], dtype=torch.float32,
                        device=kpts.device)
    return (kpts - size / 2) / (torch.max(size) * 0.7)


# ------------------------------------------------------------ sinkhorn OT
def log_sinkhorn(Z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                 iters: int) -> torch.Tensor:
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(Z + u[:, None], dim=0)
    return Z + u[:, None] + v[None, :]


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """(M, N) score matrix -> (M+1, N+1) log assignment with dustbins."""
    m, n = scores.shape
    alpha = alpha.to(scores)
    couplings = torch.cat([
        torch.cat([scores, alpha.expand(m, 1)], 1),
        torch.cat([alpha.expand(1, n), alpha.expand(1, 1)], 1)], 0)
    norm = -float(np.log(float(m + n)))
    dev = scores.device
    log_mu = torch.cat([torch.full((m,), norm, device=dev),
                        torch.tensor([float(np.log(n)) + norm], device=dev)])
    log_nu = torch.cat([torch.full((n,), norm, device=dev),
                        torch.tensor([float(np.log(m)) + norm], device=dev)])
    return log_sinkhorn(couplings, log_mu, log_nu, iters) - norm


# --------------------------------------------------------------- forward
@torch.no_grad()
def superglue_match(
    net: SuperGlueNet,
    kpts0: torch.Tensor, scores0: torch.Tensor, desc0: torch.Tensor,
    kpts1: torch.Tensor, scores1: torch.Tensor, desc1: torch.Tensor,
    width0: int, height0: int, width1: int, height1: int,
    sinkhorn_iters: int = 100, match_threshold: float = 0.2,
) -> SuperGlueResult:
    """Match two keypoint sets on the net's device. desc* are (N, 256)
    L2-normalised."""
    with float32_exact():
        enc0 = torch.cat([normalize_keypoints(kpts0, width0, height0),
                          scores0[:, None]], -1)
        enc1 = torch.cat([normalize_keypoints(kpts1, width1, height1),
                          scores1[:, None]], -1)
        d0 = desc0 + _mlp(net.kenc.encoder, enc0)
        d1 = desc1 + _mlp(net.kenc.encoder, enc1)

        for i, lyr in enumerate(net.gnn.layers):
            s0, s1 = (d0, d1) if i % 2 == 0 else (d1, d0)
            m0 = _mha(lyr.attn, d0, s0)
            m1 = _mha(lyr.attn, d1, s1)
            d0 = d0 + _mlp(lyr.mlp, torch.cat([d0, m0], -1))
            d1 = d1 + _mlp(lyr.mlp, torch.cat([d1, m1], -1))

        md0 = _dense(net.final_proj, d0)
        md1 = _dense(net.final_proj, d1)
        scores = (md0 @ md1.T) / float(np.sqrt(DIM))

        Z = log_optimal_transport(scores, net.bin_score, sinkhorn_iters)
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


def matches_as_pairs(res: SuperGlueResult) -> np.ndarray:
    """(M, 2) array of (kp0, kp1) index pairs (host-side)."""
    m0 = res.matches0.detach().cpu().numpy()
    keep = m0 >= 0
    return np.stack([np.nonzero(keep)[0], m0[keep]], 1)


# ------------------------------------------------------------ convert
def superglue_from_jax_params(params: Dict[str, Any],
                              device="cuda") -> SuperGlueNet:
    """The JAX package's params (numpy; dense ``w`` as (in, out), ``bn``
    with gamma / beta / mean / var) -> the net."""
    net = SuperGlueNet(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def dense(conv, p):
        conv.weight.copy_(t(np.asarray(p["w"]).T[:, :, None]))
        conv.bias.copy_(t(p["b"]))

    def mlp(seq, layers):
        convs = [m for m in seq if isinstance(m, nn.Conv1d)]
        bns = [m for m in seq if isinstance(m, nn.BatchNorm1d)]
        for conv, lyr in zip(convs, layers):
            dense(conv, lyr)
        for bn, lyr in zip(bns, layers):
            p = lyr["bn"]
            bn.weight.copy_(t(p["gamma"]))
            bn.bias.copy_(t(p["beta"]))
            bn.running_mean.copy_(t(p["mean"]))
            bn.running_var.copy_(t(p["var"]))

    mlp(net.kenc.encoder, params["kenc"])
    for lyr, p in zip(net.gnn.layers, params["layers"]):
        for conv, key in zip(lyr.attn.proj, ("q", "k", "v")):
            dense(conv, p["attn"][key])
        dense(lyr.attn.merge, p["attn"]["merge"])
        mlp(lyr.mlp, p["mlp"])
    dense(net.final_proj, params["final_proj"])
    net.bin_score.copy_(t(params["bin_score"]))
    return net


def load_superglue(state_dict: Dict[str, Any], device="cuda") -> SuperGlueNet:
    """An official ``superglue_{indoor,outdoor}.pth`` state dict -> the
    net. Every parameter and statistic must be present; the batch norms'
    ``num_batches_tracked`` counters, which inference does not read, may
    be absent."""
    return load_named(SuperGlueNet(device), state_dict, "superglue")
