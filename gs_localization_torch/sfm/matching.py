"""Descriptor matching: mutual nearest neighbor with ratio test.

The role of hloc's NN matchers (SuperGlue is the learned alternative). One
(K, D) x (D, K) float32 matrix product per pair, on the device of the
descriptors; PyTorch's default keeps it out of TF32, and the port never
turns TF32 on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Matches(NamedTuple):
    matches0: torch.Tensor   # (K,) index into features1, -1 = unmatched
    scores: torch.Tensor     # (K,) similarity of the accepted match (0 if none)


def match_mutual_nn(
    desc0: torch.Tensor, desc1: torch.Tensor,
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
    ratio_thresh: float = 0.95, min_score: float = 0.0,
) -> Matches:
    """Mutual-NN matching on L2-normalized descriptors (cosine similarity).

    ``ratio_thresh`` is applied on distances (Lowe ratio) via the two best
    similarities: accept iff d1/d2 < ratio where d = sqrt(2 - 2*sim).
    ``argmax`` takes the first maximum, as JAX's does.
    """
    sim = torch.matmul(desc0, desc1.T)
    if valid0 is not None:
        sim = torch.where(valid0[:, None], sim, -torch.inf)
    if valid1 is not None:
        sim = torch.where(valid1[None, :], sim, -torch.inf)

    best01 = torch.argmax(sim, dim=1)
    best10 = torch.argmax(sim, dim=0)
    s_best = torch.amax(sim, dim=1)
    # second best for the ratio test
    k0 = desc0.shape[0]
    rows = torch.arange(k0, device=sim.device)
    sim_wo_best = sim.clone()
    sim_wo_best[rows, best01] = -torch.inf
    s_second = torch.amax(sim_wo_best, dim=1)

    d1 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * s_best, 0.0))
    d2 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * s_second, 1e-12))
    mutual = best10[best01] == rows
    ok = mutual & (d1 / d2 < ratio_thresh) & (s_best > min_score) \
        & torch.isfinite(s_best)
    return Matches(
        matches0=torch.where(ok, best01, -1),
        scores=torch.where(ok, s_best, 0.0),
    )
