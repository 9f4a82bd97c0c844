"""Exact k-nearest-neighbour mean squared distance (brute force, chunked).

Initializes Gaussian scales (``GaussianParams.from_pcd``). Same semantics
as the JAX package's ``mean_knn_sq_dist``: squared distances as
``|q|^2 + |p|^2 - 2 q.p`` clamped at 0, self excluded, and the point set
padded to a multiple of ``chunk`` with points at 1e8 that take part as
candidates (so a cloud of k points or fewer still gets finite values). Each
block of queries is held against every candidate at once, with the block
sized so that the (queries, candidates) matrix stays near 2^25 elements.
"""

from __future__ import annotations

import torch

_BLOCK_ELEMS = 1 << 25


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3,
                     chunk: int = 2048) -> torch.Tensor:
    """(P, 3) float32 -> (P,) mean of the k smallest squared distances to
    other points (self excluded)."""
    p = points.shape[0]
    pad = (-p) % chunk
    pts = torch.cat([points.to(torch.float32),
                     points.new_full((pad, 3), 1e8, dtype=torch.float32)])
    n = pts.shape[0]
    sq = torch.sum(pts * pts, dim=-1)
    idx = torch.arange(n, device=pts.device)
    out = torch.empty(p, dtype=torch.float32, device=pts.device)
    step = max(1, _BLOCK_ELEMS // max(n, 1))
    for lo in range(0, p, step):
        hi = min(p, lo + step)
        d2 = sq[lo:hi, None] + sq[None, :] - 2.0 * (pts[lo:hi] @ pts.T)
        d2 = torch.clamp_min(d2, 0.0)
        d2 = torch.where(idx[lo:hi, None] == idx[None, :],
                         torch.full_like(d2, float("inf")), d2)
        if n < k:
            d2 = torch.cat([d2, d2.new_full((hi - lo, k - n), float("inf"))],
                           dim=1)
        best = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
        out[lo:hi] = torch.mean(best, dim=1)
    return out
