"""Plain adaptive density control (3DGS's densify-and-prune round).

A live Gaussian whose mean screen-space gradient (accumulated norm over
visits) reaches ``grad_threshold`` is cloned when its largest scale is at
most ``percent_dense * extent`` and split into ``split_n`` Gaussians of
scale / (0.8 split_n) otherwise (the original removed); a live Gaussian
below ``min_opacity`` is pruned (and, with ``max_screen_size``, one whose
screen radius or world size is too large). Copies keep the source's other
parameters. Computed in the dtype of the given tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class Round(NamedTuple):
    cloned: int
    split: int
    pruned: int
    opacity: torch.Tensor    # sorted logit opacities of the live set after
    scaling: torch.Tensor    # sorted log scales of the live set after


def densify_round(scaling, opacity_logit, live, grad_accum, denom, max_radii,
                  grad_threshold: float, min_opacity: float, extent: float,
                  max_screen_size: Optional[float], percent_dense: float,
                  split_n: int = 2) -> Round:
    grads = torch.where(denom > 0, grad_accum / torch.clamp_min(denom, 1),
                        torch.zeros_like(grad_accum))
    std = torch.exp(scaling)
    big = torch.amax(std, 1)
    hot = live & (grads >= grad_threshold)
    clone = hot & (big <= percent_dense * extent)
    split = hot & (big > percent_dense * extent)
    opa = torch.sigmoid(opacity_logit.reshape(-1))
    prune = live & (opa < min_opacity)
    if max_screen_size is not None:
        prune = prune | (live & (max_radii > max_screen_size)) \
            | (live & (big > 0.1 * extent))
    keep = live & ~(prune | split)
    child = torch.log(torch.clamp_min(std[split] / (0.8 * split_n), 1e-10))
    ol = opacity_logit.reshape(-1)
    opacity = torch.cat([ol[keep], ol[clone]] + [ol[split]] * split_n)
    scales = torch.cat([scaling[keep], scaling[clone]] + [child] * split_n)
    return Round(int(clone.sum()), int(split.sum()), int(prune.sum()),
                 torch.sort(opacity).values,
                 torch.sort(scales.reshape(-1)).values)


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference of two sorted value lists (inf if their lengths
    differ)."""
    if a.numel() != b.numel():
        return math.inf
    if a.numel() == 0:
        return 0.0
    return float(torch.max(torch.abs(a.double() - b.double())))
