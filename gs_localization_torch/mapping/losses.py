"""Map-training losses.

  loss = (1 - lambda_dssim) * L1(rgb) + lambda_dssim * (1 - SSIM)
       + 0.01  * min-Pearson(pseudo depth)        [if pseudo depth given]
       + 0.05  * masked L1(gt depth)              [if gt depth given]

Images are (H, W, 3); depths (H, W).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.ssim import ssim


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))


def pearson_corrcoef(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = x.reshape(-1)
    y = y.reshape(-1)
    xm = x - torch.mean(x)
    ym = y - torch.mean(y)
    denom = torch.sqrt(torch.sum(xm * xm) * torch.sum(ym * ym))
    return torch.sum(xm * ym) / torch.clamp_min(denom, 1e-12)


def pearson_depth_loss(pseudo_depth: torch.Tensor,
                       depth: torch.Tensor) -> torch.Tensor:
    """min over the two monotone alignments of a MiDaS-style inverse depth."""
    a = 1.0 - pearson_corrcoef(-pseudo_depth, depth)
    b = 1.0 - pearson_corrcoef(1000.0 / (pseudo_depth + 200.0), depth)
    return torch.minimum(a, b)


def training_loss(
    image: torch.Tensor,
    gt_image: torch.Tensor,
    depth: Optional[torch.Tensor] = None,
    gt_depth: Optional[torch.Tensor] = None,
    pseudo_depth: Optional[torch.Tensor] = None,
    lambda_dssim: float = 0.2,
    lambda_pseudo_depth: float = 0.01,
    lambda_gt_depth: float = 0.05,
) -> tuple[torch.Tensor, dict]:
    ll1 = l1_loss(image, gt_image)
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (
        1.0 - ssim(image, gt_image))
    aux = {"l1": ll1}
    if pseudo_depth is not None and depth is not None:
        pd = pearson_depth_loss(pseudo_depth, depth)
        loss = loss + lambda_pseudo_depth * pd
        aux["pearson"] = pd
    if gt_depth is not None and depth is not None:
        mask = (gt_depth > 0.0).to(depth.dtype)
        dl1 = torch.mean(torch.abs(depth * mask - gt_depth * mask))
        loss = loss + lambda_gt_depth * dl1
        aux["depth_l1"] = dl1
    aux["total"] = loss
    return loss, aux
