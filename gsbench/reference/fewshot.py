"""The plain few-shot pseudo step: one training view and one pseudo view.

LoGS's few-shot training (``gs/7scenes_gs_full_dslam.py:187-206``, after
FSGS) adds to a step's loss, every ``sample_pseudo_interval`` steps, the
depth of a pseudo camera held to a monocular prior of that camera's own
render:

    loss = (1 - l_ssim) L1 + l_ssim (1 - SSIM) + l_depth |D m - D_gt m|
         + l_pseudo * min(1 - r(-P, D'), 1 - r(1 / (P + 200), D'))

with ``r`` Pearson's correlation over the pixels, ``P`` the prior (inverse
depth, MiDaS's convention), ``D'`` the pseudo view's rendered depth and
``l_pseudo`` 0.005. Both views are rendered by ``splat`` from the same
parameters (no background), and the gradient of the sum reaches every
parameter group through both. The main view's terms are
``reference/train.py``'s.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from . import splat
from . import train as rtrain


def pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x, y = x.reshape(-1), y.reshape(-1)
    xm, ym = x - x.mean(), y - y.mean()
    return (xm * ym).sum() / torch.sqrt((xm * xm).sum() * (ym * ym).sum())


def pseudo_depth_loss(prior: torch.Tensor, depth: torch.Tensor
                      ) -> torch.Tensor:
    return torch.minimum(1 - pearson(-prior, depth),
                         1 - pearson(1 / (prior + 200), depth))


class PseudoStep(NamedTuple):
    loss: float                        # the main view's loss
    pseudo: float                      # the pseudo view's min-Pearson term
    grads: Dict[str, torch.Tensor]     # of the whole loss, per group


def pseudo_step(params: Dict[str, torch.Tensor], view: tuple,
                pseudo_cam: splat.Cam, prior: torch.Tensor, sh_degree: int,
                cfg: dict) -> PseudoStep:
    """The loss, the pseudo term and the gradient of one step from
    ``params`` (``train.GROUPS``) on ``view`` ``(cam, gt, gt_depth)`` with
    ``pseudo_cam``'s depth held to ``prior``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    m = splat.Map(leaves["xyz"], leaves["scaling"], leaves["rotation"],
                  leaves["opacity"][:, 0],
                  torch.cat([leaves["features_dc"],
                             leaves["features_rest"]], 1), sh_degree)
    cam, gt, gt_depth = view
    term = []

    def pseudo_loss(color, depth, alpha):
        term.append(pseudo_depth_loss(prior, depth))
        return cfg["lambda_pseudo_view"] * term[0]

    with torch.enable_grad():
        scr = splat.project(m, cam)
        loss, _ = splat.render_with_grad(
            scr.table, splat.bin_tiles(scr, cam), cam,
            lambda c, d, a: rtrain.training_loss(c, d, gt, gt_depth, cfg))
        scr = splat.project(m, pseudo_cam)
        splat.render_with_grad(scr.table, splat.bin_tiles(scr, pseudo_cam),
                               pseudo_cam, pseudo_loss)
    grads = {k: torch.zeros_like(v) if v.grad is None else v.grad
             for k, v in leaves.items()}
    return PseudoStep(float(loss), float(term[0].detach()), grads)
