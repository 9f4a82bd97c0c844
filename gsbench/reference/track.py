"""Plain pose refinement against a Gaussian map (LoGS's tracking loop).

Per query: the edge mask of the query image (Scharr gradients over the
grey image with reflect padding, 1/32 normalisation, kept where all 3x3
neighbours exceed 0.01 in magnitude; a pixel is an edge when its gradient
magnitude exceeds ``edge_threshold`` times the median), then up to
``num_iters`` Adam steps (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) over
the 6-dim SE(3) tangent and the two exposure terms, the pose retracted as
w2c <- exp(update) w2c after each step, stopping once the tangent update's
norm falls below ``convergence``. The loss is the masked L1 of exp(a) I + b
against the query over pixels whose alpha exceeds the opacity threshold,
plus (RGB-D) (1 - alpha_cfg) times the masked depth L1 where the query
depth exceeds 1 cm. Tile lists, their depth order and the colours are
rebuilt at the current pose every ``rebin_every`` iterations and held in
between (the program's pose mode).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import splat


def edge_mask(rgb: torch.Tensor, threshold: float) -> torch.Tensor:
    gray = rgb.mean(-1)
    pad = F.pad(gray[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    h, w = gray.shape

    def tap(i, j):
        return pad[i:i + h, j:j + w]

    gv = (3 * tap(0, 0) + 10 * tap(0, 1) + 3 * tap(0, 2)
          - 3 * tap(2, 0) - 10 * tap(2, 1) - 3 * tap(2, 2)) / 32
    gh = (3 * tap(0, 0) + 10 * tap(1, 0) + 3 * tap(2, 0)
          - 3 * tap(0, 2) - 10 * tap(1, 2) - 3 * tap(2, 2)) / 32
    big = torch.abs(pad) > 0.01
    ok = torch.ones_like(gray, dtype=torch.bool)
    for i in range(3):
        for j in range(3):
            ok = ok & big[i:i + h, j:j + w]
    mag = torch.sqrt((gv * ok) ** 2 + (gh * ok) ** 2)
    s = torch.sort(mag.reshape(-1)).values
    n = s.numel()
    return mag > 0.5 * (s[(n - 1) // 2] + s[n // 2]) * threshold


class Track(NamedTuple):
    w2c: torch.Tensor
    iters: int
    loss0: torch.Tensor    # the first iteration's loss (at the initial pose)
    grad0: torch.Tensor    # the first iteration's tangent gradient (6,)


def tracking_loss(color, depth, alpha, ab, gt, mask, gt_depth, cfg):
    img = torch.exp(ab[0]) * color + ab[1]
    om = (alpha > cfg["opacity_threshold"]).to(color.dtype)
    gm = mask.to(color.dtype)
    loss = torch.mean(om[..., None] * torch.abs(img * gm[..., None]
                                                - gt * gm[..., None]))
    if gt_depth is not None:
        dm = (gt_depth > 0.01).to(depth.dtype) * om * gm
        loss = loss + (1 - cfg["alpha"]) * torch.mean(
            torch.abs(depth * dm - gt_depth * dm))
    return loss


def refine(m: splat.Map, cam: splat.Cam, gt: torch.Tensor,
           gt_depth: Optional[torch.Tensor], cfg: dict) -> Track:
    """``cfg``: num_iters, lr, convergence, opacity_threshold, alpha,
    rebin_every, edge_threshold. Everything in ``gt.dtype``."""
    dt, dev = gt.dtype, gt.device
    mask = edge_mask(gt, cfg["edge_threshold"])
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, cfg["lr"]
    w2c = cam.w2c.to(dt)
    ab = torch.zeros(2, dtype=dt, device=dev)
    m6, v6 = torch.zeros(6, dtype=dt, device=dev), torch.zeros(6, dtype=dt,
                                                               device=dev)
    m2, v2 = torch.zeros(2, dtype=dt, device=dev), torch.zeros(2, dtype=dt,
                                                               device=dev)
    it, loss0, grad0 = 0, None, None
    while it < cfg["num_iters"]:
        if it % cfg["rebin_every"] == 0:
            with torch.no_grad():
                scr = splat.project(m, cam.at(w2c))
                tiles = splat.bin_tiles(scr, cam)
                rgb = scr.table[:, splat.R:splat.B + 1]
                valid = scr.table[:, splat.VALID] > 0.5
        tau = torch.zeros(6, dtype=dt, device=dev, requires_grad=True)
        ab_v = ab.clone().requires_grad_()
        with torch.enable_grad():
            table = splat.project(m, cam.at(splat.se3_exp(tau) @ w2c),
                                  rgb=rgb, valid_fixed=valid).table
            loss, _ = splat.render_with_grad(
                table, tiles, cam,
                lambda c, d, a: tracking_loss(c, d, a, ab_v, gt, mask,
                                              gt_depth, cfg))
        g_tau, g_ab = tau.grad, ab_v.grad
        if grad0 is None:
            loss0, grad0 = loss, g_tau.detach().clone()
        t = it + 1
        with torch.no_grad():
            m6 = b1 * m6 + (1 - b1) * g_tau
            v6 = b2 * v6 + (1 - b2) * g_tau * g_tau
            upd6 = -lr * (m6 / (1 - b1**t)) / (torch.sqrt(v6 / (1 - b2**t))
                                                + eps)
            m2 = b1 * m2 + (1 - b1) * g_ab
            v2 = b2 * v2 + (1 - b2) * g_ab * g_ab
            upd2 = -lr * (m2 / (1 - b1**t)) / (torch.sqrt(v2 / (1 - b2**t))
                                                + eps)
            w2c = splat.se3_exp(upd6) @ w2c
            ab = ab + upd2
        it += 1
        if cfg["convergence"] > 0 and \
                float(torch.linalg.norm(upd6)) < cfg["convergence"]:
            break
    return Track(w2c, it, loss0, grad0)

