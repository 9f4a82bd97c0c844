"""Plain front-to-back blending that stops where the pixels saturate, and
the tracking loop over it, for maps of millions of Gaussians.

``splat.blend`` evaluates every lane of every tile list. At scene scale a
tile lists about 2,000 (Gaussian, tile) pairs and its pixels saturate
(transmittance below 1e-4) within the first few hundred, so most of that
work composes nothing. Here each block of tiles is walked in steps of
``STEP`` lanes, the running log transmittance of every pixel carried from
one step to the next, and the walk stops once every pixel of the block has
saturated. The lanes left unwalked add nothing in ``splat``'s sums either:
a lane past a pixel's saturation is neither evaluated nor applied there,
its weight is zero and its log term is not in the final transmittance. So
the colour, depth and alpha, their gradients and the evaluated and applied
counts are ``splat``'s, up to the association of the running sum of log
terms (one sum per step, continued from the carry).

``refine`` is ``track.refine`` with this blend in place of ``splat``'s.
Nothing here imports the program.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import splat, track
from .splat import B, CA, CB, CC, OPA, PX, PY, R, TILE, VALID, Z

STEP = 128                       # lanes a step walks


def _blocks(tiles: splat.Tiles):
    """Blocks of whole tiles, longest lists first, each as many tiles as
    keep one step's (tiles, lanes, pixels) within ``splat.BLOCK_ELEMS``."""
    counts = tiles.start[1:] - tiles.start[:-1]
    order = torch.argsort(counts, descending=True, stable=True)
    cnt = counts[order].tolist()
    per = max(1, splat.BLOCK_ELEMS // (STEP * TILE * TILE))
    out, lo = [], 0
    while lo < len(cnt) and cnt[lo] > 0:
        hi = lo
        while hi < len(cnt) and hi - lo < per and cnt[hi] > 0:
            hi += 1
        out.append((order[lo:hi], cnt[lo]))
        lo = hi
    return out


def _walk_block(table, tiles: splat.Tiles, sel, lanes: int, gx: int):
    """``splat._blend_block`` walked ``STEP`` lanes at a time until every
    pixel of the block has saturated."""
    dev, dt = table.device, table.dtype
    cnt = tiles.start[sel + 1] - tiles.start[sel]
    pix = torch.arange(TILE * TILE, device=dev)
    x = (((sel % gx) * TILE)[:, None] + (pix % TILE)[None, :]).to(dt)
    y = (((sel // gx) * TILE)[:, None] + (pix // TILE)[None, :]).to(dt)
    n = sel.numel()
    carry = torch.zeros((n, TILE * TILE), dtype=dt, device=dev)
    color = torch.zeros((n, TILE * TILE, 3), dtype=dt, device=dev)
    depth = torch.zeros((n, TILE * TILE), dtype=dt, device=dev)
    logt = torch.zeros((n, TILE * TILE), dtype=dt, device=dev)
    n_eval = n_app = 0
    for lo in range(0, lanes, STEP):
        lane = torch.arange(lo, min(lo + STEP, lanes), device=dev)
        live = lane[None, :] < cnt[:, None]
        idx = torch.clamp(tiles.start[sel][:, None] + lane[None, :], 0,
                          max(tiles.gauss.numel() - 1, 0))
        f = table[tiles.gauss[idx]]                   # (T, S, 11)
        dx = f[:, :, PX, None] - x[:, None, :]
        dy = f[:, :, PY, None] - y[:, None, :]
        power = (-0.5 * (f[:, :, CA, None] * dx * dx
                         + f[:, :, CC, None] * dy * dy)
                 - f[:, :, CB, None] * dx * dy)
        alpha = torch.clamp_max(f[:, :, OPA, None] * torch.exp(
            torch.clamp_max(power, 0.0)), splat.ALPHA_MAX)
        on = ((power <= 0) & (alpha >= splat.ALPHA_MIN)
              & (f[:, :, VALID, None] > 0.5) & live[:, :, None])
        alpha = torch.where(on, alpha, torch.zeros_like(alpha))
        la = torch.log1p(-alpha)
        clog = carry[:, None, :] + torch.cumsum(la, 1)
        with torch.no_grad():
            applied = on & (clog >= splat.LOG_T_EPS)
            evaluated = live[:, :, None] & (clog - la >= splat.LOG_T_EPS)
        w = torch.where(applied, alpha * torch.exp(clog - la),
                        torch.zeros_like(alpha))
        color = color + torch.einsum("tlp,tlc->tpc", w, f[:, :, R:B + 1])
        depth = depth + torch.einsum("tlp,tl->tp", w, f[:, :, Z])
        logt = logt + torch.sum(torch.where(applied, la,
                                            torch.zeros_like(la)), 1)
        n_eval += int(evaluated.sum())
        n_app += int(applied.sum())
        carry = clog[:, -1, :]
        if not bool((carry >= splat.LOG_T_EPS).any()):
            break
    return color, depth, logt, n_eval, n_app


def blend(table: torch.Tensor, tiles: splat.Tiles, cam: splat.Cam
          ) -> splat.Blend:
    """``splat.blend``, walked until saturation (no autograd graph)."""
    gx, gy = cam.grid
    nt = tiles.num_tiles
    dev, dt = table.device, table.dtype
    color = torch.zeros((nt, TILE * TILE, 3), dtype=dt, device=dev)
    depth = torch.zeros((nt, TILE * TILE), dtype=dt, device=dev)
    logt = torch.zeros((nt, TILE * TILE), dtype=dt, device=dev)
    n_eval = n_app = 0
    with torch.no_grad():
        for sel, lanes in _blocks(tiles):
            c, d, lt, e, a = _walk_block(table, tiles, sel, lanes, gx)
            color[sel], depth[sel], logt[sel] = c, d, lt
            n_eval += e
            n_app += a

    def image(v):
        return splat._to_image(v, gx, gy, cam.width, cam.height)

    return splat.Blend(image(color), image(depth), image(1 - torch.exp(logt)),
                       n_eval, n_app)


def blend_vjp(table: torch.Tensor, tiles: splat.Tiles, cam: splat.Cam,
              g_color, g_depth, g_alpha) -> torch.Tensor:
    """``splat.blend_vjp``, each block walked until saturation."""
    gx, gy = cam.grid
    leaf = table.detach().requires_grad_()
    pad_h, pad_w = gy * TILE - cam.height, gx * TILE - cam.width

    def tiled(img):
        img = torch.nn.functional.pad(
            img.movedim(-1, 0) if img.dim() == 3 else img[None],
            (0, pad_w, 0, pad_h))
        img = img.reshape(-1, gy, TILE, gx, TILE).permute(1, 3, 2, 4, 0)
        return img.reshape(gy * gx, TILE * TILE, -1)

    gc, gd, ga = tiled(g_color), tiled(g_depth)[..., 0], tiled(g_alpha)[..., 0]
    grad = torch.zeros_like(table)
    for sel, lanes in _blocks(tiles):
        with torch.enable_grad():
            c, d, lt, _, _ = _walk_block(leaf, tiles, sel, lanes, gx)
            s = (torch.sum(c * gc[sel]) + torch.sum(d * gd[sel])
                 - torch.sum(torch.exp(lt) * ga[sel]))
            (gb,) = torch.autograd.grad(s, leaf)
        grad += gb
    return grad


def render_with_grad(table: torch.Tensor, tiles: splat.Tiles,
                     cam: splat.Cam, loss_fn):
    """``splat.render_with_grad`` over this walk."""
    out = blend(table.detach(), tiles, cam)
    imgs = [t.detach().requires_grad_() for t in out[:3]]
    with torch.enable_grad():
        loss = loss_fn(*imgs)
        loss.backward()
    gimg = [torch.zeros_like(i) if i.grad is None else i.grad for i in imgs]
    gtab = blend_vjp(table, tiles, cam, *gimg)
    if table.requires_grad:
        table.backward(gtab)
    return loss.detach(), out


def refine(m: splat.Map, cam: splat.Cam, gt: torch.Tensor,
           gt_depth: Optional[torch.Tensor], cfg: dict) -> track.Track:
    """``track.refine`` (the same Adam steps, retraction, rebins and
    convergence test) rendering through this walk."""
    dt, dev = gt.dtype, gt.device
    mask = track.edge_mask(gt, cfg["edge_threshold"])
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, cfg["lr"]
    w2c = cam.w2c.to(dt)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=dev)

    ab, m6, v6, m2, v2 = zeros(2), zeros(6), zeros(6), zeros(2), zeros(2)
    it, loss0, grad0 = 0, None, None
    while it < cfg["num_iters"]:
        if it % cfg["rebin_every"] == 0:
            with torch.no_grad():
                scr = splat.project(m, cam.at(w2c))
                tiles = splat.bin_tiles(scr, cam)
                rgb = scr.table[:, R:B + 1]
                valid = scr.table[:, VALID] > 0.5
        tau = torch.zeros(6, dtype=dt, device=dev, requires_grad=True)
        ab_v = ab.clone().requires_grad_()
        with torch.enable_grad():
            table = splat.project(m, cam.at(splat.se3_exp(tau) @ w2c),
                                  rgb=rgb, valid_fixed=valid).table
            loss, _ = render_with_grad(
                table, tiles, cam,
                lambda c, d, a: track.tracking_loss(c, d, a, ab_v, gt, mask,
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
    return track.Track(w2c, it, loss0, grad0)
