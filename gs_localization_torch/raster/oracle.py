"""Dense sequential oracle renderer.

Composites every valid Gaussian at every pixel with the sequential
front-to-back recurrence of one reference CUDA thread: a loop over
depth-sorted Gaussians, vectorized over pixels, with a per-pixel carried
transmittance T, a sticky ``done`` flag and the same skip rules.

O(P * pixels) and slow on purpose: an independent oracle for the tiled
rasterizer (another algorithm, the same semantics), differentiable by
autograd through the loop. ``respect_tile_rect=True`` applies the tiled
path's tile-rect coverage cull; ``False`` gives the ideal dense render.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from .constants import ALPHA_MAX, ALPHA_MIN
from .preprocess import preprocess


class OracleOutput(NamedTuple):
    color: torch.Tensor    # (H, W, 3)
    depth: torch.Tensor    # (H, W)
    alpha: torch.Tensor    # (H, W)


def render_oracle(
    gaussians: GaussianParams,
    camera: Camera,
    bg: Optional[torch.Tensor] = None,
    tile_size: int = 16,
    respect_tile_rect: bool = True,
) -> OracleOutput:
    dev = camera.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    w, h = camera.width, camera.height
    prep = preprocess(gaussians, camera, tile_size=tile_size)

    inf = torch.full_like(prep.depths, float("inf"))
    order = torch.argsort(torch.where(prep.valid, prep.depths, inf),
                          stable=True)
    xy = prep.means2d[order]
    con = prep.conic[order]
    opa = torch.where(prep.valid[order], prep.opacity[order],
                      torch.zeros_like(prep.opacity))
    col = prep.rgb[order]
    dep = prep.depths[order]
    rect = prep.rect[order]

    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        .repeat(h, 1).reshape(-1)
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        .repeat(1, w).reshape(-1)
    tile_x = (px / tile_size).to(torch.int32)
    tile_y = (py / tile_size).to(torch.int32)

    npix = h * w
    t = torch.ones((npix,), dtype=torch.float32, device=dev)
    c = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    d = torch.zeros((npix,), dtype=torch.float32, device=dev)
    done = torch.zeros((npix,), dtype=torch.bool, device=dev)
    for i in range(xy.shape[0]):
        dx = xy[i, 0] - px
        dy = xy[i, 1] - py
        power = (-0.5 * (con[i, 0] * dx * dx + con[i, 2] * dy * dy)
                 - con[i, 1] * dx * dy)
        alpha = torch.clamp_max(
            opa[i] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
        skip = (power > 0.0) | (alpha < ALPHA_MIN)
        if respect_tile_rect:
            covered = ((tile_x >= rect[i, 0]) & (tile_x < rect[i, 2])
                       & (tile_y >= rect[i, 1]) & (tile_y < rect[i, 3]))
            skip = skip | ~covered
        test_t = t * (1.0 - alpha)
        saturate = (test_t < 1e-4) & ~skip
        apply = ~skip & ~done & ~saturate
        weight = torch.where(apply, alpha * t, torch.zeros_like(alpha))
        c = c + weight[:, None] * col[i][None, :]
        d = d + weight * dep[i]
        t = torch.where(apply, test_t, t)
        done = done | saturate
    color = (c + t[:, None] * bg[None, :]).reshape(h, w, 3)
    return OracleOutput(color=color, depth=d.reshape(h, w),
                        alpha=(1.0 - t).reshape(h, w))
