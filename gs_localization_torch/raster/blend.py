"""Per-tile blend outputs, the tile -> image layout and ``count_touched``.

The blend itself (front-to-back alpha compositing per 16x16 tile, cut off
once T < 1e-4) lives in ``stream_blend.py`` and ``pallas_blend.py``:
hand-written CUDA kernels for tensors on the card, their plain PyTorch
versions for tensors on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .constants import ALPHA_MAX, ALPHA_MIN, LOG_T_EPS


class TileBlendOut(NamedTuple):
    color: torch.Tensor     # (num_tiles, ts*ts, 3)
    depth: torch.Tensor     # (num_tiles, ts*ts)
    log_t: torch.Tensor     # (num_tiles, ts*ts) final log transmittance


def tiles_to_image(tiles: torch.Tensor, grid_x: int, grid_y: int,
                   tile_size: int, width: int, height: int) -> torch.Tensor:
    """(num_tiles, ts*ts, C?) -> (H, W, C?) cropping tile padding."""
    chan = tuple(tiles.shape[2:])
    img = tiles.reshape((grid_y, grid_x, tile_size, tile_size) + chan)
    img = torch.movedim(img, 2, 1).reshape(
        (grid_y * tile_size, grid_x * tile_size) + chan)
    return img[:height, :width]


def tile_pixel_coords(grid_x: int, grid_y: int, tile_size: int,
                      device) -> torch.Tensor:
    """(num_tiles, ts*ts, 2) pixel coordinates (x, y) per tile."""
    t = torch.arange(grid_x * grid_y, device=device)
    ii = torch.arange(tile_size * tile_size, device=device)
    x = ((t % grid_x) * tile_size)[:, None] + (ii % tile_size)[None, :]
    y = (torch.div(t, grid_x, rounding_mode="floor") * tile_size)[:, None] \
        + torch.div(ii, tile_size, rounding_mode="floor")[None, :]
    return torch.stack([x, y], dim=-1).to(torch.float32)


def compute_alpha(xy: torch.Tensor, conic: torch.Tensor,
                  opacity: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Reference alpha: min(0.99, opa exp(power)), zero where power > 0 or
    alpha < 1/255 (shapes broadcast)."""
    dx = xy[..., 0] - pix[..., 0]
    dy = xy[..., 1] - pix[..., 1]
    power = (-0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy)
             - conic[..., 1] * dx * dy)
    alpha = torch.clamp_max(opacity * torch.exp(torch.clamp_max(power, 0.0)),
                            ALPHA_MAX)
    return torch.where((power > 0.0) | (alpha < ALPHA_MIN),
                       torch.zeros_like(alpha), alpha)


@torch.no_grad()
def count_touched(
    tile_gid: torch.Tensor,    # (num_tiles, max_per_tile) int32
    tile_mask: torch.Tensor,   # (num_tiles, max_per_tile) bool
    means2d: torch.Tensor,     # (P, 2)
    conic: torch.Tensor,       # (P, 3)
    opacity: torch.Tensor,     # (P,)
    num_gaussians: int,
    grid_x: int,
    grid_y: int,
    tile_size: int,
    chunk: int = 64,
) -> torch.Tensor:
    """Per-Gaussian count of the pixels it contributed to (``n_touched``),
    (num_gaussians,) int32: a pixel counts when the Gaussian passed the
    alpha test and the pixel was not yet saturated (T >= 1e-4). A separate
    pass over the id matrix, chunk by chunk as the JAX ``lax.scan``."""
    num_tiles, max_per_tile = tile_gid.shape
    if max_per_tile % chunk:
        raise ValueError(f"max_per_tile {max_per_tile} is not a multiple "
                         f"of chunk {chunk}")
    dev = means2d.device
    pix = tile_pixel_coords(grid_x, grid_y, tile_size, dev)[:, None]
    log_t_full = torch.zeros((num_tiles, tile_size * tile_size),
                             dtype=torch.float32, device=dev)
    touched = torch.zeros((num_gaussians,), dtype=torch.int32, device=dev)
    for lo in range(0, max_per_tile, chunk):
        gid = tile_gid[:, lo:lo + chunk].long()
        mask = tile_mask[:, lo:lo + chunk]
        opa = torch.where(mask, opacity[gid], torch.zeros_like(opacity[gid]))
        alpha = compute_alpha(means2d[gid][:, :, None, :],
                              conic[gid][:, :, None, :], opa[:, :, None], pix)
        la = torch.log1p(-alpha)                          # (T, G, npix)
        clog = log_t_full[:, None, :] + torch.cumsum(la, dim=1)
        hit = (alpha > 0.0) & (clog >= LOG_T_EPS)
        counts = hit.sum(dim=-1, dtype=torch.int32)        # (T, G)
        touched.index_add_(0, gid.reshape(-1),
                           torch.where(mask, counts,
                                       torch.zeros_like(counts)).reshape(-1))
        log_t_full = log_t_full + la.sum(dim=1)
    return touched
