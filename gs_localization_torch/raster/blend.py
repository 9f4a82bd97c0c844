"""Per-tile blend outputs, the tile -> image layout, the id-matrix blend
``blend_tiles`` and ``count_touched``.

The blend (front-to-back alpha compositing per 16x16 tile, cut off once
T < 1e-4) runs in hand-written CUDA kernels for tensors on the card
(``stream_blend.py`` K1/K2, ``pallas_blend.py`` K3/K4) and in plain
PyTorch on the CPU. ``blend_tiles`` is the JAX package's id-matrix blend:
on the CPU a twin of its chunked ``lax.scan``, differentiated by autograd;
on the card the pregathered kernels K3/K4 over the same windows.
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


def _prefix_counts(tile_mask: torch.Tensor) -> torch.Tensor:
    """(T,) int32 counts of a mask whose rows are prefixes (what
    ``bin_gaussians`` builds: lanes below the tile's count); raises for any
    other mask, which the kernels' ``lane < count`` rule cannot express."""
    counts = tile_mask.sum(dim=1, dtype=torch.int32)
    lanes = torch.arange(tile_mask.shape[1], device=tile_mask.device)
    if not torch.equal(tile_mask, lanes[None, :] < counts[:, None]):
        raise ValueError("tile_mask: every row must be a prefix (lanes "
                         "below the tile's count), as bin_gaussians builds it")
    return counts


def _tile_run(pix: torch.Tensor, grid_x: int, grid_y: int,
              tile_size: int) -> int:
    """The first tile of ``pix`` when it is the pixel coordinates of a run
    of consecutive tiles of the grid (``tile_pixel_coords`` rows tile0 ..
    tile0 + T - 1, the tile-sharded path's slice); raises otherwise."""
    num_tiles = pix.shape[0]
    full = tile_pixel_coords(grid_x, grid_y, tile_size, pix.device)
    if pix.dim() != 3 or tuple(pix.shape[1:]) != tuple(full.shape[1:]) \
            or num_tiles > full.shape[0]:
        raise ValueError(f"pix: shape {tuple(pix.shape)}, expected (T, "
                         f"{tile_size * tile_size}, 2) rows of the "
                         f"{grid_x}x{grid_y} tile grid")
    if num_tiles == 0:
        return 0
    x0, y0 = (int(v) for v in pix[0, 0].tolist())
    tile0 = (y0 // tile_size) * grid_x + x0 // tile_size
    if tile0 + num_tiles > full.shape[0] or not torch.equal(
            pix.to(torch.float32), full[tile0:tile0 + num_tiles]):
        raise ValueError("pix: not the pixel coordinates of a run of "
                         "consecutive tiles of the grid")
    return tile0


def _blend_tiles_plain(tile_gid, tile_mask, means2d, conic, rgb, opacity,
                       depths, pix, chunk: int) -> TileBlendOut:
    """The JAX ``blend_tiles`` scan, chunk by chunk: two log T carries,
    ``log_t_full`` over every alpha (the saturation test) and ``log_t``
    over the applied ones (the output transmittance)."""
    num_tiles, max_per_tile = tile_gid.shape
    npix = pix.shape[1]
    out = dict(dtype=torch.float32, device=means2d.device)
    log_t_full = torch.zeros((num_tiles, npix), **out)
    log_t = torch.zeros((num_tiles, npix), **out)
    color = torch.zeros((num_tiles, npix, 3), **out)
    depth = torch.zeros((num_tiles, npix), **out)
    for lo in range(0, max_per_tile, chunk):
        gid = tile_gid[:, lo:lo + chunk].long()          # (T, G)
        mask = tile_mask[:, lo:lo + chunk]
        opa = torch.where(mask, opacity[gid], torch.zeros_like(opacity[gid]))
        alpha = compute_alpha(means2d[gid][:, :, None, :],
                              conic[gid][:, :, None, :], opa[:, :, None],
                              pix[:, None, :, :])         # (T, G, npix)
        la = torch.log1p(-alpha)
        clog = log_t_full[:, None, :] + torch.cumsum(la, dim=1)
        applied = clog >= LOG_T_EPS
        w = torch.where(applied, alpha * torch.exp(clog - la),
                        torch.zeros_like(alpha))
        color = color + torch.einsum("tgp,tgc->tpc", w, rgb[gid])
        depth = depth + torch.sum(w * depths[gid][:, :, None], dim=1)
        log_t_full = log_t_full + la.sum(dim=1)
        log_t = log_t + torch.where(applied, la, torch.zeros_like(la)).sum(
            dim=1)
    return TileBlendOut(color=color, depth=depth, log_t=log_t)


def blend_tiles(
    tile_gid: torch.Tensor,    # (num_tiles, max_per_tile) int32
    tile_mask: torch.Tensor,   # (num_tiles, max_per_tile) bool
    means2d: torch.Tensor,     # (P, 2)
    conic: torch.Tensor,       # (P, 3)
    rgb: torch.Tensor,         # (P, 3)
    opacity: torch.Tensor,     # (P,)
    depths: torch.Tensor,      # (P,)
    grid_x: int,
    grid_y: int,
    tile_size: int,
    chunk: int = 64,
    pix: torch.Tensor = None,
    *,
    pallas_chunk: int = 256,
) -> TileBlendOut:
    """Blend each tile's Gaussians, listed front to back in ``tile_gid``
    under a prefix ``tile_mask``; differentiable in means2d, conic, rgb,
    opacity and depths. ``pix`` overrides the per-tile pixel coordinates:
    it must be rows tile0 .. tile0 + T - 1 of ``tile_pixel_coords`` (the
    tile-sharded path's slice of the global grid), and raises otherwise.

    CPU tensors run the JAX scan in ``chunk``-lane steps. CUDA tensors
    gather the windows (``pallas_blend.gather_windows``) and launch K3/K4
    at ``pallas_chunk`` (at most the window width) with the run's first
    tile; the kernels stop a tile once every pixel is saturated, which the
    scan does not, and agree with it up to the "flipped" pixels (a pair
    within rounding of log(1e-4) is applied under one summation order
    only)."""
    num_tiles, max_per_tile = tile_gid.shape
    if max_per_tile % chunk:
        raise ValueError(f"max_per_tile {max_per_tile} is not a multiple of "
                         f"chunk {chunk}")
    counts = _prefix_counts(tile_mask)
    tile0 = 0 if pix is None else _tile_run(pix, grid_x, grid_y, tile_size)
    if means2d.is_cuda:
        from .pallas_blend import blend_pregathered_pallas, gather_windows

        geom, rgbd = gather_windows(tile_gid, means2d, conic, rgb, opacity,
                                    depths)
        return blend_pregathered_pallas(counts, geom, rgbd, grid_x,
                                        tile_size, pallas_chunk, tile0=tile0)
    if means2d.device.type != "cpu":
        raise ValueError(f"unsupported device {means2d.device}")
    if pix is None:
        pix = tile_pixel_coords(grid_x, grid_y, tile_size, means2d.device)
    return _blend_tiles_plain(tile_gid, tile_mask, means2d, conic, rgb,
                              opacity, depths, pix, chunk)


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
