"""Tile-sharded rendering: the spatial parallel axis.

One frame's tile grid is split across the ranks of a ``tile`` mesh axis:
preprocess and binning run replicated (every rank computes them), each
rank blends only its run of tiles (``blend.blend_tiles`` with ``pix`` its
slice of the grid: K3/K4 with a first-tile offset on the card), and the
tiles' outputs are all-gathered into the image. Gradients are the global
sums, as JAX's psum in the VJP of the replicated ``shard_map`` inputs gives
them: the blend inputs pass through ``runtime.sum_grads`` (identity
forward, all-reduce of their gradients backward), and the gather's backward
takes the rank's own tiles of the (replicated) loss's cotangent.

Use when a single frame is large (megapixel images, millions of
Gaussians); for many small frames prefer the data-parallel axis (dp.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..raster import RasterizerConfig
from ..raster import binning as binning_lib
from ..raster import blend as blend_lib
from ..raster.preprocess import preprocess
from ..raster.rasterize import RenderOutput, composite
from . import runtime
from .runtime import Mesh


def rasterize_tile_sharded(
    mesh: Mesh,
    gaussians: GaussianParams,
    camera: Camera,
    config: RasterizerConfig = RasterizerConfig(),
    bg: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Single-frame render with tiles sharded over ``mesh`` axis 0; every
    rank returns the whole image. Differentiable w.r.t. Gaussian
    parameters and the camera, with the gradients summed over the ranks."""
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    ts = config.tile_size
    grid_x = -(-camera.width // ts)
    grid_y = -(-camera.height // ts)
    num_tiles = grid_x * grid_y
    if num_tiles % n_dev:
        raise ValueError(
            f"tiles {num_tiles} must divide over {n_dev} ranks: pad the "
            f"image height to a multiple of {ts * n_dev}")
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=camera.device)

    prep = preprocess(gaussians, camera, tile_size=ts,
                      scale_modifier=config.scale_modifier)
    with torch.no_grad():
        bins = binning_lib.bin_gaussians(
            prep, grid_x, grid_y, config.max_pairs, config.max_per_tile,
            tile_size=ts, tile_cull=config.tile_cull)
    per = num_tiles // n_dev
    lo = mesh.index(axis) * per
    pix = blend_lib.tile_pixel_coords(grid_x, grid_y, ts,
                                      camera.device)[lo:lo + per]
    means2d, conic, rgb, opacity, depths = runtime.sum_grads(
        (prep.means2d, prep.conic, prep.rgb, prep.opacity, prep.depths),
        mesh, axis)
    out = blend_lib.blend_tiles(
        bins.tile_gid[lo:lo + per], bins.tile_mask[lo:lo + per], means2d,
        conic, rgb, opacity, depths, grid_x, grid_y, ts, chunk=config.chunk,
        pix=pix, pallas_chunk=config.pallas_chunk)
    local = torch.cat([out.color, out.depth[..., None], out.log_t[..., None]],
                      dim=-1)                            # (per, npix, 5)
    tiles = runtime.gather_rows(local, mesh, axis)       # (T, npix, 5)
    color, depth, alpha = composite(
        blend_lib.TileBlendOut(color=tiles[..., :3], depth=tiles[..., 3],
                               log_t=tiles[..., 4]), camera, ts, bg)
    return RenderOutput(
        color=color, depth=depth, alpha=alpha,
        radii=prep.radii, visibility=prep.radii > 0,
        num_rendered=bins.num_rendered, overflow=bins.overflow,
        tile_overflow=bins.tile_overflow, max_tile_count=bins.max_tile_count)
