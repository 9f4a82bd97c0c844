"""Per-tile blend outputs and the tile -> image layout.

The blend itself (front-to-back alpha compositing per 16x16 tile, cut off
once T < 1e-4) lives in ``stream_blend.py``: a hand-written CUDA kernel for
tensors on the card, its plain PyTorch version for tensors on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
