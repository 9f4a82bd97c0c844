"""Gaussian-axis sharded rendering and training.

The map's P Gaussians (parameters and, in the caller, optimizer state) are
sharded across the ranks of a ``gauss`` mesh axis, so scene capacity scales
with the number of devices. Owner-computes with one compact gather:

- **preprocess is local** to each rank: projection, EWA covariance,
  culling and SH colour on its own P / n Gaussians;
- **one all-gather of the compact screen-space splats** (the float fields
  depths, means2d, conic, rgb, opacity and the integer fields radii, rect,
  tiles_touched, valid, carried bit for bit as float32 in one tensor);
  binning and blending then run on the gathered set on every rank;
- **the backward needs no collective on the gauss axis**: the gather's
  backward takes this rank's rows of the (replicated) loss's cotangent
  and pushes them through its local preprocess (``runtime.gather_rows``).

With a ``data`` axis, a 2-D (``data``, ``gauss``) mesh shards cameras along
one axis and the map along the other; the gradients are averaged over
``data`` only.

The functions take this rank's block of the map (``shard_rows``) and of
the cameras: PyTorch has no global array.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.camera import Camera
from ..core.gaussians import FIELDS, GaussianParams
from ..mapping import losses
from ..mapping.train import TRAINABLE
from ..raster import RasterizerConfig
from ..raster import binning as binning_lib
from ..raster import blend as blend_lib
from ..raster.preprocess import Preprocessed, preprocess
from ..raster.rasterize import composite
from . import runtime
from .runtime import Mesh

# Preprocessed splits into differentiable float fields (what the blend's
# gradient flows through) and integer/bool side outputs (culling and
# binning metadata, no cotangent), with their widths.
_FLOATS = (("depths", 1), ("means2d", 2), ("conic", 3), ("rgb", 3),
           ("opacity", 1))
_INTS = (("radii", 1), ("rect", 4), ("tiles_touched", 1), ("valid", 1))


def shard_rows(gaussians: GaussianParams, mesh: Mesh,
               axis: str = "gauss") -> GaussianParams:
    """This rank's block of a whole map: rows [i * P / n, (i + 1) * P / n)
    for coordinate i of ``n`` ranks along ``axis``; P must divide."""
    n = mesh.shape[axis]
    cap = gaussians.capacity
    if cap % n:
        raise ValueError(f"capacity {cap} does not divide over {n} ranks")
    lo = mesh.index(axis) * (cap // n)
    return gaussians.replace(**{f: getattr(gaussians, f)[lo:lo + cap // n]
                                for f in FIELDS})


def _gather_prep(prep: Preprocessed, mesh: Mesh, axis: str) -> Preprocessed:
    """Every rank's splats in rank order, through one all-gather of a
    (P / n, 17) float32 tensor: the float fields, then the integer fields'
    bits. Differentiable in the float fields (``runtime.gather_rows``)."""
    p = prep.depths.shape[0]
    floats = [getattr(prep, f).reshape(p, w) for f, w in _FLOATS]
    ints = [getattr(prep, f).to(torch.int32).reshape(p, w) for f, w in _INTS]
    local = torch.cat(floats + [torch.cat(ints, 1).view(torch.float32)], 1)
    full = runtime.gather_rows(local, mesh, axis)
    out, at = {}, 0
    for f, w in _FLOATS:
        out[f] = full[:, at:at + w].reshape((-1,) + getattr(prep, f).shape[1:])
        at += w
    bits = full[:, at:].detach().contiguous().view(torch.int32)
    at = 0
    for f, w in _INTS:
        v = bits[:, at:at + w].reshape((-1,) + getattr(prep, f).shape[1:])
        out[f] = v.to(getattr(prep, f).dtype)
        at += w
    return Preprocessed(**out)


def _blend_full(prep_full: Preprocessed, camera: Camera,
                config: RasterizerConfig, bg: torch.Tensor):
    """Bin and blend a whole gathered splat set -> (color, depth, alpha)
    images and the binning; the same on every rank of the gauss axis."""
    ts = config.tile_size
    grid_x = -(-camera.width // ts)
    grid_y = -(-camera.height // ts)
    with torch.no_grad():
        bins = binning_lib.bin_gaussians(
            prep_full, grid_x, grid_y, config.max_pairs, config.max_per_tile,
            fast_k=config.fast_k, tile_size=ts, tile_cull=config.tile_cull)
    out = blend_lib.blend_tiles(
        bins.tile_gid, bins.tile_mask, prep_full.means2d, prep_full.conic,
        prep_full.rgb, prep_full.opacity, prep_full.depths, grid_x, grid_y,
        ts, chunk=config.chunk, pallas_chunk=config.pallas_chunk)
    color, depth, alpha = composite(out, camera, ts, bg)
    return color, depth, alpha, bins


def rasterize_gauss_sharded(
    mesh: Mesh,
    gaussians: GaussianParams,     # this rank's block of the map
    camera: Camera,
    config: RasterizerConfig = RasterizerConfig(),
    bg: Optional[torch.Tensor] = None,
    axis: Optional[str] = None,
):
    """Render with the Gaussian axis sharded over ``mesh``: every rank
    returns the whole ``(color, depth, alpha)`` images and the radii of its
    own block."""
    axis = axis or mesh.axis_names[0]
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=camera.device)
    prep = preprocess(gaussians, camera, tile_size=config.tile_size,
                      scale_modifier=config.scale_modifier)
    prep_full = _gather_prep(prep, mesh, axis)
    color, depth, alpha, _ = _blend_full(prep_full, camera, config, bg)
    return color, depth, alpha, prep.radii


def gauss_sharded_loss_and_grads(
    mesh: Mesh,
    gaussians: GaussianParams,     # this rank's block of the map
    cameras: Sequence[Camera],     # this rank's block along 'data'
    gt_images: torch.Tensor,       # (k, H, W, 3)
    config: RasterizerConfig = RasterizerConfig(),
    lambda_dssim: float = 0.2,
    data_axis: str = "data",
    gauss_axis: str = "gauss",
):
    """Training loss and gradients on a 2-D (``data``, ``gauss``) mesh:
    (the mean loss over every camera, {field: mean gradient of this rank's
    block of the map}). Owner-computes: each camera's loss is computed on
    every rank of the gauss axis from the gathered splats, and each rank
    backpropagates its own rows through its local preprocess; the one
    collective of the backward is the mean over ``data``."""
    if len(cameras) != gt_images.shape[0] or not len(cameras):
        raise ValueError(f"{len(cameras)} cameras for {gt_images.shape[0]} "
                         "images")
    zeros = torch.zeros((3,), dtype=torch.float32, device=gt_images.device)
    loss_sum, grad_sum = 0.0, None
    for cam, img in zip(cameras, gt_images):
        params = {k: getattr(gaussians, k).detach().requires_grad_()
                  for k in TRAINABLE}
        prep = preprocess(gaussians.replace(**params), cam,
                          tile_size=config.tile_size,
                          scale_modifier=config.scale_modifier)
        prep_full = _gather_prep(prep, mesh, gauss_axis)
        color, _, _, _ = _blend_full(prep_full, cam, config, zeros)
        loss, _ = losses.training_loss(color, img, lambda_dssim=lambda_dssim)
        grads = torch.autograd.grad(loss, [params[k] for k in TRAINABLE])
        loss_sum = loss_sum + loss.detach()
        grad_sum = grads if grad_sum is None else [
            a + b for a, b in zip(grad_sum, grads)]
    k = len(cameras)
    loss, grads = runtime.axis_mean(
        [loss_sum / k] + [g / k for g in grad_sum], mesh, data_axis)
    return loss, dict(zip(TRAINABLE, grads))


def make_mesh_2d(n_data: int, n_gauss: int,
                 names=("data", "gauss")) -> Mesh:
    """A (data, gauss) mesh over the world's ranks, rank-major: the ranks
    of one gauss group are consecutive."""
    return runtime.global_mesh(tuple(names), (n_data, n_gauss))
