"""Data-parallel map training and query-parallel localization.

A 1-D ``data`` mesh of ranks, each owning one device:

- map training: each rank renders its own cameras against the replicated
  Gaussian map, takes the mean loss and gradients over them, and the ranks
  average those over the mesh (one all-reduce; gloo has no average, so a
  sum divided by the axis size);
- localization: each rank refines its own queries (no collective in the
  loop), then the results are all-gathered so that every rank holds the
  whole batch, as the JAX package's global array does.

The per-rank functions take this rank's block of the batch
(``runtime.make_global_batch``): PyTorch has no global array.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..loc.refine import RefineResult, TrackingConfig, refine_poses_batch
from ..mapping import losses
from ..mapping.train import TRAINABLE
from ..raster import RasterizerConfig, rasterize
from . import runtime
from .runtime import Mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """A 1-D mesh over the world's ranks. One rank is one device, so
    ``n_devices`` (JAX's count of local devices to take) must be the world
    size when given."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"one rank is one device: a mesh of {n_devices} "
                         f"needs a world of {n_devices} ranks, not {world}")
    return runtime.global_mesh((axis,))


def _grads_of(gaussians: GaussianParams, camera: Camera, img: torch.Tensor,
              raster_cfg: RasterizerConfig, lambda_dssim: float):
    params = {k: getattr(gaussians, k).detach().requires_grad_()
              for k in TRAINABLE}
    out = rasterize(gaussians.replace(**params), camera, raster_cfg)
    loss, _ = losses.training_loss(out.color, img, lambda_dssim=lambda_dssim)
    grads = torch.autograd.grad(loss, [params[k] for k in TRAINABLE])
    return loss.detach(), grads


def dp_train_grads(
    mesh: Mesh,
    gaussians: GaussianParams,
    cameras: Sequence[Camera],   # this rank's block
    gt_images: torch.Tensor,     # (k, H, W, 3), this rank's block
    raster_cfg: RasterizerConfig,
    lambda_dssim: float = 0.2,
):
    """(mean loss, {field: mean gradient}) over the whole batch of cameras
    sharded over the mesh: the mean over this rank's cameras, then the mean
    over the ``data`` axis (every rank holds as many cameras). Gaussians
    are replicated; every rank returns the same values."""
    axis = mesh.axis_names[0]
    if len(cameras) != gt_images.shape[0] or not len(cameras):
        raise ValueError(f"{len(cameras)} cameras for {gt_images.shape[0]} "
                         "images")
    loss_sum, grad_sum = 0.0, None
    for cam, img in zip(cameras, gt_images):
        loss, grads = _grads_of(gaussians, cam, img, raster_cfg,
                                lambda_dssim)
        loss_sum = loss_sum + loss
        grad_sum = grads if grad_sum is None else [
            a + b for a, b in zip(grad_sum, grads)]
    k = len(cameras)
    loss, grads = runtime.axis_mean(
        [loss_sum / k] + [g / k for g in grad_sum], mesh, axis)
    return loss, dict(zip(TRAINABLE, grads))


def shard_queries_refine(
    mesh: Mesh,
    gaussians: GaussianParams,
    cameras: Sequence[Camera],     # this rank's block of queries
    gt_images: torch.Tensor,       # (k, H, W, 3)
    grad_masks: torch.Tensor,      # (k, H, W)
    cfg: TrackingConfig,
    raster_cfg: RasterizerConfig,
    gt_depths: Optional[torch.Tensor] = None,
) -> RefineResult:
    """Refine this rank's queries (``refine_poses_batch``; no collective in
    the loop), then all-gather the results over the ``data`` axis: every
    rank returns the whole batch in global order (``num_iters`` a list).
    Without depths the queries get zero depth maps, as in the JAX
    package."""
    axis = mesh.axis_names[0]
    if gt_depths is None:
        gt_depths = torch.zeros(gt_images.shape[:3], dtype=torch.float32,
                                device=gt_images.device)
    res = refine_poses_batch(gaussians, cameras, gt_images, grad_masks, cfg,
                             raster_cfg, gt_depths=gt_depths)
    group = mesh.group(axis)
    iters = torch.tensor(res.num_iters, dtype=torch.int64,
                         device=res.w2c.device)
    return RefineResult(
        w2c=runtime.all_gather_cat(res.w2c, group),
        exposure_ab=runtime.all_gather_cat(res.exposure_ab, group),
        num_iters=runtime.all_gather_cat(iters, group).tolist(),
        final_loss=runtime.all_gather_cat(res.final_loss, group),
        overflow=runtime.all_gather_cat(res.overflow, group),
    )


# ---------------------------------------------------------------------------
def tiny_scene(n: int = 256, sh_degree: int = 1, capacity=None, seed: int = 0,
               device="cuda") -> GaussianParams:
    """The JAX package's tiny dryrun scene (``__graft_entry__._tiny_scene``),
    the same numpy draws: n Gaussians in front of a camera at the origin, on
    ``device`` (the card unless ``"cpu"``)."""
    from ..core import sh as sh_lib

    rng = np.random.default_rng(seed)
    k = sh_lib.num_sh_coeffs(sh_degree)
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 5, n)], 1).astype(np.float32)
    return GaussianParams.from_arrays(
        xyz=xyz,
        features_dc=sh_lib.rgb_to_sh_dc(
            rng.uniform(0.1, 0.9, (n, 3))).astype(np.float32)[:, None, :],
        features_rest=np.zeros((n, k - 1, 3), np.float32),
        scaling=rng.uniform(-3.0, -2.0, (n, 3)).astype(np.float32),
        rotation=np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
        opacity=rng.uniform(0.0, 2.0, (n, 1)).astype(np.float32),
        sh_degree=sh_degree, capacity=capacity, device=device)


DRYRUN_SIZE = (32, 32)      # W, H of the dryrun's views
# the JAX dryrun's capacities; the id-matrix layout (K3/K4 on the card), so
# that a tile holds at most max_per_tile pairs as with JAX's jnp blend
DRYRUN_CFG = RasterizerConfig(max_pairs=1 << 12, max_per_tile=64, chunk=32,
                              pallas_chunk=64, use_stream=False)


def dryrun_cameras(n: int, device, seed: int = 0):
    """The dryrun's camera batch: n views at the origin moved by 0.01-scale
    tangents drawn from ``seed``, and n uniform random target images (the
    JAX dryrun's draws)."""
    w, h = DRYRUN_SIZE
    rng = np.random.default_rng(seed)
    taus = (0.01 * rng.standard_normal((n, 6))).astype(np.float32)
    base = Camera.from_rt(np.eye(3), np.zeros(3), 30.0, 30.0, w, h,
                          device=device)
    cams = [base.with_delta(torch.tensor(t, device=device)) for t in taus]
    imgs = torch.tensor(rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32),
                        device=device)
    return cams, imgs


def dryrun_train_step(n_devices: int, device="cuda") -> None:
    """One DP-sharded training step on tiny shapes, then a 2-D (data, gauss)
    loss and a tile-sharded render, in a world of ``n_devices`` ranks (or
    one process without a group for 1), on ``device`` (the card unless
    ``"cpu"``). Prints one line each."""
    from .gauss_shard import (gauss_sharded_loss_and_grads, make_mesh_2d,
                              shard_rows)
    from .tile_shard import rasterize_tile_sharded

    dev = runtime.rank_device(device)
    mesh = make_mesh(n_devices)
    g = tiny_scene(n=128, sh_degree=1, seed=1, device=dev)
    cams, imgs = dryrun_cameras(n_devices, dev)
    lo, hi = runtime.host_local_slice(n_devices, mesh)
    loss, grads = dp_train_grads(mesh, g, cams[lo:hi], imgs[lo:hi],
                                 DRYRUN_CFG)
    # one SGD step at lr 1e-3: the parameters move
    g2 = g.replace(**{k: getattr(g, k) - 1e-3 * grads[k] for k in TRAINABLE})
    delta = float((g2.xyz - g.xyz).abs().sum())
    if not (np.isfinite(float(loss)) and np.isfinite(delta)):
        raise RuntimeError(f"dryrun: DP step not finite ({loss}, {delta})")
    print(f"dryrun_multichip: DP {n_devices} devices, loss={float(loss):.4f}"
          " ok", flush=True)

    if n_devices >= 2 and n_devices % 2 == 0:
        n_data = n_devices // 2
        mesh2 = make_mesh_2d(n_data, 2)
        g128 = tiny_scene(n=128, sh_degree=1, seed=2, device=dev)
        cams2, imgs2 = dryrun_cameras(n_data, dev, seed=1)
        i = mesh2.index("data")
        loss2, grads2 = gauss_sharded_loss_and_grads(
            mesh2, shard_rows(g128, mesh2), cams2[i:i + 1], imgs2[i:i + 1],
            DRYRUN_CFG)
        if not (np.isfinite(float(loss2)) and all(
                bool(torch.isfinite(v).all()) for v in grads2.values())):
            raise RuntimeError("dryrun: the 2-D mesh's loss is not finite")
        print(f"dryrun_multichip: data{n_data} x gauss2 mesh, "
              f"loss={float(loss2):.4f} ok", flush=True)

    ts = DRYRUN_CFG.tile_size
    cam_big = Camera.from_rt(np.eye(3), np.zeros(3), 30.0, 30.0, 32,
                             ts * n_devices, device=dev)
    out = rasterize_tile_sharded(make_mesh(n_devices, axis="tile"), g,
                                 cam_big, DRYRUN_CFG)
    if not bool(torch.isfinite(out.color).all()):
        raise RuntimeError("dryrun: the tile-sharded render is not finite")
    print(f"dryrun_multichip: tile-sharded render over {n_devices} ok",
          flush=True)
