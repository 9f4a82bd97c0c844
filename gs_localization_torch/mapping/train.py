"""Map-training step: per-group Adam, LR schedule, densify statistics.

Optimizer semantics are the JAX package's optax chain, written out: per
trainable field one Adam (b1 0.9, b2 0.999, eps 1e-15 added outside the
square root, bias-corrected with the count after its increment) followed by
a step of -lr. The xyz learning rate decays exponentially from
1.6e-4 * spatial_scale to 1.6e-6 * spatial_scale over 30k steps, read at the
count BEFORE the increment; the other groups are constant (f_dc 2.5e-3,
f_rest / 20, opacity 0.05, scaling 5e-3, rotation 1e-3). Every group's
count advances every step. Gradients of dead slots are masked before the
update, so their moments stay zero.

The moments are explicit tensors per group (``AdamMoments``), so that
densification can zero rows of them and ``grow_capacity`` can pad them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import Camera
from ..core.gaussians import FIELDS, GaussianParams, pad_rows
from ..raster.rasterize import RasterizerConfig, rasterize
from ..utils.profiling import count_wait, span
from . import losses
from .densify import DensifyState, update_stats

TRAINABLE = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
             "opacity")
_B1, _B2, _EPS = 0.9, 0.999, 1e-15


@dataclasses.dataclass(frozen=True)
class MapTrainConfig:
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    spatial_scale: float = 1.0
    lambda_dssim: float = 0.2
    lambda_pseudo_depth: float = 0.01
    lambda_gt_depth: float = 0.05
    lambda_pseudo_view: float = 0.005
    random_background: bool = False


class AdamMoments(NamedTuple):
    """One parameter group's Adam state."""

    mu: torch.Tensor      # first moment, the parameter's shape
    nu: torch.Tensor      # second moment
    count: torch.Tensor   # () int32 steps taken

    def zero_rows(self, mask: torch.Tensor) -> "AdamMoments":
        m = mask.reshape((-1,) + (1,) * (self.mu.dim() - 1))
        return self._replace(mu=torch.where(m, torch.zeros_like(self.mu),
                                            self.mu),
                             nu=torch.where(m, torch.zeros_like(self.nu),
                                            self.nu))

    def grown(self, new_capacity: int) -> "AdamMoments":
        return self._replace(mu=pad_rows(self.mu, new_capacity),
                             nu=pad_rows(self.nu, new_capacity))


def _expon_lr(step: torch.Tensor, lr_init: float, lr_final: float,
              max_steps: int) -> torch.Tensor:
    """exp(log(lr_init) (1 - t) + log(lr_final) t), t = clip(step / max)."""
    f32 = dict(dtype=torch.float32, device=step.device)
    count_wait("lr_const", step.device, 2)
    t = torch.clamp(step.to(torch.float32) / max_steps, 0.0, 1.0)
    return torch.exp(torch.log(torch.tensor(lr_init, **f32)) * (1 - t)
                     + torch.log(torch.tensor(lr_final, **f32)) * t)


def group_lr(cfg: MapTrainConfig, name: str, count: torch.Tensor):
    """The learning rate of group ``name`` at a count (before the step)."""
    if name == "xyz":
        return _expon_lr(count, cfg.position_lr_init * cfg.spatial_scale,
                         cfg.position_lr_final * cfg.spatial_scale,
                         cfg.position_lr_max_steps)
    return {"features_dc": cfg.feature_lr,
            "features_rest": cfg.feature_lr / 20.0,
            "scaling": cfg.scaling_lr, "rotation": cfg.rotation_lr,
            "opacity": cfg.opacity_lr}[name]


def adam_step(cfg: MapTrainConfig, name: str, param: torch.Tensor,
              grad: torch.Tensor, m: AdamMoments):
    """One optax ``scale_by_adam`` + ``scale(-lr)`` step of one group ->
    (new param, new moments)."""
    mu = (1 - _B1) * grad + _B1 * m.mu
    nu = (1 - _B2) * (grad * grad) + _B2 * m.nu
    count_inc = m.count + 1
    c = count_inc.to(torch.float32)
    count_wait("adam_const", c.device, 2)
    bc1 = 1 - torch.pow(torch.tensor(_B1, dtype=torch.float32,
                                     device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(_B2, dtype=torch.float32,
                                     device=c.device), c)
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
    step = -group_lr(cfg, name, m.count) * update
    return param + step, AdamMoments(mu, nu, count_inc)


@dataclasses.dataclass(frozen=True)
class MapTrainState:
    gaussians: GaussianParams
    opt_state: Dict[str, AdamMoments]
    densify: DensifyState
    step: int
    generator: torch.Generator   # random backgrounds

    def replace(self, **kw) -> "MapTrainState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], sh_degree: int,
                   max_sh_degree: int, seed: int = 0,
                   device="cuda") -> "MapTrainState":
        """Carry a training state over. ``arrays`` holds the Gaussian fields
        (``FIELDS``), per group ``mu/<name>``, ``nu/<name>`` and
        ``count/<name>``, the densify stats ``grad_accum``, ``denom`` and
        ``max_radii``, and ``step``."""
        dev = resolve_device(device)
        g = GaussianParams.from_numpy({f: arrays[f] for f in FIELDS},
                                      sh_degree, max_sh_degree, device=dev)

        def f32(key):
            return torch.tensor(np.asarray(arrays[key], np.float32),
                                device=dev)

        opt = {n: AdamMoments(f32(f"mu/{n}"), f32(f"nu/{n}"),
                              torch.tensor(int(arrays[f"count/{n}"]),
                                           dtype=torch.int32, device=dev))
               for n in TRAINABLE}
        dens = DensifyState(f32("grad_accum"), f32("denom"), f32("max_radii"))
        return cls(gaussians=g, opt_state=opt, densify=dens,
                   step=int(arrays["step"]),
                   generator=torch.Generator(device=dev).manual_seed(seed))


def init_training(gaussians: GaussianParams, cfg: MapTrainConfig,
                  seed: int = 0) -> MapTrainState:
    dev = gaussians.device
    opt = {n: AdamMoments(torch.zeros_like(getattr(gaussians, n)),
                          torch.zeros_like(getattr(gaussians, n)),
                          torch.zeros((), dtype=torch.int32, device=dev))
           for n in TRAINABLE}
    return MapTrainState(
        gaussians=gaussians, opt_state=opt,
        densify=DensifyState.create(gaussians.capacity, dev), step=0,
        generator=torch.Generator(device=dev).manual_seed(seed))


def grow_capacity(state: MapTrainState, new_capacity: int) -> MapTrainState:
    """Grow the Gaussian capacity between steps: dead slots for the
    parameters, zero rows for the Adam moments and densify stats."""
    old = state.gaussians.capacity
    if new_capacity <= old:
        raise ValueError(f"new capacity {new_capacity} <= {old}")
    return state.replace(
        gaussians=state.gaussians.grown(new_capacity),
        opt_state={n: m.grown(new_capacity)
                   for n, m in state.opt_state.items()},
        densify=state.densify.grown(new_capacity))


def _leaves(g0: GaussianParams):
    """The trainable fields as fresh leaves, and a zero ``means2d_offset``
    leaf whose gradient is the screen-space gradient of the densify
    statistics."""
    params = {k: getattr(g0, k).detach().requires_grad_() for k in TRAINABLE}
    offset = torch.zeros((g0.capacity, 2), dtype=torch.float32,
                         device=g0.device, requires_grad=True)
    return params, offset


def _grads(loss: torch.Tensor, params, offset):
    leaves = [params[k] for k in TRAINABLE] + [offset]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if gr is None else gr
            for x, gr in zip(leaves, grads)]


@torch.no_grad()
def _update(state: MapTrainState, cfg: MapTrainConfig, grads, visibility,
            radii, width: int, height: int) -> MapTrainState:
    """One Adam step of every group from ``grads`` (the trainable fields'
    then the offset's) and the densify statistics of the step."""
    g0 = state.gaussians
    live = g0.live
    new_params, new_opt = {}, {}
    for name, gr in zip(TRAINABLE, grads):
        # mask dead slots so their Adam moments stay zero
        gr = gr * live.reshape((-1,) + (1,) * (gr.dim() - 1))
        new_params[name], new_opt[name] = adam_step(
            cfg, name, getattr(g0, name), gr, state.opt_state[name])
    new_densify = update_stats(state.densify, grads[-1], visibility, radii,
                               width, height)
    return state.replace(gaussians=g0.replace(**new_params),
                         opt_state=new_opt, densify=new_densify,
                         step=state.step + 1)


def train_step(
    state: MapTrainState,
    camera: Camera,
    gt_image: torch.Tensor,
    cfg: MapTrainConfig,
    raster_cfg: RasterizerConfig,
    gt_depth: Optional[torch.Tensor] = None,
    pseudo_depth: Optional[torch.Tensor] = None,
    pseudo_camera: Optional[Camera] = None,
    pseudo_view_depth: Optional[torch.Tensor] = None,
):
    """One optimization step -> (new state, aux dict of tensors). No host
    read: the flags in ``aux`` stay on the device. Spans ``train/render``
    (binning inside as ``render/binning``), ``train/pseudo_render``,
    ``train/loss``, ``train/backward`` and ``train/adam`` (the update and
    the densify statistics; ``utils/profiling.py``).

    ``pseudo_camera``/``pseudo_view_depth`` add the few-shot pseudo-view
    term: the pseudo camera is rendered in the same graph (the step's
    background, no screen-space offset) and
    ``lambda_pseudo_view * min-Pearson(pseudo_view_depth, its depth)`` is
    added to the loss (``aux["pseudo_view"]``; ``aux["total"]`` stays the
    main view's loss, as in the JAX step). The densify statistics come from
    the main view only; the capacity flags of ``aux`` cover both views
    (``overflow`` and ``tile_overflow`` OR-ed, ``max_tile_count`` the
    larger)."""
    g0 = state.gaussians
    with span("train/render"):
        bg = (torch.rand(3, generator=state.generator, device=g0.device)
              if cfg.random_background else None)
        params, offset = _leaves(g0)
        g = g0.replace(**params)
        out = rasterize(g, camera, raster_cfg, bg=bg, means2d_offset=offset)
    with span("train/loss"):
        loss, aux = losses.training_loss(
            out.color, gt_image, depth=out.depth, gt_depth=gt_depth,
            pseudo_depth=pseudo_depth, lambda_dssim=cfg.lambda_dssim,
            lambda_pseudo_depth=cfg.lambda_pseudo_depth,
            lambda_gt_depth=cfg.lambda_gt_depth)
    pv = None
    if pseudo_camera is not None and pseudo_view_depth is not None:
        with span("train/pseudo_render"):
            pv = rasterize(g, pseudo_camera, raster_cfg, bg=bg)
        with span("train/loss"):
            pv_loss = losses.pearson_depth_loss(pseudo_view_depth, pv.depth)
            loss = loss + cfg.lambda_pseudo_view * pv_loss
            aux["pseudo_view"] = pv_loss
    with span("train/backward"):
        grads = _grads(loss, params, offset)
    with span("train/adam"):
        new_state = _update(state, cfg, grads, out.visibility, out.radii,
                            camera.width, camera.height)
    aux = {k: v.detach() for k, v in aux.items()}
    aux["num_rendered"] = out.num_rendered
    aux["overflow"] = out.overflow
    aux["tile_overflow"] = out.tile_overflow
    aux["max_tile_count"] = out.max_tile_count
    if pv is not None:      # the capacity audit sees the pseudo view too
        aux["overflow"] = out.overflow | pv.overflow
        aux["tile_overflow"] = out.tile_overflow | pv.tile_overflow
        aux["max_tile_count"] = torch.maximum(out.max_tile_count,
                                              pv.max_tile_count)
    return new_state, aux


def train_step_batched(
    state: MapTrainState,
    cameras: Sequence[Camera],
    gt_images: torch.Tensor,                 # (B, H, W, 3)
    cfg: MapTrainConfig,
    raster_cfg: RasterizerConfig,
    gt_depths: Optional[torch.Tensor] = None,  # (B, H, W)
):
    """One step on the mean loss of B views of one image size: one Adam
    update from the gradients of the mean, a zero background, the random
    generator left as it is. The views are rendered one after another,
    each backward taken at once, so one view's graph is alive at a time;
    one ``means2d_offset`` leaf serves all of them, so its gradient (the
    densify statistics') is the mean loss's. Visibility is OR-ed and radii
    max-ed over the views. Returns (new state, aux with ``total``, ``l1``
    (means over the views), ``overflow``, ``tile_overflow`` (any) and
    ``max_tile_count`` (max))."""
    g0 = state.gaussians
    params, offset = _leaves(g0)
    g = g0.replace(**params)
    n = len(cameras)
    grads, totals, l1s = None, [], []
    visibility, radii, flags = None, None, []
    for b, cam in enumerate(cameras):
        out = rasterize(g, cam, raster_cfg, means2d_offset=offset)
        loss, aux = losses.training_loss(
            out.color, gt_images[b], depth=out.depth,
            gt_depth=None if gt_depths is None else gt_depths[b],
            lambda_dssim=cfg.lambda_dssim,
            lambda_gt_depth=cfg.lambda_gt_depth)
        gb = _grads(loss / n, params, offset)
        grads = gb if grads is None else [a + c for a, c in zip(grads, gb)]
        totals.append(loss.detach())
        l1s.append(aux["l1"].detach())
        visibility = out.visibility if visibility is None \
            else visibility | out.visibility
        radii = out.radii if radii is None else torch.maximum(radii,
                                                              out.radii)
        flags.append((out.overflow, out.tile_overflow, out.max_tile_count))
    new_state = _update(state, cfg, grads, visibility, radii,
                        cameras[0].width, cameras[0].height)
    overflow, tile_overflow, max_tile_count = zip(*flags)
    return new_state, {
        "total": torch.stack(totals).mean(),
        "l1": torch.stack(l1s).mean(),
        "overflow": torch.stack(overflow).any(),
        "tile_overflow": torch.stack(tile_overflow).any(),
        "max_tile_count": torch.stack(max_tile_count).max(),
    }
