"""Gradient-descent pose refinement against a pretrained 3DGS map.

Reference flow: per query, up to 50 Adam(lr 1e-3) steps over [rot_delta,
trans_delta, exposure_a, exposure_b]; each step renders, computes the
masked tracking loss, backprops to the SE(3) tangent, steps, then retracts
w2c <- exp(tau) @ w2c and re-zeros tau; stop when ||tau_update|| < 1e-4.

The loop is a Python loop (one host read per iteration for the convergence
test); queries are refined one after another. On the card the step is one
launch (S1, ``csrc/pose_algebra.cu``: both Adam updates, the exposure and
the update's norm), and the retraction and the tangent's way into the
render are A1/A2 (``core/se3.py``) and V1/V2 (``raster/pose_mode.py``):
six launches of pose algebra an iteration in pose mode, and no wait but
the convergence read. Each refinement records the
span ``refine/pose`` and, an iteration, ``refine/rebin`` (when it rebins),
``refine/render`` (render and loss), ``refine/backward``, ``refine/step``
(Adam and the retraction) and ``refine/converge`` (the read), with the
counters ``refine_iters``, ``rebins`` and ``host_sync/converge``
(``utils/profiling.py``).

The tracking loss: exposure compensation exp(a)*I + b, pixel mask =
grad_mask (x keypoint mask upstream), opacity mask alpha > 0.99, RGBD adds
(1-alpha_cfg)=0.01 x masked depth L1.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from .._kernels import check_tensor, launch
from ..core import se3
from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..raster.rasterize import RasterizerConfig, compute_bins, rasterize
from ..utils.profiling import count, host_read, span

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    num_iters: int = 50
    lr: float = 1e-3
    convergence: float = 1e-4
    opacity_threshold: float = 0.99
    alpha: float = 0.99
    monocular: bool = False
    # recompute the tile lists every N iterations (1 = every iteration)
    rebin_every: int = 1
    # gather pose-independent params per pair once per rebin and project
    # elementwise per iteration (raster/pose_mode.py); rgb is frozen at the
    # rebin view direction
    pose_mode: bool = False
    # divide the rendered depth (~alpha * true depth) by alpha before the
    # depth L1, restoring metric semantics
    normalize_depth: bool = False

    def replace(self, **kw) -> "TrackingConfig":
        return dataclasses.replace(self, **kw)


class RefineResult(NamedTuple):
    w2c: torch.Tensor          # (4, 4) refined pose
    exposure_ab: torch.Tensor  # (2,)
    num_iters: int             # iterations actually run
    final_loss: torch.Tensor   # ()
    overflow: Optional[torch.Tensor] = None  # () bool: a binning capacity
    #   was exceeded during the loop (truncated renders)


def tracking_loss(
    color: torch.Tensor,
    depth: torch.Tensor,
    alpha: torch.Tensor,
    exposure_ab: torch.Tensor,
    gt_image: torch.Tensor,
    grad_mask: torch.Tensor,
    cfg: TrackingConfig,
    gt_depth: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    image_ab = torch.exp(exposure_ab[0]) * color + exposure_ab[1]
    opacity_mask = (alpha > cfg.opacity_threshold).to(color.dtype)[..., None]
    gm = grad_mask.to(color.dtype)[..., None]
    l1 = opacity_mask * torch.abs(image_ab * gm - gt_image * gm)
    loss = torch.mean(l1)
    if not cfg.monocular:
        if gt_depth is None:
            raise ValueError("RGB-D tracking needs gt_depth "
                             "(or TrackingConfig(monocular=True))")
        dmask = ((gt_depth > 0.01).to(depth.dtype) * opacity_mask[..., 0]
                 * grad_mask.to(depth.dtype))
        if cfg.normalize_depth:
            depth = depth / torch.clamp_min(alpha, 1e-6)
        l1_d = torch.abs(depth * dmask - gt_depth * dmask)
        loss = loss + (1.0 - cfg.alpha) * torch.mean(l1_d)
    return loss


def adam_update(g, m, v, t: float, lr: float):
    """One Adam step at step count ``t``: (update, m, v)."""
    m = _B1 * m + (1 - _B1) * g
    v = _B2 * v + (1 - _B2) * g * g
    mhat = m / (1 - _B1**t)
    vhat = v / (1 - _B2**t)
    return -lr * mhat / (torch.sqrt(vhat) + _EPS), m, v


def refine_adam_plain(g6, g2, m6, v6, m2, v2, ab, t: float, lr: float):
    """The plain version of S1 (``csrc/pose_algebra.cu``): ``adam_update``
    of the tangent's gradient ``g6`` and the exposure's ``g2`` at step
    ``t``, the moments updated in place, ``ab`` += the exposure's update in
    place; returns (the tangent's update (6,), its norm ())."""
    upd, m, v = adam_update(torch.cat([g6, g2]), torch.cat([m6, m2]),
                            torch.cat([v6, v2]), t, lr)
    for dst, src in ((m6, m[:6]), (m2, m[6:]), (v6, v[:6]), (v2, v[6:])):
        dst.copy_(src)
    ab.add_(upd[6:])
    upd6 = upd[:6]
    return upd6, torch.linalg.norm(upd6)


def refine_adam_cuda(g6, g2, m6, v6, m2, v2, ab, t: float, lr: float):
    """Launch S1: ``refine_adam_plain``'s step in one kernel, the bias
    corrections computed here as ``adam_update`` computes them."""
    dev = m6.device
    g6, g2 = g6.contiguous(), g2.contiguous()
    for name, x, n in (("g6", g6, 6), ("g2", g2, 2), ("m6", m6, 6),
                       ("v6", v6, 6), ("m2", m2, 2), ("v2", v2, 2),
                       ("ab", ab, 2)):
        check_tensor(x, name, torch.float32, (n,), dev)
    upd6 = torch.empty(6, dtype=torch.float32, device=dev)
    norm = torch.empty((), dtype=torch.float32, device=dev)
    launch("refine_adam", dev, g6, g2, m6, v6, m2, v2, ab, upd6, norm, _B1,
           1 - _B1, _B2, 1 - _B2, _EPS, lr, 1 - _B1**t, 1 - _B2**t)
    return upd6, norm


def refine_adam(g6, g2, m6, v6, m2, v2, ab, t: float, lr: float):
    """S1 on CUDA tensors, ``refine_adam_plain`` elsewhere."""
    if m6.is_cuda:
        return refine_adam_cuda(g6, g2, m6, v6, m2, v2, ab, t, lr)
    return refine_adam_plain(g6, g2, m6, v6, m2, v2, ab, t, lr)


def refine_pose(
    gaussians: GaussianParams,
    camera: Camera,
    gt_image: torch.Tensor,
    grad_mask: torch.Tensor,
    cfg: TrackingConfig = TrackingConfig(),
    raster_cfg: RasterizerConfig = RasterizerConfig(),
    gt_depth: Optional[torch.Tensor] = None,
    bg: Optional[torch.Tensor] = None,
) -> RefineResult:
    """Refine one camera pose."""
    if cfg.pose_mode:
        from ..raster.pose_mode import (
            build_pair_pack, build_stream_pair_pack, render_pose_mode)

        # the uncapped stream pack, or the capped per-tile windows
        build = (build_stream_pair_pack if raster_cfg.use_stream
                 else build_pair_pack)

        def make_bins(cam):
            return build(gaussians, cam, raster_cfg)

        def bins_overflow(pack):
            return pack.overflow

        def render_at(cam, pack):
            return render_pose_mode(pack, cam, raster_cfg, bg=bg)
    else:
        def make_bins(cam):
            return compute_bins(gaussians, cam, raster_cfg)

        def bins_overflow(bins):
            return bins.overflow | bins.tile_overflow

        def render_at(cam, bins):
            out = rasterize(gaussians, cam, raster_cfg, bg=bg, bins=bins)
            return out.color, out.depth, out.alpha

    dev = camera.w2c.device
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=dev)  # noqa: E731
    w2c = camera.w2c.detach()
    ab = zeros(2)
    m6, v6, m2, v2 = zeros(6), zeros(6), zeros(2), zeros(2)
    loss = zeros(())
    bins, ovf = None, None
    it = 0
    with span("refine/pose"):
        while it < cfg.num_iters:
            if bins is None or cfg.rebin_every <= 1 \
                    or it % cfg.rebin_every == 0:
                with span("refine/rebin"):
                    count("rebins")
                    bins = make_bins(camera.replace(w2c=w2c))
                    ovf = bins_overflow(bins) if ovf is None \
                        else ovf | bins_overflow(bins)
            with span("refine/render"):
                tau = zeros(6).requires_grad_()
                ab_var = ab.clone().requires_grad_()
                color, depth, alpha = render_at(
                    camera.replace(w2c=w2c).with_delta(tau), bins)
                loss = tracking_loss(color, depth, alpha, ab_var, gt_image,
                                     grad_mask, cfg, gt_depth=gt_depth)
            with span("refine/backward"):
                g_tau, g_ab = torch.autograd.grad(loss, (tau, ab_var))
            with span("refine/step"):
                t = float(it + 1)
                with torch.no_grad():
                    upd6, norm = refine_adam(g_tau, g_ab, m6, v6, m2, v2, ab,
                                             t, cfg.lr)
                    # retraction: fold the updated tangent into the pose
                    w2c = se3.apply_delta(upd6, w2c)
            it += 1
            count("refine_iters")
            if cfg.convergence > 0:
                with span("refine/converge"):
                    done = host_read("converge", norm) < cfg.convergence
                if done:
                    break
        if ovf is None:                      # no iteration ran
            ovf = bins_overflow(make_bins(camera))
    return RefineResult(w2c=w2c, exposure_ab=ab, num_iters=it,
                        final_loss=loss.detach(), overflow=ovf)


def refine_poses_batch(
    gaussians: GaussianParams,
    cameras: Sequence[Camera],
    gt_images: torch.Tensor,         # (B, H, W, 3)
    grad_masks: torch.Tensor,        # (B, H, W)
    cfg: TrackingConfig = TrackingConfig(),
    raster_cfg: RasterizerConfig = RasterizerConfig(),
    gt_depths: Optional[torch.Tensor] = None,
    bg: Optional[torch.Tensor] = None,
) -> RefineResult:
    """Refine each query in turn; results stacked along a batch axis
    (``num_iters`` is then a list)."""
    res = [refine_pose(gaussians, cam, gt_images[i], grad_masks[i], cfg,
                       raster_cfg,
                       gt_depth=None if gt_depths is None else gt_depths[i],
                       bg=bg)
           for i, cam in enumerate(cameras)]
    return RefineResult(
        w2c=torch.stack([r.w2c for r in res]),
        exposure_ab=torch.stack([r.exposure_ab for r in res]),
        num_iters=[r.num_iters for r in res],
        final_loss=torch.stack([r.final_loss for r in res]),
        overflow=torch.stack([r.overflow for r in res]),
    )
