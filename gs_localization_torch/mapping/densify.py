"""Adaptive density control (clone / split / prune / opacity reset).

- stats: accumulate ||dL/dmean2D|| per visible Gaussian and a visit count;
  the pixel-space gradient of ``means2d_offset`` is scaled by (W/2, H/2).
- clone: avg grad >= threshold and max scale <= percent_dense * extent.
- split: avg grad >= threshold and max scale > percent_dense * extent, into
  ``split_n`` samples ~ N(0, scale) rotated to world, scale / (0.8 split_n).
- prune: opacity < min_opacity; with ``max_screen_size``, also screen
  radius > max_screen_size or world size > 0.1 * extent.
- reset_opacity: opacity <- min(opacity, 0.01).

Capacity is fixed: dead slots are masked by ``live``; new Gaussians go into
free slots by rank, and the Adam moments of new and replaced slots are
zeroed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from ..core.gaussians import GaussianParams, inverse_sigmoid, pad_rows
from ..utils.profiling import count_wait


@dataclasses.dataclass(frozen=True)
class DensifyState:
    grad_accum: torch.Tensor   # (N,) sum of ndc-grad norms
    denom: torch.Tensor        # (N,) visit counts
    max_radii: torch.Tensor    # (N,) float max screen radius

    def replace(self, **kw) -> "DensifyState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(cls, capacity: int, device) -> "DensifyState":
        z = lambda: torch.zeros(capacity, dtype=torch.float32,  # noqa: E731
                                device=device)
        return cls(grad_accum=z(), denom=z(), max_radii=z())

    def grown(self, new_capacity: int) -> "DensifyState":
        """Zero-padded to a larger capacity."""
        return DensifyState(*(pad_rows(a, new_capacity) for a in
                              (self.grad_accum, self.denom, self.max_radii)))


def update_stats(
    state: DensifyState,
    means2d_grad_pix: torch.Tensor,   # (N, 2) pixel-space grad
    visibility: torch.Tensor,         # (N,) bool
    radii: torch.Tensor,              # (N,) int32
    width: int,
    height: int,
) -> DensifyState:
    count_wait("densify_scale", means2d_grad_pix.device)
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=means2d_grad_pix.device)
    norm = torch.linalg.vector_norm(means2d_grad_pix * scale, dim=-1)
    vis = visibility.to(torch.float32)
    return state.replace(
        grad_accum=state.grad_accum + norm * vis,
        denom=state.denom + vis,
        max_radii=torch.maximum(state.max_radii,
                                radii.to(torch.float32) * vis),
    )


class DensifyReport(NamedTuple):
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    dropped: torch.Tensor     # new Gaussians that did not fit in capacity


def _rotate_samples(quat: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """Rotate local samples into world by the (unnormalized) quaternions."""
    n = torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    q = quat / torch.clamp_min(n, 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )
    return torch.einsum("nij,nj->ni", R, samples)


def densify_and_prune(
    gaussians: GaussianParams,
    state: DensifyState,
    opt_state: Dict,
    generator: Optional[torch.Generator] = None,
    grad_threshold: float = 2e-4,
    min_opacity: float = 0.005,
    extent: float = 1.0,
    max_screen_size: Optional[float] = None,
    percent_dense: float = 0.01,
    split_n: int = 2,
    samples: Optional[torch.Tensor] = None,
):
    """One densification round -> (gaussians, densify state, opt_state,
    DensifyReport). ``opt_state`` maps each trainable field to its
    ``AdamMoments``; their ``mu``/``nu`` rows are zeroed for new and
    replaced slots. ``samples`` (split_n, capacity, 3) are the standard
    normals of the split offsets; without them they are drawn from
    ``generator``."""
    cap = gaussians.capacity
    dev = gaussians.device
    live = gaussians.live
    grads = torch.where(state.denom > 0,
                        state.grad_accum / torch.clamp_min(state.denom, 1.0),
                        torch.zeros_like(state.grad_accum))
    std = gaussians.get_scaling
    max_scale = torch.amax(std, dim=1)

    hot = live & (grads >= grad_threshold)
    clone_mask = hot & (max_scale <= percent_dense * extent)
    split_mask = hot & (max_scale > percent_dense * extent)

    # prune on the pre-densify population: new Gaussians cannot be pruned in
    # the same round, so the order is equivalent to clone -> split -> prune
    prune = live & (gaussians.get_opacity[:, 0] < min_opacity)
    if max_screen_size is not None:
        prune = prune | (live & (state.max_radii > max_screen_size)) \
                      | (live & (max_scale > 0.1 * extent))
    remove = prune | split_mask          # split originals are replaced
    live_after = live & ~remove

    if samples is None:
        samples = torch.randn((split_n, cap, 3), generator=generator,
                              device=dev)
    if tuple(samples.shape) != (split_n, cap, 3):
        raise ValueError(f"samples: shape {tuple(samples.shape)}, expected "
                         f"{(split_n, cap, 3)}")
    # new set = [clones] + [split children x split_n], each a copy of its
    # source slot with its own xyz and scaling
    new_masks = [clone_mask] + [split_mask] * split_n
    new_xyz = [gaussians.xyz] + [
        gaussians.xyz + _rotate_samples(gaussians.rotation, samples[s] * std)
        for s in range(split_n)]
    child_scaling = torch.log(torch.clamp_min(std / (0.8 * split_n), 1e-10))
    new_scaling = [gaussians.scaling] + [child_scaling] * split_n
    n_new = (1 + split_n) * cap
    all_mask = torch.cat(new_masks)
    all_xyz = torch.cat(new_xyz)
    all_scaling = torch.cat(new_scaling)
    all_src = torch.arange(n_new, device=dev) % cap

    # r-th new Gaussian -> r-th free slot (after removal), in index order
    sel_rank = torch.cumsum(all_mask.to(torch.int32), 0) - 1
    free = ~live_after
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    num_free = torch.sum(free.to(torch.int32))
    slot_of_rank = torch.full((n_new,), cap, dtype=torch.int64, device=dev)
    # two mask indices, nonzero, and below two writes of a host scalar
    count_wait("densify_select", dev, 5)
    slot_of_rank[free_rank[free].long()] = torch.arange(cap, device=dev)[free]
    fits = all_mask & (sel_rank < num_free)
    sel = torch.nonzero(fits, as_tuple=True)[0]
    target = slot_of_rank[sel_rank[sel].long()]
    src = all_src[sel]

    def scatter(dest, values):
        out = dest.clone()
        out[target] = values
        return out

    live_new = live_after.clone()
    live_new[target] = True
    new_g = gaussians.replace(
        xyz=scatter(gaussians.xyz, all_xyz[sel]),
        features_dc=scatter(gaussians.features_dc, gaussians.features_dc[src]),
        features_rest=scatter(gaussians.features_rest,
                              gaussians.features_rest[src]),
        scaling=scatter(gaussians.scaling, all_scaling[sel]),
        rotation=scatter(gaussians.rotation, gaussians.rotation[src]),
        opacity=scatter(gaussians.opacity, gaussians.opacity[src]),
        live=live_new,
    )

    # optimizer state: zero the moments of touched slots
    touched = remove.clone()
    touched[target] = True
    new_opt_state = {name: m.zero_rows(touched)
                     for name, m in opt_state.items()}

    report = DensifyReport(
        num_cloned=torch.sum(clone_mask.to(torch.int32)),
        num_split=torch.sum(split_mask.to(torch.int32)),
        num_pruned=torch.sum(prune.to(torch.int32)),
        dropped=torch.sum((all_mask & ~fits).to(torch.int32)),
    )
    return new_g, DensifyState.create(cap, dev), new_opt_state, report


def reset_opacity(gaussians: GaussianParams, opt_state: Dict,
                  ceiling: float = 0.01):
    """opacity <- min(opacity, ceiling). The Adam moments are returned as
    they are: the JAX package's ``reset_opacity`` matches tree paths by
    attribute name, which optax's dict-keyed state never has, so it leaves
    every moment untouched, and the port keeps that behaviour."""
    new_opacity = inverse_sigmoid(
        torch.clamp_max(gaussians.get_opacity, ceiling))
    return gaussians.replace(opacity=new_opacity), opt_state
