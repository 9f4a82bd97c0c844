"""Training-state checkpoint/resume.

The full ``MapTrainState`` (Gaussian fields and SH degrees, every group's
Adam moments and count, the densify statistics, the step and the random
background generator's state) in one ``torch.save`` file, written to
``path + ".tmp"`` and moved into place with ``os.replace``, so a reader
never sees half a file. PLY snapshots of the map alone live in
``data/ply.py``.

These files are the port's own: the JAX package's checkpoints are flax
msgpack and cannot be read here. A JAX training state carries over through
``MapTrainState.from_numpy`` instead.
"""

from __future__ import annotations

import os

import torch

from ..core.gaussians import FIELDS
from .densify import DensifyState
from .train import TRAINABLE, AdamMoments, MapTrainState

_DENSIFY = ("grad_accum", "denom", "max_radii")


def save_checkpoint(path: str, state: MapTrainState) -> None:
    g = state.gaussians
    data = {f"gaussians/{f}": getattr(g, f).detach().cpu() for f in FIELDS}
    data["sh_degree"] = int(g.sh_degree)
    data["max_sh_degree"] = int(g.max_sh_degree)
    for name, m in state.opt_state.items():
        data[f"mu/{name}"] = m.mu.cpu()
        data[f"nu/{name}"] = m.nu.cpu()
        data[f"count/{name}"] = m.count.cpu()
    for f in _DENSIFY:
        data[f"densify/{f}"] = getattr(state.densify, f).cpu()
    data["step"] = int(state.step)
    data["generator"] = state.generator.get_state()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(data, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, template: MapTrainState) -> MapTrainState:
    """Restore onto ``template``'s device. The template must have the same
    capacity and SH width (build it with ``init_training`` on a
    same-capacity ``GaussianParams``); a mismatch raises."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    g0 = template.gaussians
    dev = g0.device

    def take(key, like):
        t = data[key]
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint {key}: shape {tuple(t.shape)}, "
                             f"template {tuple(like.shape)}")
        return t.to(device=dev, dtype=like.dtype)

    g = g0.replace(sh_degree=int(data["sh_degree"]),
                   max_sh_degree=int(data["max_sh_degree"]),
                   **{f: take(f"gaussians/{f}", getattr(g0, f))
                      for f in FIELDS})
    opt = {n: AdamMoments(take(f"mu/{n}", template.opt_state[n].mu),
                          take(f"nu/{n}", template.opt_state[n].nu),
                          take(f"count/{n}", template.opt_state[n].count))
           for n in TRAINABLE}
    dens = DensifyState(*(take(f"densify/{f}", getattr(template.densify, f))
                          for f in _DENSIFY))
    gen = torch.Generator(device=dev)
    gen.set_state(data["generator"])
    return template.replace(gaussians=g, opt_state=opt, densify=dens,
                            step=int(data["step"]), generator=gen)
