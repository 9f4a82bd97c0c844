"""Frozen network weights as a module tree shaped like a JAX params tree.

The JAX package keeps each network's weights as a nested dict / list of
arrays. ``ParamTree`` holds the same tree as an ``nn.Module``: a dict
becomes a submodule, a list an ``nn.ModuleList``, an array a float32
``nn.Parameter`` without gradient, so the forward code reads
``p["gn1"]["gamma"]`` as the JAX code does, and ``.parameters()``,
``.to()`` and ``state_dict()`` see every weight. A 4-d array is a
convolution kernel: JAX's HWIO layout becomes PyTorch's OIHW here.

``load_named`` loads an official checkpoint's state dict into a network
whose submodules carry the checkpoint's names.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn


def _node(v: Any, device: torch.device):
    if isinstance(v, dict):
        return ParamTree(v, device)
    if isinstance(v, (list, tuple)):
        return nn.ModuleList([_node(x, device) for x in v])
    a = np.asarray(v, np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return nn.Parameter(torch.tensor(np.ascontiguousarray(a), device=device),
                        requires_grad=False)


class ParamTree(nn.Module):
    """A nested dict of arrays (lists of dicts allowed) as frozen float32
    parameters on ``device``; 4-d arrays go from HWIO to OIHW."""

    def __init__(self, tree: dict, device):
        super().__init__()
        for k, v in tree.items():
            setattr(self, k, _node(v, torch.device(device)))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters


def load_named(net: nn.Module, state_dict: Dict[str, Any], label: str,
               prefix: str = "", optional: Sequence[str] = ()) -> nn.Module:
    """Load ``state_dict`` into ``net`` by name, floating values as
    float32. Keys may carry ``prefix``, which is cut; the batch norms'
    ``num_batches_tracked`` counters, which inference does not read, and
    the names in ``optional`` may be absent. Any other missing or
    unexpected key raises a KeyError that names it."""
    sd = {}
    for k, v in state_dict.items():
        k = k[len(prefix):] if prefix and k.startswith(prefix) else k
        v = torch.as_tensor(np.asarray(v))
        sd[k] = v.to(torch.float32) if v.is_floating_point() else v
    missing, unexpected = net.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")
               and k not in optional]
    if missing or unexpected:
        raise KeyError(f"{label} state dict: missing {missing}, "
                       f"unexpected {unexpected}")
    return net
