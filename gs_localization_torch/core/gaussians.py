"""Gaussian splat parameters at a fixed capacity.

Field semantics mirror the reference ``GaussianModel``:

- ``xyz``            (N, 3)        world positions
- ``features_dc``    (N, 1, 3)     SH DC band
- ``features_rest``  (N, K-1, 3)   higher SH bands, K = (sh_degree+1)^2
- ``scaling``        (N, 3)        log-space scales (activation: exp)
- ``rotation``       (N, 4)        wxyz quaternion (activation: normalize)
- ``opacity``        (N, 1)        logit opacity (activation: sigmoid)
- ``live``           (N,)          bool: arrays are padded to a capacity and
                                   dead slots are masked out
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from .. import resolve_device
from . import sh as sh_lib

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "live")


def pad_rows(a: torch.Tensor, rows: int, fill=0.0) -> torch.Tensor:
    """``a`` with its leading dimension padded to ``rows`` by ``fill``."""
    out = a.new_full((rows,) + tuple(a.shape[1:]), fill)
    out[:a.shape[0]] = a
    return out


@dataclasses.dataclass(frozen=True)
class GaussianParams:
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    live: torch.Tensor
    sh_degree: int = 3
    max_sh_degree: int = 3

    def replace(self, **kw) -> "GaussianParams":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_live(self) -> torch.Tensor:
        return torch.sum(self.live.to(torch.int32))

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        sq = torch.sum(self.rotation * self.rotation, dim=-1, keepdim=True)
        return self.rotation * torch.rsqrt(torch.clamp_min(sq, 1e-20))

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        """(N, K, 3) concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def one_up_sh_degree(self) -> "GaussianParams":
        if self.sh_degree < self.max_sh_degree:
            return self.replace(sh_degree=self.sh_degree + 1)
        return self

    def grown(self, new_capacity: int) -> "GaussianParams":
        """Pad every per-Gaussian array to a larger capacity: dead slots
        (``live`` False) with log-scale and logit opacity -10 and the
        quaternion [1, 0, 0, 0], so that normalizing stays finite."""
        cap = self.capacity
        if new_capacity < cap:
            raise ValueError(f"new capacity {new_capacity} < {cap}")
        if new_capacity == cap:
            return self

        n = new_capacity
        rot = pad_rows(self.rotation, n)
        rot[cap:, 0] = 1.0
        return self.replace(
            xyz=pad_rows(self.xyz, n), features_dc=pad_rows(self.features_dc, n),
            features_rest=pad_rows(self.features_rest, n),
            scaling=pad_rows(self.scaling, n, -10.0), rotation=rot,
            opacity=pad_rows(self.opacity, n, -10.0),
            live=pad_rows(self.live, n, False))

    # ------------------------------------------------------------------
    @classmethod
    def empty(cls, capacity: int, sh_degree: int = 3,
              active_sh_degree: int = 0, device="cuda") -> "GaussianParams":
        dev = resolve_device(device)
        k = sh_lib.num_sh_coeffs(sh_degree)
        f32 = dict(dtype=torch.float32, device=dev)
        rotation = torch.zeros((capacity, 4), **f32)
        rotation[:, 0] = 1.0
        return cls(
            xyz=torch.zeros((capacity, 3), **f32),
            features_dc=torch.zeros((capacity, 1, 3), **f32),
            features_rest=torch.zeros((capacity, k - 1, 3), **f32),
            scaling=torch.full((capacity, 3), -10.0, **f32),
            rotation=rotation,
            opacity=torch.full((capacity, 1), -10.0, **f32),
            live=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            sh_degree=active_sh_degree,
            max_sh_degree=sh_degree,
        )

    @classmethod
    def from_arrays(cls, xyz, features_dc, features_rest, scaling, rotation,
                    opacity, sh_degree: int,
                    active_sh_degree: Optional[int] = None,
                    capacity: Optional[int] = None,
                    device="cuda") -> "GaussianParams":
        """Build from dense (unpadded) arrays, padding to ``capacity``."""
        dev = resolve_device(device)
        p = np.asarray(xyz).shape[0]
        cap = capacity or p
        if cap < p:
            raise ValueError(f"capacity {cap} < points {p}")

        def pad(a, fill=0.0):
            a = torch.tensor(np.asarray(a, np.float32), device=dev)
            if cap == p:
                return a
            out = torch.full((cap,) + tuple(a.shape[1:]), fill,
                             dtype=torch.float32, device=dev)
            out[:p] = a
            return out

        live = torch.arange(cap, device=dev) < p
        rot = pad(rotation)
        # keep dead-slot quaternions valid so normalize() stays finite
        rot[p:] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        return cls(
            xyz=pad(xyz), features_dc=pad(features_dc),
            features_rest=pad(features_rest),
            scaling=pad(scaling, fill=-10.0), rotation=rot,
            opacity=pad(opacity, fill=-10.0), live=live,
            sh_degree=sh_degree if active_sh_degree is None
            else active_sh_degree,
            max_sh_degree=sh_degree,
        )

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], sh_degree: int,
                   max_sh_degree: int, device="cuda") -> "GaussianParams":
        """Carry a map over as it is, capacity and ``live`` mask included.

        ``arrays`` holds the JAX package's field names (``FIELDS``) as numpy
        arrays, so ``{f: np.asarray(getattr(g_jax, f)) for f in FIELDS}``
        puts both packages on the same map.
        """
        dev = resolve_device(device)
        missing = [f for f in FIELDS if f not in arrays]
        if missing:
            raise KeyError(f"missing Gaussian fields: {missing}")
        t = {f: torch.tensor(np.asarray(arrays[f], np.float32), device=dev)
             for f in FIELDS if f != "live"}
        live = torch.tensor(np.asarray(arrays["live"], bool), device=dev)
        return cls(live=live, sh_degree=int(sh_degree),
                   max_sh_degree=int(max_sh_degree), **t)

    @classmethod
    def from_pcd(cls, points, colors, sh_degree: int = 3,
                 capacity: Optional[int] = None, point_size: float = 1.0,
                 mean_sq_dist=None, device="cuda") -> "GaussianParams":
        """Initialize from a coloured point cloud (SfM points): DC features
        from RGB, isotropic log-scales from sqrt(mean 3-NN squared
        distance), identity quaternions, opacity sigmoid^-1(0.1); active SH
        degree 0."""
        from ..ops.knn import mean_knn_sq_dist  # local import: avoids a cycle

        dev = resolve_device(device)
        points = np.asarray(points, np.float32)
        p = points.shape[0]
        if p == 0:
            raise ValueError(
                "cannot initialize a Gaussian map from 0 points: the SfM "
                "stage produced an empty cloud")
        k = sh_lib.num_sh_coeffs(sh_degree)
        if mean_sq_dist is None:
            mean_sq_dist = mean_knn_sq_dist(
                torch.tensor(points, device=dev), k=3)
        dist = torch.clamp_min(torch.as_tensor(mean_sq_dist,
                                               dtype=torch.float32,
                                               device=dev), 1e-7)
        scales = torch.log(torch.sqrt(dist) * point_size)[:, None].repeat(1, 3)
        fdc = sh_lib.rgb_to_sh_dc(np.asarray(colors, np.float32))[:, None, :]
        rot = np.zeros((p, 4), np.float32)
        rot[:, 0] = 1.0
        return cls.from_arrays(
            xyz=points, features_dc=fdc,
            features_rest=np.zeros((p, k - 1, 3), np.float32),
            scaling=scales.cpu().numpy(), rotation=rot,
            opacity=np.full((p, 1), _inverse_sigmoid(0.1), np.float32),
            sh_degree=sh_degree, active_sh_degree=0, capacity=capacity,
            device=dev)

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).detach().cpu().numpy() for f in FIELDS}


def _inverse_sigmoid(x: float) -> float:
    return float(np.log(x / (1.0 - x)))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))
