"""Inputs made from the seed: the Gaussian map, camera poses, target images.

The map recipe is the port's benchmark scene (positions uniform in a box in
front of the bench camera, DC colours uniform, higher SH bands small
normals, log scales uniform, identity rotations, logit opacities uniform),
drawn on the device by one ``torch.Generator`` in two large calls. Poses are
the bench camera (identity world-to-camera) moved by seeded tangents, drawn
on the host. Targets are rendered by the benchmark's own plain renderer
(``reference/splat.py``) at the true poses.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .reference import splat

SEED_MASK = (1 << 62) - 1


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one stream of draws of a run (streams do not
    overlap for a seed)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + stream) & SEED_MASK)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & SEED_MASK, stream])


def make_map(spec: dict, seed: int, device) -> splat.Map:
    """The map of a configuration's ``map`` entry, float32 on ``device``."""
    n, deg = int(spec["num_gaussians"]), int(spec["sh_degree"])
    k = (deg + 1) ** 2
    g = generator(seed, device, 0)
    u = torch.rand((n, 10), generator=g, device=device)
    rest = spec["sh_rest_std"] * torch.randn((n, k - 1, 3), generator=g,
                                             device=device)

    def span(col, lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * u[:, col]

    box = spec["box"]
    xyz = torch.stack([span(i, box[i]) for i in range(3)], 1)
    rgb = torch.stack([span(3 + i, spec["rgb"]) for i in range(3)], 1)
    log_scale = torch.stack([span(6 + i, spec["log_scale"])
                             for i in range(3)], 1)
    quat = torch.zeros((n, 4), device=device)
    quat[:, 0] = 1.0
    opa = span(9, spec["opacity_logit"])
    dc = (rgb - 0.5) / splat.SH_C0
    sh = torch.cat([dc[:, None, :], rest], 1)
    return splat.Map(xyz, log_scale, quat, opa, sh, deg)


def camera(sensor: dict, w2c: torch.Tensor, focal_scale: float = 1.0
           ) -> splat.Cam:
    return splat.Cam(w2c, float(sensor["fx"]) * focal_scale,
                     float(sensor["fy"]) * focal_scale, float(sensor["cx"]),
                     float(sensor["cy"]), int(sensor["width"]),
                     int(sensor["height"]))


def unit(r: np.random.Generator) -> np.ndarray:
    v = r.standard_normal(3)
    return v / np.linalg.norm(v)


def moved_poses(count: int, trans: float, rot: float, seed: int,
                stream: int) -> List[np.ndarray]:
    """``count`` world-to-camera poses: the bench camera moved by a tangent
    of ``trans`` m and ``rot`` rad in random directions, float64 (every
    seed moves its poses by the same amounts)."""
    r = rng(seed, stream)
    out = []
    for _ in range(count):
        tau = np.concatenate([trans * unit(r), rot * unit(r)])
        out.append(se3_exp_np(tau))
    return out


def init_tangents(count: int, lo: float, hi: float, seed: int, stream: int
                  ) -> np.ndarray:
    """(count, 6) tangents whose components have magnitudes uniform in
    [lo, hi] and random signs."""
    r = rng(seed, stream)
    mag = r.uniform(lo, hi, (count, 6))
    return mag * np.where(r.uniform(size=(count, 6)) < 0.5, -1.0, 1.0)


def se3_exp_np(tau: np.ndarray) -> np.ndarray:
    t = torch.tensor(np.asarray(tau, np.float64))
    return splat.se3_exp(t).numpy()


def render_targets(m: splat.Map, cams: List[splat.Cam]):
    """Colour and depth of each camera, float32, on the map's device."""
    out = []
    with torch.no_grad():
        for cam in cams:
            scr = splat.project(m, cam)
            b = splat.blend(scr.table, splat.bin_tiles(scr, cam), cam)
            out.append((b.color.float().contiguous(),
                        b.depth.float().contiguous()))
    return out
