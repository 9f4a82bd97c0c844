"""PLY import/export of Gaussian maps (numpy, no plyfile dependency).

The field layout is the 3DGS interchange convention: x y z nx ny nz
f_dc_0..2 f_rest_0..3*(K-1)-1 opacity scale_0..2 rot_0..3, all float32,
binary little-endian; f_rest is channel-major ((P, 3, K-1) flattened). Maps
written by the JAX package or by the reference trainer load unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..core.gaussians import GaussianParams


def save_gaussian_ply(path: str, g: GaussianParams) -> None:
    """Write the live Gaussians of ``g``."""
    arrays = g.to_numpy()
    live = arrays["live"]
    xyz = arrays["xyz"][live]
    f_dc = arrays["features_dc"][live]              # (P, 1, 3)
    f_rest = arrays["features_rest"][live]          # (P, K-1, 3)
    p = xyz.shape[0]
    k1 = f_rest.shape[1]

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * k1)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    out = np.empty(p, dtype=np.dtype([(n, "<f4") for n in names]))
    out["x"], out["y"], out["z"] = xyz.T
    out["nx"] = out["ny"] = out["nz"] = 0.0
    dc = f_dc.transpose(0, 2, 1).reshape(p, 3)      # channel-major (K=1)
    for i in range(3):
        out[f"f_dc_{i}"] = dc[:, i]
    rest = f_rest.transpose(0, 2, 1).reshape(p, 3 * k1)
    for i in range(3 * k1):
        out[f"f_rest_{i}"] = rest[:, i]
    out["opacity"] = arrays["opacity"][live][:, 0]
    for i in range(3):
        out[f"scale_{i}"] = arrays["scaling"][live][:, i]
    for i in range(4):
        out[f"rot_{i}"] = arrays["rotation"][live][:, i]

    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {p}\n"
              + "".join(f"property float {n}\n" for n in names)
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(out.tobytes())


def load_gaussian_ply(path: str, capacity: Optional[int] = None,
                      sh_degree: Optional[int] = None,
                      active_sh_degree: Optional[int] = None,
                      device="cuda") -> GaussianParams:
    """Read a map, padded to ``capacity``, onto ``device``."""
    with open(path, "rb") as f:
        data = f.read()
    idx = data.find(b"end_header\n")
    if idx < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:idx].decode("ascii", errors="replace").splitlines()
    body = data[idx + len(b"end_header\n"):]

    fmt = None
    count = 0
    names: list[str] = []
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element" and t[1] == "vertex":
            count = int(t[2])
        elif t[0] == "property" and len(t) == 3:
            if t[1] not in ("float", "float32"):
                raise ValueError(f"unsupported property type {t[1]}")
            names.append(t[2])
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    dtype = np.dtype([(n, "<f4") for n in names])
    arr = np.frombuffer(body[: count * dtype.itemsize], dtype=dtype)

    xyz = np.stack([arr["x"], arr["y"], arr["z"]], 1)
    f_dc = np.stack([arr[f"f_dc_{i}"] for i in range(3)], 1)[:, None, :]
    n_rest = sum(1 for n in names if n.startswith("f_rest_"))
    k1 = n_rest // 3
    if sh_degree is None:
        sh_degree = int(round(math.sqrt(k1 + 1))) - 1
    if n_rest:
        rest = np.stack([arr[f"f_rest_{i}"] for i in range(n_rest)],
                        1).reshape(count, 3, k1).transpose(0, 2, 1)
    else:
        rest = np.zeros((count, 0, 3), np.float32)
    return GaussianParams.from_arrays(
        xyz=xyz, features_dc=f_dc, features_rest=rest,
        scaling=np.stack([arr[f"scale_{i}"] for i in range(3)], 1),
        rotation=np.stack([arr[f"rot_{i}"] for i in range(4)], 1),
        opacity=arr["opacity"][:, None],
        sh_degree=sh_degree,
        active_sh_degree=(sh_degree if active_sh_degree is None
                          else active_sh_degree),
        capacity=capacity, device=device)
