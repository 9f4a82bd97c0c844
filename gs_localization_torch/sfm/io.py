"""Pose-results and query-list files, as hloc writes them.

Formats:
- results files: ``name qw qx qy qz tx ty tz`` per line (w2c), the init
  poses the localization stage reads; values are written with
  ``repr(float)``, so a file round-trips bit for bit;
- query lists with intrinsics: ``name MODEL w h params...`` (per-query
  PINHOLE intrinsics for Cambridge).

Host-only numpy, the same files as the JAX package's ``sfm/io.py``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class QueryIntrinsics(NamedTuple):
    name: str
    model: str
    width: int
    height: int
    params: np.ndarray


def write_pose_results(path: str, poses: Dict[str, Tuple[np.ndarray, np.ndarray]]):
    """poses: name -> (qvec wxyz, tvec), w2c convention."""
    with open(path, "w") as f:
        for name, (q, t) in poses.items():
            qs = " ".join(repr(float(v)) for v in q)
            ts = " ".join(repr(float(v)) for v in t)
            f.write(f"{name} {qs} {ts}\n")


def read_pose_results(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    out = {}
    for line in open(path):
        t = line.strip().split()
        if not t:
            continue
        name = t[0]
        vals = np.array([float(v) for v in t[1:8]])
        out[name] = (vals[:4], vals[4:7])
    return out


def read_query_list_with_intrinsics(path: str) -> List[QueryIntrinsics]:
    out = []
    for line in open(path):
        t = line.strip().split()
        if not t or t[0].startswith("#"):
            continue
        out.append(QueryIntrinsics(
            name=t[0], model=t[1], width=int(t[2]), height=int(t[3]),
            params=np.array([float(v) for v in t[4:]]),
        ))
    return out


def intrinsics_matrix(q: QueryIntrinsics) -> np.ndarray:
    if q.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        f, cx, cy = q.params[0], q.params[1], q.params[2]
        fx = fy = f
    else:
        fx, fy, cx, cy = q.params[0], q.params[1], q.params[2], q.params[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
