"""Image-pair generation: covisibility / exhaustive / sequential / poses.

Equivalents of hloc's pairs_from_covisibility (rank DB images by shared 3D
points, keep top-k — hloc/pairs_from_covisibility.py:12-56),
pairs_from_exhaustive, a sequential-window generator, and pairs_from_poses
(camera-center distance top-k gated by principal-axis angle —
hloc/pairs_from_poses.py:14-53). Retrieval-based pairs live
in sfm/retrieval.py.

Host-side numpy, a copy of the JAX package's ``sfm/pairs.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def pairs_from_covisibility(
    images: Dict[int, "ColmapImage"], top_k: int = 30,
) -> List[Tuple[str, str]]:
    """Rank, for each image, the others by number of shared 3D point ids."""
    ids = sorted(images.keys())
    point_sets = {
        i: set(int(p) for p in images[i].point3d_ids if p >= 0) for i in ids
    }
    pairs = []
    for i in ids:
        scores = []
        for j in ids:
            if i == j:
                continue
            shared = len(point_sets[i] & point_sets[j])
            if shared > 0:
                scores.append((shared, j))
        scores.sort(reverse=True)
        for _, j in scores[:top_k]:
            pairs.append((images[i].name, images[j].name))
    return pairs


def pairs_exhaustive(names: List[str]) -> List[Tuple[str, str]]:
    return [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]


def pairs_from_poses(
    images: Dict[int, "ColmapImage"],
    num_matched: int = 10,
    rotation_threshold: float = 30.0,
) -> List[Tuple[str, str]]:
    """Top-k nearest cameras by center distance, excluding view directions
    more than ``rotation_threshold`` degrees apart.

    Matches the reference's semantics (pairs_from_poses.py:14-53): poses are
    inverted to camera-to-world, proximity is the L2 distance between camera
    centers, and the gating angle is between the cameras' *principal axes*
    (third row of R, i.e. third column of Rᵀ) rather than the full relative
    rotation — two images rolled about the optical axis still see the same
    scene. Selection per row is highest score (= smallest distance) first,
    like hloc's pairs_from_score_matrix top-k.
    """
    ids = sorted(images.keys())
    rs = np.stack([images[i].rotmat() for i in ids], 0)         # (N,3,3) w2c
    ts = np.stack([images[i].tvec for i in ids], 0)             # (N,3)
    centers = -np.einsum("nij,nj->ni", rs.transpose(0, 2, 1), ts)
    axes = rs[:, 2, :]   # c2w principal axis = third row of w2c R
    dist = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
    dots = np.clip(axes @ axes.T, -1.0, 1.0)
    d_rot = np.degrees(np.arccos(dots))

    invalid = d_rot >= rotation_threshold
    np.fill_diagonal(invalid, True)
    scores = np.where(invalid, -np.inf, -dist)
    pairs = []
    k = min(num_matched, len(ids) - 1)
    for qi in range(len(ids)):
        order = np.argsort(-scores[qi])[:k]
        for j in order:
            if not invalid[qi, j]:
                pairs.append((images[ids[qi]].name, images[ids[j]].name))
    return pairs


def pairs_sequential(names: List[str], window: int = 5,
                     loop: bool = False) -> List[Tuple[str, str]]:
    n = len(names)
    pairs = []
    for i in range(n):
        for d in range(1, window + 1):
            j = i + d
            if j < n:
                pairs.append((names[i], names[j]))
            elif loop:
                pairs.append((names[i], names[j % n]))
    return pairs
