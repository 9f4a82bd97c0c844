"""Known-pose multi-view triangulation + track building + depth correction.

Covers the role pycolmap.triangulate_points plays in the LoGS pipeline
(hloc/triangulation.py:186+ — triangulation of matched
features into an SfM model whose camera poses are KNOWN a priori, which is
exactly the 7-Scenes/Cambridge setting) plus the pipeline's RGB-D snap of
triangulated points (sfm/7scenes_sfm_full_dslam.py:28-155):

- ``epipolar_filter_matches``: geometric verification of pair matches
  against the known poses (symmetric epipolar distance) — the reference's
  ``geometric_verification`` (hloc/triangulation.py:128-190). Without it,
  outlier matches transitively merge keypoints into giant tracks
  (union-find collapse) and triangulation starves.
- ``build_tracks``     : union-find over pairwise matches (host numpy).
- ``triangulate_tracks``: batched DLT (SVD of the stacked incidence rows)
  with reprojection-error and triangulation-angle filters.
- ``correct_points_with_depth``: project each point into its observing
  views, bilinear-sample calibrated depth, re-back-project, average.

Host-side numpy, a copy of the JAX package's ``sfm/triangulate.py``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------- tracks ----
class Tracks(NamedTuple):
    # element e = observation (image_idx, keypoint_idx) belonging to track_id
    track_ids: np.ndarray      # (E,)
    image_idx: np.ndarray      # (E,)
    kp_idx: np.ndarray         # (E,)
    num_tracks: int


def epipolar_filter_matches(
    matches: np.ndarray,        # (M, 2) keypoint index pairs (img a, img b)
    kps_a: np.ndarray,          # (Ka, 2) pixels
    kps_b: np.ndarray,
    w2c_a: np.ndarray,          # (4, 4)
    w2c_b: np.ndarray,
    K_a: np.ndarray,            # (3, 3)
    K_b: np.ndarray,
    max_epip_px: float = 4.0,
) -> np.ndarray:
    """Keep matches whose symmetric epipolar distance under the KNOWN
    relative pose is below ``max_epip_px`` (reference geometric
    verification, hloc/triangulation.py:128-190)."""
    if len(matches) == 0:
        return matches
    T_ba = w2c_b @ np.linalg.inv(w2c_a)
    R, t = T_ba[:3, :3], T_ba[:3, 3]
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                  [-t[1], t[0], 0]]) @ R
    F = np.linalg.inv(K_b).T @ E @ np.linalg.inv(K_a)
    pa = np.concatenate([kps_a[matches[:, 0]],
                         np.ones((len(matches), 1))], 1)   # (M, 3)
    pb = np.concatenate([kps_b[matches[:, 1]],
                         np.ones((len(matches), 1))], 1)
    Fa = pa @ F.T                                          # lines in b
    Fb = pb @ F                                            # lines in a
    num = np.abs(np.sum(pb * Fa, axis=1))
    d_b = num / np.maximum(np.hypot(Fa[:, 0], Fa[:, 1]), 1e-12)
    d_a = num / np.maximum(np.hypot(Fb[:, 0], Fb[:, 1]), 1e-12)
    keep = np.maximum(d_a, d_b) < max_epip_px
    return matches[keep]


def build_tracks(
    num_images: int,
    keypoint_counts: Sequence[int],
    pair_matches: Dict[Tuple[int, int], np.ndarray],
) -> Tracks:
    """pair_matches[(i, j)] = (M, 2) arrays of (kp_i, kp_j) index pairs."""
    offsets = np.zeros(num_images + 1, np.int64)
    offsets[1:] = np.cumsum(keypoint_counts)
    total = int(offsets[-1])
    parent = np.arange(total)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for (i, j), m in pair_matches.items():
        gi = offsets[i] + m[:, 0]
        gj = offsets[j] + m[:, 1]
        for a, b in zip(gi, gj):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

    roots = np.array([find(a) for a in range(total)])
    # keep only observed keypoints (those appearing in some match)
    observed = np.zeros(total, bool)
    for (i, j), m in pair_matches.items():
        observed[offsets[i] + m[:, 0]] = True
        observed[offsets[j] + m[:, 1]] = True
    obs_idx = np.nonzero(observed)[0]
    uniq, tids = np.unique(roots[obs_idx], return_inverse=True)
    img_idx = np.searchsorted(offsets, obs_idx, side="right") - 1
    kp_idx = obs_idx - offsets[img_idx]
    # drop ambiguous observations: a track seeing >1 keypoint of the same
    # image is an outlier merge (COLMAP's track-merge conflict rule)
    pair_key = tids.astype(np.int64) * num_images + img_idx
    _, inv, cnt = np.unique(pair_key, return_inverse=True,
                            return_counts=True)
    ok = cnt[inv] == 1
    tids, img_idx, kp_idx = tids[ok], img_idx[ok], kp_idx[ok]
    if len(tids):
        uniq2, tids = np.unique(tids, return_inverse=True)
        n_tracks = len(uniq2)
    else:
        n_tracks = 0
    return Tracks(tids, img_idx, kp_idx, n_tracks)


# --------------------------------------------------------- triangulation ----
def triangulate_tracks(
    tracks: Tracks,
    keypoints: Sequence[np.ndarray],    # per image (K_i, 2) pixels
    w2c: np.ndarray,                    # (N, 4, 4)
    K: np.ndarray,                      # (N, 3, 3) intrinsics
    max_reproj_px: float = 4.0,
    min_tri_angle_deg: float = 1.5,
    min_views: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz (T, 3), valid (T,)) for each track id."""
    t_count = tracks.num_tracks
    # normalized rays per observation
    obs_xy = np.stack(
        [keypoints[i][k] for i, k in zip(tracks.image_idx, tracks.kp_idx)]
    ) if len(tracks.image_idx) else np.zeros((0, 2))
    Ks = K[tracks.image_idx]
    xn = (obs_xy[:, 0] - Ks[:, 0, 2]) / Ks[:, 0, 0]
    yn = (obs_xy[:, 1] - Ks[:, 1, 2]) / Ks[:, 1, 1]
    P = w2c[tracks.image_idx][:, :3, :]               # (E, 3, 4)
    # DLT rows: xn * P[2] - P[0],  yn * P[2] - P[1]
    r0 = xn[:, None] * P[:, 2] - P[:, 0]              # (E, 4)
    r1 = yn[:, None] * P[:, 2] - P[:, 1]

    # accumulate normal matrices per track: A^T A (4x4)
    AtA = np.zeros((t_count, 4, 4))
    for r in (r0, r1):
        contrib = r[:, :, None] * r[:, None, :]
        np.add.at(AtA, tracks.track_ids, contrib)
    # nullspace per track
    _, _, vt = np.linalg.svd(AtA)
    xh = vt[:, -1, :]
    w = xh[:, 3:]
    xyz = np.where(np.abs(w) > 1e-12, xh[:, :3] / np.where(w == 0, 1, w), 0.0)

    # filters: cheirality + reprojection + angle + view count
    Xc = np.einsum("eij,ej->ei", w2c[tracks.image_idx][:, :3, :3],
                   xyz[tracks.track_ids]) + w2c[tracks.image_idx][:, :3, 3]
    z = Xc[:, 2]
    good_z = z > 1e-4
    zs = np.where(good_z, z, 1.0)
    u = Ks[:, 0, 0] * Xc[:, 0] / zs + Ks[:, 0, 2]
    v = Ks[:, 1, 1] * Xc[:, 1] / zs + Ks[:, 1, 2]
    err = np.sqrt((u - obs_xy[:, 0]) ** 2 + (v - obs_xy[:, 1]) ** 2)
    good_obs = good_z & (err < max_reproj_px)

    views = np.zeros(t_count)
    np.add.at(views, tracks.track_ids, good_obs.astype(float))

    # triangulation angle: max pairwise angle between viewing rays (approx:
    # use spread of camera centers vs point distance)
    centers = -np.einsum("eij,ei->ej", w2c[tracks.image_idx][:, :3, :3],
                         w2c[tracks.image_idx][:, :3, 3])
    rays = xyz[tracks.track_ids] - centers
    rays /= np.maximum(np.linalg.norm(rays, axis=1, keepdims=True), 1e-12)
    mean_ray = np.zeros((t_count, 3))
    np.add.at(mean_ray, tracks.track_ids, np.where(good_obs[:, None], rays, 0))
    cnt = np.maximum(views, 1)[:, None]
    mean_ray /= cnt
    # dispersion of rays ~ sin(angle/2); threshold accordingly
    disp = 1.0 - np.linalg.norm(mean_ray, axis=1)
    min_disp = 1.0 - np.cos(np.radians(min_tri_angle_deg) / 2)

    valid = (views >= min_views) & (disp >= min_disp * 0.5)
    return xyz, valid


# ------------------------------------------------------- depth correction ---
def correct_points_with_depth(
    xyz: np.ndarray,                   # (T, 3)
    tracks: Tracks,
    w2c: np.ndarray, K: np.ndarray,
    depth_maps: Sequence[np.ndarray],  # per image (H, W) meters, 0 = invalid
    max_views_avg: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Snap points onto the RGB-D surface: re-back-project the bilinear
    depth at each observation and average (the reference overwrites xyz and
    drops points with no valid depth, sfm/7scenes_sfm_full_dslam.py:93-155).
    """
    t_count = xyz.shape[0]
    accum = np.zeros((t_count, 3))
    weight = np.zeros(t_count)
    ii = tracks.image_idx
    Xc = np.einsum("eij,ej->ei", w2c[ii][:, :3, :3], xyz[tracks.track_ids]) \
        + w2c[ii][:, :3, 3]
    z = Xc[:, 2]
    ok = z > 1e-4
    zs = np.where(ok, z, 1.0)
    u = K[ii][:, 0, 0] * Xc[:, 0] / zs + K[ii][:, 0, 2]
    v = K[ii][:, 1, 1] * Xc[:, 1] / zs + K[ii][:, 1, 2]
    for e in range(len(ii)):
        if not ok[e]:
            continue
        dm = depth_maps[ii[e]]
        h, w = dm.shape
        x, y = u[e], v[e]
        if not (0 <= x < w - 1 and 0 <= y < h - 1):
            continue
        x0, y0 = int(x), int(y)
        patch = dm[y0 : y0 + 2, x0 : x0 + 2]
        if np.any(patch <= 0):
            # nearest fallback (reference: bilinear then nearest)
            d = dm[int(round(y)), int(round(x))]
            if d <= 0:
                continue
        else:
            fx, fy = x - x0, y - y0
            d = (patch[0, 0] * (1 - fx) * (1 - fy) + patch[0, 1] * fx * (1 - fy)
                 + patch[1, 0] * (1 - fx) * fy + patch[1, 1] * fx * fy)
        # back-project to world
        xc = np.array([(x - K[ii[e]][0, 2]) / K[ii[e]][0, 0] * d,
                       (y - K[ii[e]][1, 2]) / K[ii[e]][1, 1] * d, d])
        Rw = w2c[ii[e]][:3, :3]
        tw = w2c[ii[e]][:3, 3]
        pw = Rw.T @ (xc - tw)
        tid = tracks.track_ids[e]
        accum[tid] += pw
        weight[tid] += 1.0

    has_depth = weight > 0
    out = xyz.copy()
    out[has_depth] = accum[has_depth] / weight[has_depth, None]
    return out, has_depth
