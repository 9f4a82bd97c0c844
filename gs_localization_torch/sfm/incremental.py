"""Native incremental SfM with unknown poses.

Fills the role of ``pycolmap.incremental_mapping`` in the reference's full
reconstruction path (hloc/reconstruction.py:186-229): from
per-image keypoints and pairwise matches alone, recover camera poses and a
3D point cloud. The reference ships no algorithm of its own here — it calls
COLMAP's C++ mapper; this is a from-scratch design:

- two-view bootstrap: vectorized 8-point essential-matrix RANSAC
  (all hypotheses solved as one batched SVD) + cheirality disambiguation,
- registration: native PnP-RANSAC (sfm/pnp.py) against the growing model,
- structure: batched multi-view DLT retriangulation (sfm/triangulate.py),
- refinement: matrix-free LM bundle adjustment on the caller's device
  (sfm/bundle_adjust.py) — the device does the heavy solving; the host only
  orders registrations.

Scope matches the reference usage: shared or per-image PINHOLE intrinsics,
no in-loop distortion estimation (the data layer undistorts first,
ops/undistort.py).

Host-side numpy, a copy of the JAX package's ``sfm/incremental.py``; only the
bundle adjustment runs on ``device``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import quat_to_rotmat
from .bundle_adjust import bundle_adjust_np
from .pnp import pnp_ransac
from .triangulate import Tracks, build_tracks, triangulate_tracks


class Reconstruction(NamedTuple):
    w2c: np.ndarray          # (N, 4, 4)
    registered: np.ndarray   # (N,) bool
    points: np.ndarray       # (T, 3)
    valid: np.ndarray        # (T,) bool
    tracks: Tracks
    init_pair: Tuple[int, int]


# ------------------------------------------------------------------ two-view
def _normalize(kp: np.ndarray, K: np.ndarray) -> np.ndarray:
    return np.stack([(kp[:, 0] - K[0, 2]) / K[0, 0],
                     (kp[:, 1] - K[1, 2]) / K[1, 1]], 1)


def essential_ransac(
    xy1: np.ndarray, xy2: np.ndarray,      # (M, 2) normalized coords
    num_hypotheses: int = 1024,
    thresh: float = 2e-3,                  # Sampson error, normalized units
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """8-point essential matrix RANSAC, all hypotheses as one batched SVD.

    Returns (E (3,3), inliers (M,) bool)."""
    m = xy1.shape[0]
    assert m >= 8
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(m, 8, replace=False)
                    for _ in range(num_hypotheses)])        # (S, 8)
    x1, y1 = xy1[idx, 0], xy1[idx, 1]                       # (S, 8)
    x2, y2 = xy2[idx, 0], xy2[idx, 1]
    ones = np.ones_like(x1)
    # epipolar constraint rows: [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1]
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
                 axis=-1)                                   # (S, 8, 9)
    _, _, vt = np.linalg.svd(A)
    F = vt[:, -1, :].reshape(-1, 3, 3)                      # (S, 3, 3)
    # project to essential: singular values -> (1, 1, 0)
    U, _, Vt = np.linalg.svd(F)
    # keep det(U), det(V) = +1 so the decomposition yields rotations
    U *= np.sign(np.linalg.det(U))[:, None, None]
    Vt *= np.sign(np.linalg.det(Vt))[:, None, None]
    S = np.zeros((len(F), 3, 3))
    S[:, 0, 0] = S[:, 1, 1] = 1.0
    E = U @ S @ Vt                                          # (S, 3, 3)

    # Sampson error of every hypothesis on every match
    p1 = np.concatenate([xy1, np.ones((m, 1))], 1)          # (M, 3)
    p2 = np.concatenate([xy2, np.ones((m, 1))], 1)
    Ex1 = np.einsum("sij,mj->smi", E, p1)                   # (S, M, 3)
    Etx2 = np.einsum("sji,mj->smi", E, p2)
    x2Ex1 = np.einsum("mi,smi->sm", p2, Ex1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 \
        + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    sampson = x2Ex1 ** 2 / np.maximum(denom, 1e-12)         # (S, M)
    inl = sampson < thresh**2
    best = int(np.argmax(inl.sum(1)))
    return E[best], inl[best]


def decompose_essential(
    E: np.ndarray, xy1: np.ndarray, xy2: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pick the (R, t) of the 4 candidates with the best cheirality count.

    Convention: cam1 at identity, returned pose maps cam1-coords to
    cam2-coords (w2c2 when w2c1 = I). |t| = 1 (scale gauge)."""
    U, _, Vt = np.linalg.svd(E)
    U *= np.sign(np.linalg.det(U))
    Vt *= np.sign(np.linalg.det(Vt))
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    cands = []
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            cands.append((R, t))

    def count_front(R, t):
        z1, z2 = _triangulate_two_view(np.eye(3), np.zeros(3), R, t, xy1, xy2)
        return int(np.sum((z1 > 0) & (z2 > 0)))

    counts = [count_front(R, t) for R, t in cands]
    R, t = cands[int(np.argmax(counts))]
    return R, t


def _triangulate_two_view(R1, t1, R2, t2, xy1, xy2):
    """Midpoint-free DLT per match; returns view-space depths (z1, z2)."""
    P1 = np.concatenate([R1, t1[:, None]], 1)
    P2 = np.concatenate([R2, t2[:, None]], 1)
    m = xy1.shape[0]
    A = np.stack([
        xy1[:, 0, None] * P1[2] - P1[0][None],
        xy1[:, 1, None] * P1[2] - P1[1][None],
        xy2[:, 0, None] * P2[2] - P2[0][None],
        xy2[:, 1, None] * P2[2] - P2[1][None],
    ], axis=1)                                              # (M, 4, 4)
    _, _, vt = np.linalg.svd(A)
    Xh = vt[:, -1, :]
    X = Xh[:, :3] / np.where(np.abs(Xh[:, 3:]) < 1e-12, 1e-12, Xh[:, 3:])
    z1 = (X @ R1.T + t1)[:, 2]
    z2 = (X @ R2.T + t2)[:, 2]
    return z1, z2


# ------------------------------------------------------------------- mapper
def incremental_mapping(
    keypoints: Sequence[np.ndarray],                 # per image (K_i, 2) px
    pair_matches: Dict[Tuple[int, int], np.ndarray],  # (i, j) -> (M, 2)
    K: np.ndarray,                                   # (N, 3, 3) or (3, 3)
    min_init_matches: int = 50,
    min_reg_points: int = 12,
    pnp_max_error_px: float = 8.0,
    reproj_filter_px: float = 4.0,
    ba_every: int = 3,
    ba_iters: int = 10,
    final_ba_iters: int = 25,
    verify_pairs: bool = True,
    seed: int = 0,
    verbose: bool = False,
    device="cuda",
) -> Reconstruction:
    device = resolve_device(device)
    n = len(keypoints)
    K = np.asarray(K, np.float64)
    if K.ndim == 2:
        K = np.tile(K[None], (n, 1, 1))

    if verify_pairs:
        # two-view geometric verification: drop epipolar outliers before
        # track building, else wrong matches chain distinct 3D points into
        # one track (the reference runs the same filter before COLMAP,
        # hloc/triangulation.py:128-190)
        verified = {}
        for (i, j), m in pair_matches.items():
            if len(m) < 8:
                continue
            xy1 = _normalize(keypoints[i][m[:, 0]], K[i])
            xy2 = _normalize(keypoints[j][m[:, 1]], K[j])
            _, inl = essential_ransac(xy1, xy2, seed=seed)
            if inl.sum() >= 8:
                verified[(i, j)] = m[inl]
        pair_matches = verified

    tracks = build_tracks(n, [len(k) for k in keypoints], pair_matches)
    w2c = np.tile(np.eye(4), (n, 1, 1))
    registered = np.zeros(n, bool)
    points = np.zeros((tracks.num_tracks, 3))
    valid = np.zeros(tracks.num_tracks, bool)

    # ---------------- init pair: most inlier-rich two-view geometry -------
    ranked = sorted(pair_matches.items(), key=lambda kv: -len(kv[1]))
    init_pair = None
    for (i, j), m in ranked[:10]:
        if len(m) < max(min_init_matches, 8):
            continue
        xy1 = _normalize(keypoints[i][m[:, 0]], K[i])
        xy2 = _normalize(keypoints[j][m[:, 1]], K[j])
        E, inl = essential_ransac(xy1, xy2, seed=seed)
        if inl.sum() < max(min_init_matches // 2, 8):
            continue
        R, t = decompose_essential(E, xy1[inl], xy2[inl])
        # parallax check: median triangulation angle of init points
        z1, z2 = _triangulate_two_view(np.eye(3), np.zeros(3), R, t,
                                       xy1[inl], xy2[inl])
        front = (z1 > 0) & (z2 > 0)
        if front.sum() < max(min_init_matches // 2, 8):
            continue
        init_pair = (i, j)
        w2c[i] = np.eye(4)
        w2c[j][:3, :3] = R
        w2c[j][:3, 3] = t
        registered[i] = registered[j] = True
        break
    if init_pair is None:
        raise ValueError("no initializable image pair "
                         "(need >= %d matches with parallax)"
                         % min_init_matches)
    if verbose:
        print(f"init pair {init_pair}")

    def retriangulate():
        """Re-solve all tracks from currently registered views."""
        reg_obs = registered[tracks.image_idx]
        sub = Tracks(tracks.track_ids[reg_obs], tracks.image_idx[reg_obs],
                     tracks.kp_idx[reg_obs], tracks.num_tracks)
        xyz, ok = triangulate_tracks(
            sub, keypoints, w2c, K, max_reproj_px=reproj_filter_px,
            min_tri_angle_deg=1.0)
        points[ok] = xyz[ok]
        valid[:] = ok

    def run_ba(iters):
        reg_ids = np.nonzero(registered)[0]
        remap = -np.ones(n, np.int64)
        remap[reg_ids] = np.arange(len(reg_ids))
        use = registered[tracks.image_idx] & valid[tracks.track_ids]
        if use.sum() < 16:
            return
        pt_ids = np.unique(tracks.track_ids[use])
        pt_remap = -np.ones(tracks.num_tracks, np.int64)
        pt_remap[pt_ids] = np.arange(len(pt_ids))
        obs_xy = np.stack([keypoints[i][k] for i, k in
                           zip(tracks.image_idx[use], tracks.kp_idx[use])])
        fixed = np.zeros(len(reg_ids), bool)
        fixed[remap[init_pair[0]]] = True
        w2c_new, pts_new, c0, c1 = bundle_adjust_np(
            w2c[reg_ids], K[reg_ids], points[pt_ids],
            remap[tracks.image_idx[use]], pt_remap[tracks.track_ids[use]],
            obs_xy, fixed_cams=fixed, iters=iters,
            huber_px=reproj_filter_px, device=device)
        w2c[reg_ids] = w2c_new
        points[pt_ids] = pts_new
        if verbose:
            print(f"  BA over {len(reg_ids)} cams / {len(pt_ids)} pts: "
                  f"{c0:.1f} -> {c1:.1f}")

    retriangulate()
    n_since_ba = 0

    # ---------------- registration loop -----------------------------------
    while True:
        # candidate = unregistered image with most valid-track observations
        counts = np.zeros(n, np.int64)
        sel = (~registered[tracks.image_idx]) & valid[tracks.track_ids]
        np.add.at(counts, tracks.image_idx[sel], 1)
        counts[registered] = 0
        cand = int(np.argmax(counts))
        if counts[cand] < min_reg_points:
            break

        obs = sel & (tracks.image_idx == cand)
        p2d = keypoints[cand][tracks.kp_idx[obs]]
        p3d = points[tracks.track_ids[obs]]
        res = pnp_ransac(p2d, p3d, K[cand], max_error_px=pnp_max_error_px,
                         seed=seed)
        if not res.success or res.num_inliers < min_reg_points:
            # unregisterable: drop its observations so the candidate loop
            # cannot pick it again (matches COLMAP's skip-on-failure)
            drop = tracks.image_idx == cand
            tracks = Tracks(tracks.track_ids[~drop], tracks.image_idx[~drop],
                            tracks.kp_idx[~drop], tracks.num_tracks)
            continue
        w2c[cand] = np.eye(4)
        w2c[cand][:3, :3] = quat_to_rotmat(
            torch.tensor(np.asarray(res.qvec, np.float32))).numpy()
        w2c[cand][:3, 3] = res.tvec
        registered[cand] = True
        n_since_ba += 1
        if verbose:
            print(f"registered image {cand} ({res.num_inliers} inliers)")

        retriangulate()
        if n_since_ba >= ba_every:
            run_ba(ba_iters)
            retriangulate()
            n_since_ba = 0

    run_ba(final_ba_iters)
    retriangulate()
    return Reconstruction(w2c=w2c, registered=registered, points=points,
                          valid=valid, tracks=tracks, init_pair=init_pair)
