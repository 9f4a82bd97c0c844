"""Dense-match aggregation: quantize semi-dense matches into shared keypoints.

Dense matchers (LoFTR, sfm/loftr.py) emit an independent set of sub-pixel
correspondences per image PAIR; triangulation and PnP need a single keypoint
list per IMAGE with pairwise matches indexing into it. This module is the
port's counterpart of hloc's match_dense aggregation
(hloc/match_dense.py:74-436):

- each dense endpoint is snapped to a quantization cell of pitch
  ``max(cell_size, max_error)`` (to_cpts, match_dense.py:67-70); one shared
  keypoint per cell per image;
- within a cell, endpoints vote (score-weighted) over finer bins of pitch
  ``max_error``; the winning bin becomes the cell's final keypoint position
  (match_dense.py:408-413) — so the output keypoint is a mode, not a mean;
- per pair, endpoint->cell assignments become (id0, id1) matches; n-to-1
  collisions keep only the highest-scoring match per keypoint on both sides
  (get_unique_matches, match_dense.py:124-133);
- images with externally fixed keypoints (e.g. SuperPoint anchors or a
  localization query) are assigned by nearest-neighbor within ``max_error``
  instead of being extended (assign_keypoints update=False branch,
  match_dense.py:84-91);
- optional ``max_kps`` keeps the top-scoring keypoints per image and
  re-assigns all raw matches against the kept set (assign_matches,
  match_dense.py:436-463).

Everything is host-side numpy, as the reference keeps it on the CPU around
its matcher network: a copy of the JAX package's ``sfm/match_dense.py``.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def quantize(kpts: np.ndarray, pitch: float) -> np.ndarray:
    """Snap keypoints to cell centers at the given pitch (COLMAP +0.5 pixel
    origin convention, reference to_cpts match_dense.py:67-70)."""
    if pitch > 0.0:
        return np.round(np.round((kpts + 0.5) / pitch) * pitch - 0.5, 2)
    return kpts


def assign_to_fixed(kpts: np.ndarray, ref_kpts: np.ndarray,
                    max_error: float) -> np.ndarray:
    """NN-assign endpoints to an externally fixed keypoint set; -1 beyond
    ``max_error`` (reference assign_keypoints update=False branch)."""
    if len(ref_kpts) == 0 or len(kpts) == 0:
        return np.full(len(kpts), -1, np.int64)
    dist, ids = cKDTree(np.asarray(ref_kpts)).query(kpts)
    ids = ids.astype(np.int64)
    ids[dist > max_error] = -1
    return ids


class _ImageAgg:
    """Growing cell set + per-cell fine-bin vote counters for one image."""

    def __init__(self) -> None:
        self.cell_to_id: Dict[Tuple[float, float], int] = {}
        self.bins: List[Counter] = []

    def assign(self, kpts: np.ndarray, scores: np.ndarray,
               max_error: float, cell_size: float) -> np.ndarray:
        pitch = max(cell_size, max_error)
        cells = quantize(kpts, pitch)
        fine = quantize(kpts, float(int(max_error)))
        ids = np.empty(len(kpts), np.int64)
        for i in range(len(kpts)):
            key = (cells[i, 0], cells[i, 1])
            kid = self.cell_to_id.get(key)
            if kid is None:
                kid = len(self.cell_to_id)
                self.cell_to_id[key] = kid
                self.bins.append(Counter())
            self.bins[kid][(fine[i, 0], fine[i, 1])] += float(scores[i])
            ids[i] = kid
        return ids

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (keypoints (K, 2): winning fine bin per cell, scores (K,))."""
        if not self.bins:
            return np.zeros((0, 2), np.float32), np.zeros((0,), np.float32)
        pts = np.array([c.most_common(1)[0][0] for c in self.bins],
                       np.float32)
        scr = np.array([c.most_common(1)[0][1] for c in self.bins],
                       np.float32)
        return pts, scr


def unique_matches(ids0: np.ndarray, ids1: np.ndarray, scores: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop invalid and n-to-1 matches, keeping the best-scoring edge per
    keypoint on each side (reference get_unique_matches)."""
    valid = (ids0 >= 0) & (ids1 >= 0)
    ids0, ids1, scores = ids0[valid], ids1[valid], scores[valid]
    if len(ids0) == 0:
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.float32)

    def best_per_group(ids):
        order = np.lexsort((-scores, ids))
        first = np.ones(len(order), bool)
        first[1:] = ids[order[1:]] != ids[order[:-1]]
        return set(order[first].tolist())

    keep = sorted(best_per_group(ids0) & best_per_group(ids1))
    keep = np.array(keep, np.int64)
    return np.stack([ids0[keep], ids1[keep]], 1), scores[keep]


class DenseAggregation(Dict):
    pass


def aggregate_dense_matches(
    dense: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    max_error: float = 1.0,
    cell_size: float = 1.0,
    fixed_keypoints: Optional[Dict[str, np.ndarray]] = None,
    max_kps: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
           Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]]]:
    """dense[(name0, name1)] = (kpts0 (M,2), kpts1 (M,2), scores (M,)).

    Returns (keypoints per image, keypoint scores per image,
    matches per pair as ((M',2) index pairs, (M',) scores)).

    Images present in ``fixed_keypoints`` keep their given keypoints and get
    NN assignment; all others accumulate quantized cells across every pair
    they appear in, then finalize to the per-cell winning bin. With
    ``max_kps`` the keypoints are truncated to the top-k by accumulated vote
    score and the raw dense matches re-assigned against the kept set.
    """
    fixed = dict(fixed_keypoints or {})
    aggs: Dict[str, _ImageAgg] = defaultdict(_ImageAgg)
    raw_ids: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]] = {}

    for (n0, n1), (k0, k1, sc) in dense.items():
        k0 = np.asarray(k0, np.float64).reshape(-1, 2)
        k1 = np.asarray(k1, np.float64).reshape(-1, 2)
        sc = np.asarray(sc, np.float64).reshape(-1)
        live = sc > 0.0               # dead padded slots from the matcher
        k0, k1, sc = k0[live], k1[live], sc[live]
        if n0 in fixed:
            ids0 = assign_to_fixed(k0, fixed[n0], max_error)
        else:
            ids0 = aggs[n0].assign(k0, sc, max_error, cell_size)
        if n1 in fixed:
            ids1 = assign_to_fixed(k1, fixed[n1], max_error)
        else:
            ids1 = aggs[n1].assign(k1, sc, max_error, cell_size)
        raw_ids[(n0, n1)] = (k0, k1, sc, ids0, ids1)

    keypoints: Dict[str, np.ndarray] = {}
    kp_scores: Dict[str, np.ndarray] = {}
    for name, agg in aggs.items():
        pts, scr = agg.finalize()
        if max_kps is not None and len(pts) > max_kps:
            top = np.argsort(-scr)[:max_kps]
            pts, scr = pts[top], scr[top]
        keypoints[name] = pts
        kp_scores[name] = scr
    for name, pts in fixed.items():
        keypoints[name] = np.asarray(pts, np.float32)
        kp_scores[name] = np.ones(len(pts), np.float32)

    truncated = max_kps is not None
    matches: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]] = {}
    for (n0, n1), (k0, k1, sc, ids0, ids1) in raw_ids.items():
        if truncated:
            # keypoint ids changed under truncation: re-assign raw
            # endpoints against the final keypoints (assign_matches,
            # match_dense.py:436-463)
            ids0 = assign_to_fixed(k0, keypoints[n0], max_error)
            ids1 = assign_to_fixed(k1, keypoints[n1], max_error)
        m, s = unique_matches(ids0, ids1, sc)
        matches[(n0, n1)] = (m, s.astype(np.float32))
    return keypoints, kp_scores, matches


def matches_to_matches0(matches: np.ndarray, scores: np.ndarray,
                        num_kpts0: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(M, 2) index pairs -> hloc matches0 layout: per-keypoint0 partner
    index (-1 unmatched) + score (match_dense.py:136-145)."""
    matches0 = np.full(num_kpts0, -1, np.int32)
    scores0 = np.zeros(num_kpts0, np.float16)
    if len(matches):
        matches0[matches[:, 0]] = matches[:, 1]
        scores0[matches[:, 0]] = scores
    return matches0, scores0
