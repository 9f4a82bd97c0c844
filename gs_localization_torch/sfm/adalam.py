"""AdaLAM: adaptive locally-affine match filtering, built natively.

Fills the role of hloc's AdaLAM conf (hloc/matchers/adalam.py,
which wraps kornia.feature.adalam.AdalamFilter). Rather than bind kornia we
implement the algorithm (Cavalli et al., "AdaLAM: Revisiting Handcrafted
Outlier Detection", ECCV 2020) directly:

1. candidate correspondences: mutual-NN with Lowe ratio (scores = 1 - ratio);
2. seed selection: candidates that are local maxima of the ratio score
   within radius R1 in image0 (spatially well-distributed confident seeds);
3. neighborhoods: a candidate is assigned to a seed if it lies within
   ``search_expansion * R1`` of the seed in image0 AND within
   ``search_expansion * R2`` of the seed's match in image1, with optional
   orientation-difference / scale-rate consistency gates vs the seed
   (when the extractor provides scales/orientations, e.g. SIFT);
4. verification: per seed, ``ransac_iters`` similarity hypotheses from
   2-correspondence samples, scored by adaptive significance
   (inliers vs the count a uniform outlier field would produce at the same
   residual threshold); optional least-squares affine refit on the inliers
   of the best hypothesis (``refit``);
5. output: the union over accepted seeds of inlier candidates.

Everything is vectorized numpy over (seed, iter, candidate) blocks — this is
host-side SfM orchestration (like RANSAC/PnP), a copy of the JAX package's
``sfm/adalam.py``.

R1 = sqrt(area0 / (pi * area_ratio)), R2 likewise for image1, matching the
kornia parameterization (area_ratio=100, search_expansion=4, ransac_iters=128,
min_inliers=6, min_confidence=200, orientation_difference_threshold=30,
scale_rate_threshold=1.5).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdalamConfig:
    area_ratio: float = 100.0
    search_expansion: float = 4.0
    ransac_iters: int = 128
    min_inliers: int = 6
    min_confidence: float = 200.0
    orientation_difference_threshold: float = 30.0   # degrees
    scale_rate_threshold: float = 1.5
    refit: bool = True
    ratio_thresh: float = 0.99    # candidate generation (loose; filter does
                                  # the real outlier rejection)
    inlier_quantum: float = 0.02  # residual thresholds tested, as fractions
                                  # of the expanded R2 (adaptive sweep)
    seed: int = 0


class AdalamResult(NamedTuple):
    matches0: np.ndarray    # (K0,) index into kpts1, -1 = rejected
    scores: np.ndarray      # (K0,) candidate NN score where kept, else 0


def _candidates(desc0, desc1, valid0, valid1, ratio_thresh):
    """Mutual-NN + ratio candidates on L2-normalized descriptors (numpy)."""
    sim = desc0 @ desc1.T
    sim[~valid0] = -np.inf
    sim[:, ~valid1] = -np.inf
    best01 = np.argmax(sim, 1)
    best10 = np.argmax(sim, 0)
    k0 = desc0.shape[0]
    s_best = sim[np.arange(k0), best01]
    sim[np.arange(k0), best01] = -np.inf
    s_second = np.max(sim, 1)
    d1 = np.sqrt(np.maximum(2.0 - 2.0 * s_best, 0.0))
    d2 = np.sqrt(np.maximum(2.0 - 2.0 * s_second, 1e-12))
    ratio = d1 / d2
    ok = (best10[best01] == np.arange(k0)) & (ratio < ratio_thresh) \
        & np.isfinite(s_best)
    return best01, ok, 1.0 - ratio, s_best


def _pairwise_dist(p: np.ndarray) -> np.ndarray:
    """(M, 2) -> (M, M) Euclidean distances, f32 matmul form (the naive
    (M, M, 2) f64 broadcast allocates ~400 MB at 5k candidates)."""
    p = np.asarray(p, np.float32)
    sq = np.sum(p * p, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (p @ p.T)
    return np.sqrt(np.maximum(d2, 0.0))


def _similarity_from_pairs(p0a, p0b, p1a, p1b):
    """Similarity transform (scale+rot+t) mapping (p0a,p0b) -> (p1a,p1b).

    Complex-number form: z1 = a * z0 + b with a, b complex. Batched.
    """
    z0a = p0a[..., 0] + 1j * p0a[..., 1]
    z0b = p0b[..., 0] + 1j * p0b[..., 1]
    z1a = p1a[..., 0] + 1j * p1a[..., 1]
    z1b = p1b[..., 0] + 1j * p1b[..., 1]
    dz0 = z0b - z0a
    bad = np.abs(dz0) < 1e-6
    a = np.where(bad, 1.0, (z1b - z1a) / np.where(bad, 1.0, dz0))
    b = z1a - a * z0a
    return a, b, bad


def adalam_filter(
    kpts0: np.ndarray, kpts1: np.ndarray,
    matches0: np.ndarray, match_scores: np.ndarray,
    shape0, shape1,
    scales0: Optional[np.ndarray] = None,
    scales1: Optional[np.ndarray] = None,
    oris0: Optional[np.ndarray] = None,
    oris1: Optional[np.ndarray] = None,
    config: AdalamConfig = AdalamConfig(),
) -> np.ndarray:
    """Filter candidate matches; returns matches0 with outliers set to -1.

    ``matches0``: (K0,) candidate NN matches (-1 = none); ``match_scores``
    their confidence (higher = better; used for seed NMS).
    """
    kpts0 = np.asarray(kpts0, np.float64)
    kpts1 = np.asarray(kpts1, np.float64)
    matches0 = np.asarray(matches0).copy()
    cand = np.nonzero(matches0 >= 0)[0]
    if cand.size < max(4, config.min_inliers):
        return np.full_like(matches0, -1)

    w0, h0 = float(shape0[0]), float(shape0[1])
    w1, h1 = float(shape1[0]), float(shape1[1])
    r1 = np.sqrt(w0 * h0 / (np.pi * config.area_ratio))
    r2 = np.sqrt(w1 * h1 / (np.pi * config.area_ratio))
    er1 = config.search_expansion * r1
    er2 = config.search_expansion * r2

    p0 = kpts0[cand]                          # (M, 2)
    p1 = kpts1[matches0[cand]]                # (M, 2)
    sc = np.asarray(match_scores, np.float64)[cand]
    m = cand.size

    # --- seed selection: score local maxima within r1 in image0 ------------
    d0 = _pairwise_dist(p0)                                   # (M, M) f32
    near = d0 <= r1
    is_max = np.all(sc[:, None] >= np.where(near, sc[None, :], -np.inf), 1)
    seeds = np.nonzero(is_max)[0]
    if seeds.size == 0:
        return np.full_like(matches0, -1)

    # --- neighborhood assignment -------------------------------------------
    d1 = _pairwise_dist(p1)
    nbr = (d0[seeds] <= er1) & (d1[seeds] <= er2)             # (S, M)

    if scales0 is not None and scales1 is not None:
        srate = (np.asarray(scales1, np.float64)[matches0[cand]]
                 / np.maximum(np.asarray(scales0, np.float64)[cand], 1e-9))
        rel = srate[None, :] / np.maximum(srate[seeds][:, None], 1e-9)
        nbr &= ((rel < config.scale_rate_threshold)
                & (rel > 1.0 / config.scale_rate_threshold))
    if oris0 is not None and oris1 is not None:
        dori = (np.asarray(oris1, np.float64)[matches0[cand]]
                - np.asarray(oris0, np.float64)[cand])
        rel = (dori[None, :] - dori[seeds][:, None] + 180.0) % 360.0 - 180.0
        nbr &= np.abs(rel) < config.orientation_difference_threshold

    nbr[np.arange(seeds.size), seeds] = True   # seed always in its own hood
    counts = nbr.sum(1)
    live = counts >= max(2, config.min_inliers)
    seeds, nbr, counts = seeds[live], nbr[live], counts[live]
    if seeds.size == 0:
        return np.full_like(matches0, -1)
    s = seeds.size

    # --- per-seed similarity RANSAC with adaptive significance -------------
    rng = np.random.default_rng(config.seed)
    it = config.ransac_iters
    # sample 2 candidate indices per (seed, iter), biased to the hood by
    # drawing ranks into each hood's member list (uniform over members).
    members = [np.nonzero(row)[0] for row in nbr]
    idx_a = np.empty((s, it), np.int64)
    idx_b = np.empty((s, it), np.int64)
    for si, mem in enumerate(members):
        ia = rng.integers(0, mem.size, it)
        ib = (ia + 1 + rng.integers(0, mem.size - 1, it)) % mem.size
        idx_a[si], idx_b[si] = mem[ia], mem[ib]

    a, b, degen = _similarity_from_pairs(p0[idx_a], p0[idx_b],
                                         p1[idx_a], p1[idx_b])  # (S, it)
    # degenerate (coincident image0 sample) / wild-scale hypotheses out
    mag = np.abs(a)
    good_h = (mag > 1.0 / 8.0) & (mag < 8.0) & ~degen

    z0 = p0[:, 0] + 1j * p0[:, 1]
    z1 = p1[:, 0] + 1j * p1[:, 1]
    # residuals of every candidate under every hypothesis, masked to hoods.
    # (S, it, M) complex — block over seeds to bound memory.
    best_inl = np.zeros((s, cand.size), bool)
    best_sig = np.zeros(s)
    thr_fracs = np.asarray([config.inlier_quantum * (k + 1)
                            for k in range(8)])            # 0.02R..0.16R
    blk = max(1, int(2e7 // (it * cand.size)))
    for lo in range(0, s, blk):
        hi = min(lo + blk, s)
        res = np.abs(a[lo:hi, :, None] * z0[None, None, :]
                     + b[lo:hi, :, None] - z1[None, None, :])   # (B, it, M)
        hood = nbr[lo:hi, None, :]
        n_hood = counts[lo:hi][:, None, None]
        sig_best = np.zeros(hi - lo)
        inl_best = np.zeros((hi - lo, cand.size), bool)
        for f in thr_fracs:
            t = f * er2
            inl = hood & (res <= t)
            k = inl.sum(-1)                                  # (B, it)
            k = np.where(good_h[lo:hi], k, 0)
            # expected inliers for uniform outliers in the image1 disk
            p_rand = min((t / er2) ** 2, 1.0)
            sig = k / np.maximum(n_hood[..., 0] * p_rand, 1e-9)
            sig = np.where(k >= config.min_inliers, sig, 0.0)
            bi = np.argmax(sig, 1)                           # (B,)
            sb = sig[np.arange(hi - lo), bi]
            upd = sb > sig_best
            sig_best = np.where(upd, sb, sig_best)
            inl_best[upd] = inl[np.arange(hi - lo), bi][upd]
        best_sig[lo:hi] = sig_best
        best_inl[lo:hi] = inl_best

    accept = best_sig >= config.min_confidence

    if config.refit and accept.any():
        # least-squares affine refit on each accepted seed's inliers, then
        # re-select inliers at the second-tightest threshold (0.04 * er2 —
        # the affine fit tightens the model, but the strictest quantum
        # rejects true inliers under noise).
        t = thr_fracs[1] * er2
        for si in np.nonzero(accept)[0]:
            inl = np.nonzero(best_inl[si])[0]
            if inl.size < 3:
                continue
            A = np.concatenate([
                np.stack([p0[inl, 0], p0[inl, 1], np.ones(inl.size),
                          np.zeros(inl.size), np.zeros(inl.size),
                          np.zeros(inl.size)], 1),
                np.stack([np.zeros(inl.size), np.zeros(inl.size),
                          np.zeros(inl.size), p0[inl, 0], p0[inl, 1],
                          np.ones(inl.size)], 1)])
            y = np.concatenate([p1[inl, 0], p1[inl, 1]])
            coef, *_ = np.linalg.lstsq(A, y, rcond=None)
            pred = np.stack([p0[:, 0] * coef[0] + p0[:, 1] * coef[1]
                             + coef[2],
                             p0[:, 0] * coef[3] + p0[:, 1] * coef[4]
                             + coef[5]], 1)
            res = np.linalg.norm(pred - p1, axis=1)
            refit_inl = nbr[si] & (res <= t)
            if refit_inl.sum() >= config.min_inliers:
                best_inl[si] = refit_inl

    keep_cand = best_inl[accept].any(0) if accept.any() \
        else np.zeros(cand.size, bool)
    out = np.full_like(matches0, -1)
    out[cand[keep_cand]] = matches0[cand[keep_cand]]
    return out


def adalam_match(feats0, feats1, shape0, shape1,
                 config: AdalamConfig = AdalamConfig()) -> AdalamResult:
    """Candidate generation + AdaLAM filtering for two Features tuples.

    ``feats0/1`` (the port's ``Features``, tensors on any device, or numpy
    arrays) need .keypoints, .descriptors, .scores (validity); SIFT-style
    extractors may also carry .scales / .orientations (radians — converted to
    the degree convention of the gates here) which tighten the neighborhood
    gates (reference required_inputs adalam.py:22-33; sfm/sift.py exports
    both).
    """

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return None if x is None else np.asarray(x)

    def deg(x):
        return None if x is None else np.degrees(host(x))

    desc0 = np.asarray(host(feats0.descriptors), np.float64)
    desc1 = np.asarray(host(feats1.descriptors), np.float64)
    valid0 = host(feats0.scores) > 0
    valid1 = host(feats1.scores) > 0
    best01, ok, ratio_score, s_best = _candidates(
        desc0, desc1, valid0, valid1, config.ratio_thresh)
    matches0 = np.where(ok, best01, -1)
    kept = adalam_filter(
        host(feats0.keypoints), host(feats1.keypoints),
        matches0, ratio_score, shape0, shape1,
        scales0=host(getattr(feats0, "scales", None)),
        scales1=host(getattr(feats1, "scales", None)),
        oris0=deg(getattr(feats0, "orientations", None)),
        oris1=deg(getattr(feats1, "orientations", None)),
        config=config)
    return AdalamResult(
        matches0=kept,
        scores=np.where(kept >= 0, s_best, 0.0).astype(np.float32))
