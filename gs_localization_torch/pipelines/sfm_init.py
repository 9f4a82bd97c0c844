"""SfM + PnP initialization pipeline (native end-to-end), on the port.

The reference's stage 2: build a point model of the train images with KNOWN
gt poses, then produce rough init poses for test images via retrieval +
PnP-RANSAC, writing a results file the localization stage reads. This
pipeline chains:

  features (Harris by default) -> sequential+retrieval pairs
  -> mutual-NN matching -> track building -> known-pose DLT triangulation
  [-> RGB-D depth correction] -> per-query retrieval -> 2D-3D PnP-RANSAC
  [-> fallback: top-retrieved train pose, hloc/localize_sfm.py:203-205]

Each image goes to ``device`` once, as a float32 (H, W, 3) tensor, and the
feature extractor, global descriptor and matching run there; keypoints and
matches come back to the host for track building, triangulation and PnP
(host numpy, as in the JAX package's ``pipelines/sfm_init.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import Camera, rotmat_to_quat
from ..sfm.features import (
    Features, extract_harris_features, rgb_to_gray, tiny_image_descriptor,
)
from ..sfm.matching import match_mutual_nn
from ..sfm.pairs import pairs_sequential
from ..sfm.pnp import pnp_ransac
from ..sfm.retrieval import top_k_retrieval
from ..sfm.triangulate import (
    Tracks, build_tracks, correct_points_with_depth,
    epipolar_filter_matches, triangulate_tracks,
)


@dataclass
class SfmInitConfig:
    num_keypoints: int = 1024
    match_window: int = 8           # sequential pair window for mapping
    retrieval_k: int = 10
    ratio_thresh: float = 0.95
    max_reproj_px: float = 4.0
    max_epipolar_px: float = 4.0    # pre-track geometric verification
    pnp_max_error_px: float = 12.0  # reference RANSAC default
    min_pnp_inliers: int = 12
    depth_correct: bool = True
    # dense (LoFTR-style) matching: quantization pitches of the keypoint
    # aggregation (reference match_dense.py confs 'loftr': max_error=1,
    # cell_size=1; 'loftr_aachen': 2/8)
    dense_max_error: float = 1.0
    dense_cell_size: float = 1.0
    dense_max_kps: Optional[int] = None


@dataclass
class MappedScene:
    points: np.ndarray              # (T, 3)
    valid: np.ndarray               # (T,)
    tracks: Tracks
    features: List[Features]        # on the device
    global_descs: np.ndarray        # (N, D)
    track_colors: Optional[np.ndarray] = None


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _K_of(cam: Camera) -> np.ndarray:
    return np.array([
        [float(cam.fx), 0, float(cam.cx)],
        [0, float(cam.fy), float(cam.cy)],
        [0, 0, 1.0],
    ])


def _default_frontend(cfg, extractor, global_desc_fn):
    if extractor is None:
        extractor = lambda img: extract_harris_features(  # noqa: E731
            rgb_to_gray(img), num_keypoints=cfg.num_keypoints)
    if global_desc_fn is None:
        global_desc_fn = tiny_image_descriptor
    return extractor, global_desc_fn


def _on(img, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(img, np.float32), device=dev)


def _match(qf: Features, f: Features, cfg, sparse_matcher) -> np.ndarray:
    if sparse_matcher is not None:
        return _host(sparse_matcher(qf, f).matches0)
    return _host(match_mutual_nn(qf.descriptors, f.descriptors,
                                 qf.scores > 0, f.scores > 0,
                                 ratio_thresh=cfg.ratio_thresh).matches0)


def build_point_model(
    images: Sequence[np.ndarray],          # (H, W, 3) train images
    cameras: Sequence[Camera],             # gt poses
    cfg: SfmInitConfig = SfmInitConfig(),
    depth_maps: Optional[Sequence[np.ndarray]] = None,
    extractor: Optional[Callable] = None,
    global_desc_fn: Optional[Callable] = None,
    dense_matcher: Optional[Callable] = None,
    sparse_matcher: Optional[Callable] = None,
    log_fn: Callable[[str], None] = print,
    device="cuda",
) -> MappedScene:
    """``extractor(img) -> Features`` and ``global_desc_fn(img) -> (D,)``
    take the image as a float32 (H, W, 3) tensor on ``device``; the defaults
    are Harris on its grayscale and the tiny-image descriptor.

    ``dense_matcher(img0, img1) -> (kpts0 (M,2), kpts1 (M,2), scores (M,))``
    (numpy images, as given; arrays or tensors back, e.g. the registry's
    ``get_dense_matcher("loftr", params=net)``) switches mapping to the
    dense path (reference match_dense.py 'loftr' conf family): per-pair
    semi-dense correspondences are quantized into shared per-image
    keypoints (sfm/match_dense.py) before track building.

    ``sparse_matcher(feats0, feats1) -> result with .matches0`` replaces
    the mutual-NN descriptor matching with a learned matcher, e.g. the
    registry's ``get_matcher("superglue", params=sg)`` with the image size
    bound (``pipelines/run_scene.py --weights-dir``)."""
    dev = resolve_device(device)
    n = len(images)
    extractor, global_desc_fn = _default_frontend(cfg, extractor,
                                                  global_desc_fn)
    on_dev = [_on(img, dev) for img in images]
    gdesc = np.stack([_host(global_desc_fn(img)) for img in on_dev])

    names = list(range(n))
    pair_idx = [(a, b) for a, b in pairs_sequential(names, cfg.match_window)]
    # add retrieval pairs for loop closure
    ridx, _ = top_k_retrieval(gdesc, gdesc, min(cfg.retrieval_k, n - 1),
                              [str(i) for i in names],
                              [str(i) for i in names], device=dev)
    for i in range(n):
        for j in ridx[i]:
            a, b = min(i, int(j)), max(i, int(j))
            if a != b and (a, b) not in pair_idx:
                pair_idx.append((a, b))

    pair_matches: Dict[Tuple[int, int], np.ndarray] = {}
    if dense_matcher is not None:
        from ..sfm.match_dense import aggregate_dense_matches

        dense = {}
        for (a, b) in pair_idx:
            k0, k1, sc = dense_matcher(images[a], images[b])
            dense[(a, b)] = (_host(k0), _host(k1), _host(sc))
        kp_of, kp_scores, dmatches = aggregate_dense_matches(
            dense, max_error=cfg.dense_max_error,
            cell_size=cfg.dense_cell_size, max_kps=cfg.dense_max_kps)
        empty2 = np.zeros((0, 2), np.float32)
        feats = [
            Features(
                keypoints=torch.as_tensor(kp_of.get(i, empty2), device=dev),
                scores=torch.as_tensor(
                    kp_scores.get(i, np.zeros((0,), np.float32)), device=dev),
                descriptors=torch.zeros((len(kp_of.get(i, empty2)), 0),
                                        device=dev),
            )
            for i in names
        ]
        for (a, b), (m, _s) in dmatches.items():
            if len(m) >= 8:
                pair_matches[(a, b)] = m
        log_fn(f"dense-matched {len(pair_matches)} pairs; "
               f"{sum(len(f.keypoints) for f in feats)} aggregated keypoints")
    else:
        feats = [extractor(img) for img in on_dev]
        log_fn(f"extracted features for {n} mapping images")
        for (a, b) in pair_idx:
            mi = _match(feats[a], feats[b], cfg, sparse_matcher)
            ok = mi >= 0
            if ok.sum() < 8:
                continue
            pair_matches[(a, b)] = np.stack(
                [np.nonzero(ok)[0], mi[ok]], axis=1)
        log_fn(f"matched {len(pair_matches)} pairs")

    kps = [_host(f.keypoints) for f in feats]
    counts = [k.shape[0] for k in kps]
    w2c = np.stack([_host(c.w2c) for c in cameras])
    Ks = np.stack([_K_of(c) for c in cameras])
    # geometric verification against the known poses BEFORE track building
    # (reference hloc/triangulation.py:128-190): outlier matches otherwise
    # transitively merge keypoints into giant union-find tracks
    n_before = sum(len(m) for m in pair_matches.values())
    pair_matches = {
        (a, b): epipolar_filter_matches(
            m, kps[a], kps[b], w2c[a], w2c[b], Ks[a], Ks[b],
            max_epip_px=cfg.max_epipolar_px)
        for (a, b), m in pair_matches.items()
    }
    pair_matches = {k: m for k, m in pair_matches.items() if len(m) >= 8}
    n_after = sum(len(m) for m in pair_matches.values())
    log_fn(f"geometric verification kept {n_after}/{n_before} matches")
    tracks = build_tracks(n, counts, pair_matches)
    xyz, valid = triangulate_tracks(
        tracks, kps, w2c, Ks, max_reproj_px=cfg.max_reproj_px)
    log_fn(f"triangulated {int(valid.sum())}/{tracks.num_tracks} tracks")

    if cfg.depth_correct and depth_maps is not None:
        xyz, has_depth = correct_points_with_depth(
            xyz, tracks, w2c, Ks, depth_maps)
        valid = valid & has_depth
        log_fn(f"depth-corrected; {int(valid.sum())} points remain")

    # per-track color (mean of observing pixels)
    colors = np.zeros((tracks.num_tracks, 3))
    wsum = np.zeros(tracks.num_tracks)
    for e in range(len(tracks.track_ids)):
        i, k = tracks.image_idx[e], tracks.kp_idx[e]
        xy = kps[i][k].astype(int)
        h, w = images[i].shape[:2]
        if 0 <= xy[0] < w and 0 <= xy[1] < h:
            colors[tracks.track_ids[e]] += images[i][xy[1], xy[0]]
            wsum[tracks.track_ids[e]] += 1
    colors[wsum > 0] /= wsum[wsum > 0, None]

    return MappedScene(points=xyz, valid=valid, tracks=tracks,
                       features=feats, global_descs=gdesc,
                       track_colors=colors)


def _pnp_or_fallback(pts2d, pts3d, query_K, train_cameras, retrieved, cfg,
                     seed, info):
    if len(pts2d) >= 6:
        res = pnp_ransac(np.asarray(pts2d), np.asarray(pts3d), query_K,
                         max_error_px=cfg.pnp_max_error_px, seed=seed,
                         min_inliers=cfg.min_pnp_inliers)
        info["num_inliers"] = res.num_inliers
        if res.success and res.num_inliers >= cfg.min_pnp_inliers:
            info["method"] = "pnp"
            return res.qvec, res.tvec, info

    # fallback: top retrieved pose
    w2c = _host(train_cameras[retrieved[0]].w2c)
    info["method"] = "retrieval_fallback"
    return rotmat_to_quat(w2c[:3, :3]), w2c[:3, 3], info


def localize_query_pnp(
    query_image: np.ndarray,
    query_K: np.ndarray,
    mapped: MappedScene,
    train_cameras: Sequence[Camera],
    cfg: SfmInitConfig = SfmInitConfig(),
    extractor: Optional[Callable] = None,
    global_desc_fn: Optional[Callable] = None,
    sparse_matcher: Optional[Callable] = None,
    seed: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Initial pose for one query: retrieval -> 2D-3D matches -> PnP.

    Returns (qvec wxyz, tvec, info). Falls back to the top-retrieved train
    camera's pose when PnP fails (the reference's fallback). Pass the same
    ``extractor`` / ``global_desc_fn`` (and ``device``) used for the point
    model, and the same ``sparse_matcher``.
    """
    dev = resolve_device(device)
    extractor, global_desc_fn = _default_frontend(cfg, extractor,
                                                  global_desc_fn)
    img = _on(query_image, dev)
    qf = extractor(img)
    qg = _host(global_desc_fn(img))[None]
    ridx, _ = top_k_retrieval(qg, mapped.global_descs,
                              min(cfg.retrieval_k, len(train_cameras)),
                              device=dev)
    retrieved = [int(j) for j in ridx[0]]

    # gather 2D-3D correspondences via retrieved images, dedup per 3D id
    # (hloc/localize_sfm.py pose_from_cluster semantics)
    obs_of = {}
    for e in range(len(mapped.tracks.track_ids)):
        obs_of.setdefault(mapped.tracks.image_idx[e], []).append(e)
    qkp = _host(qf.keypoints)
    pts2d, pts3d, seen = [], [], {}
    for j in retrieved:
        if j not in obs_of:
            continue
        mi = _match(qf, mapped.features[j], cfg, sparse_matcher)
        # kp index in j -> track id
        kp_to_track = {}
        for e in obs_of[j]:
            kp_to_track[int(mapped.tracks.kp_idx[e])] = \
                int(mapped.tracks.track_ids[e])
        for qi in np.nonzero(mi >= 0)[0]:
            tid = kp_to_track.get(int(mi[qi]))
            if tid is None or not mapped.valid[tid]:
                continue
            if tid in seen:
                continue
            seen[tid] = True
            pts2d.append(qkp[qi])
            pts3d.append(mapped.points[tid])

    info = {"num_matches": len(pts2d), "retrieved": retrieved}
    return _pnp_or_fallback(pts2d, pts3d, query_K, train_cameras, retrieved,
                            cfg, seed, info)


def localize_query_dense(
    query_image: np.ndarray,
    query_K: np.ndarray,
    mapped: MappedScene,
    train_cameras: Sequence[Camera],
    dense_matcher: Callable,
    train_images: Sequence[np.ndarray],
    cfg: SfmInitConfig = SfmInitConfig(),
    global_desc_fn: Optional[Callable] = None,
    seed: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """PnP init via dense matching against retrieved train images.

    The dense analog of ``localize_query_pnp``, mirroring the reference's
    localization special case (match_dense.py:373-377: the query is name0
    and its endpoints stay UNQUANTIZED — raw sub-pixel positions feed PnP;
    only the train-side endpoints are NN-assigned to the map's aggregated
    keypoints, which link to 3D tracks).
    """
    from ..sfm.match_dense import assign_to_fixed

    dev = resolve_device(device)
    if global_desc_fn is None:
        global_desc_fn = tiny_image_descriptor
    qg = _host(global_desc_fn(_on(query_image, dev)))[None]
    ridx, _ = top_k_retrieval(qg, mapped.global_descs,
                              min(cfg.retrieval_k, len(train_cameras)),
                              device=dev)
    retrieved = [int(j) for j in ridx[0]]

    obs_of = {}
    for e in range(len(mapped.tracks.track_ids)):
        obs_of.setdefault(int(mapped.tracks.image_idx[e]), []).append(e)

    pts2d, pts3d, seen = [], [], set()
    for j in retrieved:
        if j not in obs_of:
            continue
        k_q, k_j, sc = dense_matcher(query_image, train_images[j])
        k_q = _host(k_q).astype(np.float64).reshape(-1, 2)
        k_j = _host(k_j).astype(np.float64).reshape(-1, 2)
        sc = _host(sc).astype(np.float64).reshape(-1)
        live = sc > 0
        k_q, k_j = k_q[live], k_j[live]
        ids_j = assign_to_fixed(k_j, _host(mapped.features[j].keypoints),
                                max(cfg.dense_max_error, 1.0))
        kp_to_track = {
            int(mapped.tracks.kp_idx[e]): int(mapped.tracks.track_ids[e])
            for e in obs_of[j]
        }
        for qi in np.nonzero(ids_j >= 0)[0]:
            tid = kp_to_track.get(int(ids_j[qi]))
            if tid is None or not mapped.valid[tid] or tid in seen:
                continue
            seen.add(tid)
            pts2d.append(k_q[qi])
            pts3d.append(mapped.points[tid])

    info = {"num_matches": len(pts2d), "retrieved": retrieved}
    return _pnp_or_fallback(pts2d, pts3d, query_K, train_cameras, retrieved,
                            cfg, seed, info)
