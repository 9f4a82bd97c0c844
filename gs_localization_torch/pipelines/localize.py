"""Localization pipeline: trained map + init poses -> refined poses + metrics.

Load the map PLY (``load_map``); per query, build the edge/keypoint mask,
run the Adam + SE(3)-retraction refinement, and report the median /
threshold-recall pose metrics. Queries run in batches of ``batch_size``; a
batch whose renders were truncated by a binning capacity is redone with
every capacity doubled.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import Camera, w2c_from_quat_t
from ..core.gaussians import GaussianParams
from ..data.ply import load_gaussian_ply
from ..loc import TrackingConfig, refine_poses_batch
from ..ops.image import compute_grad_mask, keypoint_box_mask
from ..raster import RasterizerConfig
from ..sfm.evaluate import pose_errors, summarize_errors
from ..utils.profiling import count, host_read, note, span, upload


@dataclass
class LocalizePipelineConfig:
    batch_size: int = 8
    edge_threshold: float = 1.1
    keypoint_box: int = 10
    keypoint_score_min: float = 0.2
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    use_keypoint_mask: bool = True
    # binning-capacity overflow policy: on a truncated render, double the
    # capacities and redo the batch up to this many times; 0 = fail loudly
    max_capacity_growths: int = 2


@dataclass
class QuerySpec:
    name: str
    camera: Camera                     # intrinsics + INIT pose (w2c)
    image: np.ndarray                  # (H, W, 3)
    depth: Optional[np.ndarray] = None
    keypoints: Optional[np.ndarray] = None   # (N, 2) px
    gt_w2c: Optional[np.ndarray] = None      # (4, 4)


def build_mask(image: np.ndarray, cfg: LocalizePipelineConfig,
               keypoints: Optional[np.ndarray],
               device="cuda") -> torch.Tensor:
    """Edge mask of the query image, OR the keypoint boxes, on ``device``."""
    device = resolve_device(device)
    img = upload(image, device)
    mask = compute_grad_mask(img, cfg.edge_threshold)
    if cfg.use_keypoint_mask and keypoints is not None and len(keypoints):
        h, w = image.shape[:2]
        kp = upload(keypoints, device)
        mask = mask | keypoint_box_mask(kp, w, h, cfg.keypoint_box)
    return mask


def _localize_batch(gaussians: GaussianParams, batch: List[QuerySpec],
                    cfg: LocalizePipelineConfig,
                    raster_cfg: RasterizerConfig,
                    log_fn: Callable[[str], None]):
    """Upload, refine and audit one batch -> (the capacities it ended at,
    its refined w2c poses (B, 4, 4) on the host)."""
    dev = gaussians.device
    with span("localize/upload"):
        cams = [q.camera for q in batch]
        imgs = torch.stack([upload(q.image, dev) for q in batch])
        masks = torch.stack([build_mask(q.image, cfg, q.keypoints, dev)
                             for q in batch])
        deps = None
        if not cfg.tracking.monocular:
            deps = torch.stack([
                upload(q.depth if q.depth is not None
                        else np.zeros(q.image.shape[:2], np.float32), dev)
                for q in batch])
    grows = 0
    while True:
        with span("localize/refine"):
            note(max_pairs=raster_cfg.max_pairs,
                 max_per_tile=raster_cfg.max_per_tile,
                 max_render=raster_cfg.max_render)
            res = refine_poses_batch(gaussians, cams, imgs, masks,
                                     cfg.tracking, raster_cfg,
                                     gt_depths=deps)
        with span("localize/audit"):
            if not host_read("loc_overflow", res.overflow.any()):
                count("host_sync/pose_download")
                return raster_cfg, res.w2c.detach().cpu().numpy()
        # capacity audit: a truncated render silently biases the refined
        # pose, so grow every capacity and redo the batch
        if grows >= cfg.max_capacity_growths:
            raise RuntimeError(
                f"binning overflow persists at max_pairs="
                f"{raster_cfg.max_pairs} max_per_tile="
                f"{raster_cfg.max_per_tile} after {grows} growths")
        raster_cfg = raster_cfg.replace(
            max_pairs=2 * raster_cfg.max_pairs,
            max_per_tile=2 * raster_cfg.max_per_tile,
            max_render=2 * (raster_cfg.max_render or raster_cfg.max_pairs))
        grows += 1
        count("capacity_growths")
        log_fn(f"binning overflow: growing max_pairs to "
               f"{raster_cfg.max_pairs} / max_per_tile to "
               f"{raster_cfg.max_per_tile} / max_render to "
               f"{raster_cfg.max_render}")


def localize_queries(
    gaussians: GaussianParams,
    queries: Sequence[QuerySpec],
    cfg: LocalizePipelineConfig = LocalizePipelineConfig(),
    raster_cfg: RasterizerConfig = RasterizerConfig(),
    log_fn: Callable[[str], None] = print,
) -> Tuple[Dict[str, np.ndarray], Optional[dict]]:
    """Refine all queries on the map's device. Returns ({name: w2c 4x4},
    metrics|None)."""
    results: Dict[str, np.ndarray] = {}
    errs_t: List[float] = []
    errs_r: List[float] = []

    b = cfg.batch_size
    n = len(queries)
    for lo in range(0, n, b):
        batch = list(queries[lo:lo + b])
        with span("localize/batch", unit=",".join(q.name for q in batch)):
            note(queries=len(batch))
            raster_cfg, w2cs = _localize_batch(gaussians, batch, cfg,
                                               raster_cfg, log_fn)
        for j, q in enumerate(batch):
            results[q.name] = w2cs[j]
            if q.gt_w2c is not None:
                et, er = pose_errors(w2cs[j, :3, :3], w2cs[j, :3, 3],
                                     q.gt_w2c[:3, :3], q.gt_w2c[:3, 3])
                errs_t.append(float(et))
                errs_r.append(float(er))
        log_fn(f"localized {min(lo + b, n)}/{n}")

    metrics = None
    if errs_t:
        metrics = summarize_errors(np.array(errs_t), np.array(errs_r))
        log_fn(
            f"median err: {metrics['median_trans_m']*100:.2f} cm / "
            f"{metrics['median_rot_deg']:.3f} deg over {len(errs_t)} queries")
    return results, metrics


def load_map(path: str, capacity: Optional[int] = None,
             device="cuda") -> GaussianParams:
    """Load a trained map PLY onto ``device``."""
    return load_gaussian_ply(path, capacity=capacity, device=device)


def init_camera_from_results(name: str, results_path_poses: Dict[str, tuple],
                             fx, fy, cx, cy, width: int, height: int,
                             device="cuda") -> Camera:
    """The camera of query ``name`` at its pose in a results file's poses
    (``sfm.io.read_pose_results``), on ``device``."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    q, t = results_path_poses[name]
    return Camera(w2c=w2c_from_quat_t(f32(q), f32(t)), fx=f32(fx),
                  fy=f32(fy), cx=f32(cx), cy=f32(cy), width=int(width),
                  height=int(height))
