"""Per-dataset configuration presets, with the JAX package's field values.

The reference encodes these as per-dataset scripts; here they are data:

- 7-Scenes (RGB-D): tracking <=50 Adam iters @ lr 1e-3, converge 1e-4,
  RGBD loss with depth weight 1-alpha = 0.01, opacity threshold 0.99, edge
  threshold 1.1 (pipelines/7scenes_localize_full_dslam.py:33-66, 297,
  323-324); map training sh_degree 3 (implicit), 30k iters.
- Cambridge (RGB): tracking <=20 iters @ lr 1e-4, converge 1e-3, monocular
  loss, per-query PINHOLE intrinsics (pipelines/cambridge_localize_full.py:
  36-87, 199-234); map training sh_degree 1, pseudo-depth weight 0.005
  (gs/cambridge_gs_full.py:134-165, 332).
"""

from __future__ import annotations

from ..loc import TrackingConfig
from ..mapping import MapTrainConfig
from .localize import LocalizePipelineConfig
from .train_map import TrainPipelineConfig


def seven_scenes_tracking() -> TrackingConfig:
    # pose_mode + rebin_every=10 is the product default, with converged
    # accuracy equal to the exact per-iteration path (SH colour frozen at
    # the rebin view). Escape hatch:
    # cfg.tracking = replace(pose_mode=False, rebin_every=1).
    return TrackingConfig(
        num_iters=50, lr=1e-3, convergence=1e-4,
        opacity_threshold=0.99, alpha=0.99, monocular=False,
        pose_mode=True, rebin_every=10,
    )


def cambridge_tracking() -> TrackingConfig:
    return TrackingConfig(
        num_iters=20, lr=1e-4, convergence=1e-3,
        opacity_threshold=0.99, monocular=True,
        pose_mode=True, rebin_every=10,
    )


def seven_scenes_localize() -> LocalizePipelineConfig:
    return LocalizePipelineConfig(
        edge_threshold=1.1, keypoint_box=10, keypoint_score_min=0.2,
        tracking=seven_scenes_tracking(),
    )


def cambridge_localize() -> LocalizePipelineConfig:
    return LocalizePipelineConfig(
        edge_threshold=1.1, keypoint_box=10, keypoint_score_min=0.2,
        tracking=cambridge_tracking(),
    )


def seven_scenes_training() -> TrainPipelineConfig:
    return TrainPipelineConfig(iterations=30_000, sh_degree=3)


def seven_scenes_training_too_large() -> TrainPipelineConfig:
    """office/redkitchen-style scenes (reference training_too_large,
    gs/7scenes_gs_full_dslam.py:250-277): 3000-camera working set swapped
    once at iteration 11900."""
    return TrainPipelineConfig(iterations=30_000, sh_degree=3,
                               max_cameras=3000,
                               camera_swap_iteration=11_900)


def cambridge_training() -> TrainPipelineConfig:
    return TrainPipelineConfig(iterations=30_000, sh_degree=1)


def seven_scenes_map_cfg(extent: float) -> MapTrainConfig:
    return MapTrainConfig(spatial_scale=extent, lambda_gt_depth=0.05,
                          lambda_pseudo_depth=0.01)


def cambridge_map_cfg(extent: float) -> MapTrainConfig:
    return MapTrainConfig(spatial_scale=extent, lambda_gt_depth=0.0,
                          lambda_pseudo_depth=0.005)


def mip360_tracking() -> TrackingConfig:
    """360/LLFF: 50 iters @ lr 1e-3, converge 1e-4, monocular
    (reference pipelines/360_localize.py:36-67,89,296)."""
    return TrackingConfig(
        num_iters=50, lr=1e-3, convergence=1e-4,
        opacity_threshold=0.99, monocular=True,
        pose_mode=True, rebin_every=10,
    )


def mip360_localize() -> LocalizePipelineConfig:
    return LocalizePipelineConfig(
        edge_threshold=1.1, keypoint_box=10, keypoint_score_min=0.2,
        tracking=mip360_tracking(),
    )


def mip360_training() -> TrainPipelineConfig:
    """sh_degree 1 (reference gs/360_gs.py:334, llff variants ditto)."""
    return TrainPipelineConfig(iterations=30_000, sh_degree=1)


def mip360_map_cfg(extent: float) -> MapTrainConfig:
    return MapTrainConfig(spatial_scale=extent, lambda_gt_depth=0.0,
                          lambda_pseudo_depth=0.005)
