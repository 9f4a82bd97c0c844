"""Scenes for map training: cameras, the init point cloud, the extent.

- extent = 1.1 * the largest distance of a camera centre from their
  centroid (NeRF++-style normalization);
- ``load_image`` / ``load_depth`` read the pixels on the host (PIL or cv2).

``CameraInfo.camera`` is the port's ``Camera`` on the training device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.camera import Camera


@dataclass
class CameraInfo:
    uid: int
    name: str
    camera: Camera            # pose + intrinsics on the training device
    image_path: Optional[str] = None
    depth_path: Optional[str] = None


@dataclass
class SceneInfo:
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    points: np.ndarray        # (P, 3)
    colors: np.ndarray        # (P, 3) in [0, 1]
    extent: float = 1.0


def compute_scene_extent(cam_centers: np.ndarray) -> float:
    """1.1 * max distance from the camera-centre centroid."""
    center = cam_centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=1)
    return float(dist.max() * 1.1)


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0,1]. Uses PIL or cv2, whichever is present."""
    try:
        from PIL import Image
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.float32) / 255.0
    except ImportError:
        pass
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def load_depth(path: str, scale: float = 1000.0) -> np.ndarray:
    """(H, W) float32 depth in meters (16-bit millimetre PNGs); the
    invalid-depth sentinel 65535 reads as 0."""
    try:
        from PIL import Image
        with Image.open(path) as im:
            arr = np.asarray(im, np.float32)
    except ImportError:
        import cv2
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32)
    arr = arr / scale
    arr[arr >= 65.0] = 0.0
    return arr
