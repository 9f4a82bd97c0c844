"""Scene assembly: COLMAP model -> cameras, init point cloud, extent.

- extent = 1.1 * the largest distance of a camera centre from their
  centroid (NeRF++-style normalization);
- train/test split by ``llffhold`` (every 8th view) when ``eval_split``
  is on, or by name lists;
- the model's points3D and their RGB as the Gaussian init cloud;
- ``load_image`` / ``load_depth`` read the pixels on the host (PIL or cv2).

``CameraInfo.camera`` is the port's ``Camera`` on the device the scene is
loaded for.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import Camera, w2c_from_quat_t
from .colmap import ColmapCamera, ColmapImage, read_colmap_model


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


def camera_from_colmap(cam: ColmapCamera, im: ColmapImage,
                       device="cuda") -> Camera:
    """The port's Camera of a COLMAP camera and image pose, on ``device``."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return Camera(w2c=w2c_from_quat_t(f32(im.qvec), f32(im.tvec)),
                  fx=f32(cam.fx), fy=f32(cam.fy), cx=f32(cam.cx),
                  cy=f32(cam.cy), width=int(cam.width),
                  height=int(cam.height))


def load_colmap_scene(
    model_path: str,
    images_dir: Optional[str] = None,
    depths_dir: Optional[str] = None,
    eval_split: bool = False,
    llffhold: int = 8,
    train_list: Optional[List[str]] = None,
    test_list: Optional[List[str]] = None,
    device="cuda",
) -> SceneInfo:
    """A COLMAP model as a SceneInfo whose cameras live on ``device``.

    Images are taken in image-id order; a depth map pairs with its image by
    the name rewrite color -> depth. Name lists, when given, select the
    split (an image in neither list trains only when ``train_list`` is
    empty); else ``eval_split`` holds out every ``llffhold``-th image."""
    dev = resolve_device(device)
    cameras, images, points = read_colmap_model(model_path)

    infos: List[CameraInfo] = []
    centers = []
    for iid in sorted(images.keys()):
        im = images[iid]
        cam = camera_from_colmap(cameras[im.camera_id], im, dev)
        img_path = os.path.join(images_dir, im.name) if images_dir else None
        dep_path = None
        if depths_dir:
            dep_name = im.name.replace("color", "depth")
            dep_path = os.path.join(depths_dir, dep_name)
        infos.append(CameraInfo(uid=iid, name=im.name, camera=cam,
                                image_path=img_path, depth_path=dep_path))
        centers.append(cam.campos.cpu().numpy())
    extent = compute_scene_extent(np.stack(centers)) if centers else 1.0

    if train_list is not None or test_list is not None:
        train_set = set(train_list or [])
        test_set = set(test_list or [])
        train = [c for c in infos if c.name in train_set or
                 (not train_set and c.name not in test_set)]
        test = [c for c in infos if c.name in test_set]
    elif eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    if points:
        pids = sorted(points.keys())
        xyz = np.stack([points[p].xyz for p in pids]).astype(np.float32)
        rgb = np.stack([points[p].rgb for p in pids]).astype(
            np.float32) / 255.0
    else:
        xyz = np.zeros((0, 3), np.float32)
        rgb = np.zeros((0, 3), np.float32)

    return SceneInfo(train_cameras=train, test_cameras=test,
                     points=xyz, colors=rgb, extent=extent)


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
