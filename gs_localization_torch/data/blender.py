"""Blender / NeRF-synthetic scene reader (``transforms_{train,test}.json``).

c2w matrices with the OpenGL -> COLMAP flip (negate the Y and Z columns),
fx = fy from ``camera_angle_x``, the principal point at the image centre,
white-background RGBA handling left to the image loader, and a random
initial point cloud in the [-1.3, 1.3]^3 box (numpy ``default_rng(seed)``),
as the JAX package's reader.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from .. import resolve_device
from ..core.camera import Camera, fov2focal
from .scene import CameraInfo, SceneInfo, compute_scene_extent


def _read_split(path: str, json_name: str, width: int, height: int,
                device) -> List[CameraInfo]:
    with open(os.path.join(path, json_name)) as f:
        meta = json.load(f)
    fx = fov2focal(float(meta["camera_angle_x"]), width)
    infos = []
    for i, frame in enumerate(meta["frames"]):
        c2w = np.array(frame["transform_matrix"], np.float64)
        # OpenGL camera (-Z forward, +Y up) -> COLMAP-style (+Z forward)
        c2w[:3, 1:3] *= -1
        cam = Camera.from_numpy(np.linalg.inv(c2w), fx, fx, width / 2,
                                height / 2, width, height, device=device)
        name = frame["file_path"]
        img_path = os.path.join(path, name if name.endswith(".png")
                                else name + ".png")
        infos.append(CameraInfo(uid=i, name=os.path.basename(name),
                                camera=cam, image_path=img_path))
    return infos


def load_blender_scene(path: str, width: int = 800, height: int = 800,
                       num_init_points: int = 100_000, seed: int = 0,
                       device="cuda") -> SceneInfo:
    """A NeRF-synthetic scene whose cameras live on ``device``; the test
    split's uids follow the training split's."""
    dev = resolve_device(device)
    train = _read_split(path, "transforms_train.json", width, height, dev)
    test = []
    if os.path.exists(os.path.join(path, "transforms_test.json")):
        test = _read_split(path, "transforms_test.json", width, height, dev)
        for j, t in enumerate(test):
            t.uid = len(train) + j

    centers = np.stack([c.camera.campos.cpu().numpy() for c in train])
    extent = compute_scene_extent(centers)

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (num_init_points, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (num_init_points, 3)).astype(np.float32)
    return SceneInfo(train_cameras=train, test_cameras=test,
                     points=pts, colors=cols, extent=extent)
