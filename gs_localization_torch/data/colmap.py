"""COLMAP model I/O (text + binary), written from the format spec:
cameras, images (poses + 2D points), points3D, in both .txt and .bin
encodings. Host-only numpy, the same readers and writer as the JAX
package's ``data/colmap.py``.

COLMAP conventions: image pose is world-to-camera as (qvec wxyz, tvec);
R = quat_to_rotmat(qvec) is the w2c rotation.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
MODEL_NUM_PARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            return float(self.params[0])
        return float(self.params[1])

    @property
    def cx(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            return float(self.params[1])
        return float(self.params[2])

    @property
    def cy(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            return float(self.params[2])
        return float(self.params[3])


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray          # (4,) wxyz
    tvec: np.ndarray          # (3,)
    camera_id: int
    name: str
    xys: np.ndarray           # (N, 2)
    point3d_ids: np.ndarray   # (N,)

    def rotmat(self) -> np.ndarray:
        """(3, 3) float32 w2c rotation (the port's ``quat_to_rotmat`` on
        the CPU)."""
        import torch

        from ..core.camera import quat_to_rotmat
        q = torch.tensor(np.asarray(self.qvec, np.float32))
        return quat_to_rotmat(q).numpy()


class ColmapPoint3D(NamedTuple):
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


# ---------------------------------------------------------------- binary ----
def _read_next_bytes(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            cid, mid, w, h = _read_next_bytes(f, 24, "iiQQ")
            name, nparams = CAMERA_MODELS[mid]
            params = np.array(_read_next_bytes(f, 8 * nparams, "d" * nparams))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            vals = _read_next_bytes(f, 64, "idddddddi")
            iid = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cam_id = vals[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read_next_bytes(f, 8, "Q")
            data = _read_next_bytes(f, 24 * npts, "ddq" * npts)
            xys = np.array(data).reshape(npts, 3)[:, :2] if npts else np.zeros((0, 2))
            ids = (np.array(data).reshape(npts, 3)[:, 2].astype(np.int64)
                   if npts else np.zeros((0,), np.int64))
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode("utf-8"), xys, ids)
    return images


def read_points3d_binary(path) -> Dict[int, ColmapPoint3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            vals = _read_next_bytes(f, 43, "QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7], np.uint8)
            err = vals[7]
            (tl,) = _read_next_bytes(f, 8, "Q")
            tdata = _read_next_bytes(f, 8 * tl, "ii" * tl)
            arr = np.array(tdata).reshape(tl, 2) if tl else np.zeros((0, 2), int)
            pts[pid] = ColmapPoint3D(pid, xyz, rgb, err, arr[:, 0], arr[:, 1])
    return pts


# ------------------------------------------------------------------ text ----
def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        t = line.split()
        cams[int(t[0])] = ColmapCamera(
            int(t[0]), t[1], int(t[2]), int(t[3]),
            np.array([float(v) for v in t[4:]]),
        )
    return cams


def read_images_text(path) -> Dict[int, ColmapImage]:
    images = {}
    # pose and 2D-point lines strictly alternate; a points line may be EMPTY,
    # so only comment lines are filtered (not blank ones) before pairing
    lines = [l.strip() for l in open(path) if not l.lstrip().startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        t = lines[i].split()
        iid = int(t[0])
        qvec = np.array([float(v) for v in t[1:5]])
        tvec = np.array([float(v) for v in t[5:8]])
        cam_id = int(t[8])
        name = t[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        n = len(pts) // 3
        xys = np.array([[float(pts[3 * j]), float(pts[3 * j + 1])]
                        for j in range(n)]) if n else np.zeros((0, 2))
        ids = np.array([int(pts[3 * j + 2]) for j in range(n)], np.int64) \
            if n else np.zeros((0,), np.int64)
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, ids)
    return images


def read_points3d_text(path) -> Dict[int, ColmapPoint3D]:
    pts = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        t = line.split()
        pid = int(t[0])
        xyz = np.array([float(v) for v in t[1:4]])
        rgb = np.array([int(v) for v in t[4:7]], np.uint8)
        err = float(t[7])
        track = t[8:]
        n = len(track) // 2
        img_ids = np.array([int(track[2 * j]) for j in range(n)])
        p2d = np.array([int(track[2 * j + 1]) for j in range(n)])
        pts[pid] = ColmapPoint3D(pid, xyz, rgb, err, img_ids, p2d)
    return pts


def read_colmap_model(path: str):
    """Auto-detect .bin/.txt model in ``path``; returns (cameras, images, points)."""
    if os.path.exists(os.path.join(path, "cameras.bin")):
        return (
            read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3d_binary(os.path.join(path, "points3D.bin")),
        )
    return (
        read_cameras_text(os.path.join(path, "cameras.txt")),
        read_images_text(os.path.join(path, "images.txt")),
        read_points3d_text(os.path.join(path, "points3D.txt")),
    )


def write_colmap_model_text(path: str, cameras, images, points) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for c in cameras.values():
            params = " ".join(repr(float(p)) for p in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {params}\n")
    with open(os.path.join(path, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            row = " ".join(
                f"{im.xys[j, 0]} {im.xys[j, 1]} {im.point3d_ids[j]}"
                for j in range(im.xys.shape[0])
            )
            f.write(row + "\n")
    with open(os.path.join(path, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        for p in points.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(
                f"{int(p.image_ids[j])} {int(p.point2d_idxs[j])}"
                for j in range(len(p.image_ids))
            )
            f.write(f"{p.id} {xyz} {rgb} {p.error} {track}\n")
