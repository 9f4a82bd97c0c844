"""COLMAP sqlite database writer/reader (stdlib ``sqlite3``).

The standard schema (cameras, images, keypoints, descriptors, matches,
two_view_geometries) with the ``pair_id = 2147483647 * id1 + id2``
convention, so that COLMAP tooling consumes features and matches written
here and the other way round. The blobs are those of the JAX package's
writer byte for byte: float64 camera params, float32 keypoints (+0.5 to
COLMAP's pixel-corner origin), uint8 descriptors, uint32 match pairs.
"""

from __future__ import annotations

import sqlite3
from typing import Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
"""

CAMERA_MODEL_IDS = {
    "SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2, "RADIAL": 3,
    "OPENCV": 4,
}


def pair_id_from_images(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * MAX_IMAGE_ID + id2


def images_from_pair_id(pair_id: int) -> Tuple[int, int]:
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


def _pairs(id1: int, id2: int, matches: np.ndarray) -> np.ndarray:
    """(N, 2) uint32 match indices in the pair's (smaller id, larger id)
    column order."""
    m = np.asarray(matches, np.uint32)
    return np.ascontiguousarray(m[:, ::-1] if id1 > id2 else m)


class ColmapDatabase:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    def add_camera(self, model: str, width: int, height: int,
                   params: np.ndarray, camera_id: Optional[int] = None,
                   prior_focal: bool = True) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, CAMERA_MODEL_IDS[model], width, height,
             np.asarray(params, np.float64).tobytes(), int(prior_focal)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  qvec=(1.0, 0, 0, 0), tvec=(0.0, 0, 0),
                  image_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *map(float, qvec),
             *map(float, tvec)))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        # COLMAP's origin is the pixel corner: +0.5
        kp = np.asarray(keypoints, np.float32) + 0.5
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1], kp.tobytes()))

    def add_descriptors(self, image_id: int, desc: np.ndarray) -> None:
        d = np.ascontiguousarray(desc, np.uint8)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, d.shape[0], d.shape[1], d.tobytes()))

    def add_matches(self, id1: int, id2: int, matches: np.ndarray) -> None:
        m = _pairs(id1, id2, matches)
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pair_id_from_images(id1, id2), m.shape[0], 2, m.tobytes()))

    def add_two_view_geometry(self, id1: int, id2: int, matches: np.ndarray,
                              config: int = 3) -> None:
        m = _pairs(id1, id2, matches)
        eye = np.eye(3).tobytes()
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pair_id_from_images(id1, id2), m.shape[0], 2, m.tobytes(),
             config, eye, eye, eye, np.zeros(4).tobytes(),
             np.zeros(3).tobytes()))

    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,)).fetchone()
        return np.frombuffer(row[2], np.float32).reshape(row[0], row[1]) - 0.5

    def read_matches(self, id1: int, id2: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, data FROM matches WHERE pair_id=?",
            (pair_id_from_images(id1, id2),)).fetchone()
        m = np.frombuffer(row[1], np.uint32).reshape(row[0], 2)
        return m[:, ::-1] if id1 > id2 else m

    def commit(self) -> None:
        self.conn.commit()

    def close(self) -> None:
        self.conn.commit()
        self.conn.close()
