"""COLMAP SQLite database interop.

Port of onepose_tpu/data/colmap_database.py, whole (numpy and the standard library).

Lets users validate our SfM artifacts with stock COLMAP tooling (the
reference drives `colmap matches_importer` / `point_triangulator` from
such a database, src/sfm/triangulation.py:38-119; schema + pair-id
encoding per src/utils/colmap/database.py:113-228 and the public COLMAP
database format). We never *run* COLMAP — triangulation is on-device —
but exporting features/matches keeps the artifact boundary inspectable.
"""

from __future__ import annotations

import sqlite3
from typing import Optional

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB);
"""


def pair_id_from_images(image_id1: int, image_id2: int) -> int:
    """COLMAP's symmetric pair encoding (database.py:113-118)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def images_from_pair_id(pair_id: int) -> tuple[int, int]:
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


def _blob(arr: np.ndarray, dtype) -> bytes:
    return np.ascontiguousarray(arr, dtype).tobytes()


class ColmapDatabase:
    """Thin writer/reader over the COLMAP schema."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    def close(self) -> None:
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add_camera(
        self,
        model: int,
        width: int,
        height: int,
        params: np.ndarray,
        camera_id: Optional[int] = None,
        prior_focal_length: bool = True,
    ) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                camera_id,
                model,
                width,
                height,
                _blob(params, np.float64),
                int(prior_focal_length),
            ),
        )
        return cur.lastrowid

    def add_image(
        self,
        name: str,
        camera_id: int,
        qvec: np.ndarray = None,
        tvec: np.ndarray = None,
        image_id: Optional[int] = None,
    ) -> int:
        q = [None] * 4 if qvec is None else list(map(float, qvec))
        t = [None] * 3 if tvec is None else list(map(float, tvec))
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *q, *t),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        """keypoints: [N, 2] pixel xy. COLMAP keypoints are stored with a
        +0.5 px center-of-pixel offset (the reference applies it on
        import, src/sfm/triangulation.py:70)."""
        kp = np.asarray(keypoints, np.float32) + 0.5
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1], _blob(kp, np.float32)),
        )

    def add_descriptors(self, image_id: int, desc: np.ndarray) -> None:
        d = np.asarray(desc)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, d.shape[0], d.shape[1], _blob(d, np.uint8)),
        )

    def add_matches(
        self, image_id1: int, image_id2: int, matches: np.ndarray
    ) -> None:
        """matches: [M, 2] index pairs (kpt in image1, kpt in image2)."""
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (
                pair_id_from_images(image_id1, image_id2),
                m.shape[0],
                m.shape[1],
                _blob(m, np.uint32),
            ),
        )

    def add_two_view_geometry(
        self,
        image_id1: int,
        image_id2: int,
        matches: np.ndarray,
        config: int = 2,
    ) -> None:
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        eye = _blob(np.eye(3), np.float64)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                pair_id_from_images(image_id1, image_id2),
                m.shape[0],
                m.shape[1],
                _blob(m, np.uint32),
                config,
                eye,
                eye,
                eye,
                _blob(np.array([1.0, 0, 0, 0]), np.float64),
                _blob(np.zeros(3), np.float64),
            ),
        )

    def read_keypoints(self, image_id: int) -> np.ndarray:
        rows, cols, data = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,),
        ).fetchone()
        return np.frombuffer(data, np.float32).reshape(rows, cols)

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (pair_id_from_images(image_id1, image_id2),),
        ).fetchone()
        if row is None:
            return np.zeros((0, 2), np.uint32)
        rows, cols, data = row
        m = np.frombuffer(data, np.uint32).reshape(rows, cols)
        return m[:, ::-1] if image_id1 > image_id2 else m


def export_sequence_to_db(
    db_path: str,
    feats: dict,
    pair_matches: dict,
    image_hw: tuple[int, int],
) -> int:
    """Write extracted features + pair matches to a COLMAP database.

    feats: extract_sequence_features output (keypoints [F, N, 2],
    mask [F, N], K [F, 3, 3], image_paths). pair_matches: {(i, j):
    [M, 2] index arrays}. Returns the number of images written.
    """
    import os.path as osp

    h, w = image_hw
    with ColmapDatabase(db_path) as db:
        image_ids = []
        for f, path in enumerate(feats["image_paths"]):
            K = np.asarray(feats["K"][f], np.float64)
            cam = db.add_camera(
                1, w, h, np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
            )  # PINHOLE-style fx fy cx cy
            img_id = db.add_image(osp.basename(path), cam)
            mask = np.asarray(feats["mask"][f])
            db.add_keypoints(img_id, np.asarray(feats["keypoints"][f])[mask])
            image_ids.append(img_id)
        for (i, j), m in pair_matches.items():
            db.add_matches(image_ids[i], image_ids[j], m)
            db.add_two_view_geometry(image_ids[i], image_ids[j], m)
    return len(image_ids)
