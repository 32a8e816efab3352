"""Compact COLMAP sparse-model reader (binary format).

A copy of ``hashmodnffbanks_idr_tpu/data/colmap/read_model.py``, the
counterpart of the reference's vendored LLFF reader
(data/preprocess_custom_data_colmap_Neus/colmap_preprocess/colmap_read_model.py):
reads cameras / images / points3D from a COLMAP sparse reconstruction.  Only
the fields the camera pipeline needs are kept.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# COLMAP camera model id -> (name, #params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def K(self) -> np.ndarray:
        k = np.eye(3)
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model.startswith("SIMPLE_RADIAL") \
           or self.model == "RADIAL" or self.model == "FOV":
            k[0, 0] = k[1, 1] = p[0]
            k[0, 2], k[1, 2] = p[1], p[2]
        else:  # PINHOLE / OPENCV-family: fx fy cx cy ...
            k[0, 0], k[1, 1], k[0, 2], k[1, 2] = p[0], p[1], p[2], p[3]
        return k


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str

    def R(self) -> np.ndarray:
        w, x, y, z = self.qvec
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            out[cid] = Camera(cid, name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            q = np.array(_read(f, "<4d"))
            t = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            f.read(24 * n2d)  # skip 2D points (x, y, point3D_id)
            out[iid] = Image(iid, q, t, cam_id, name.decode())
    return out


def read_points3d_bin(path: str) -> np.ndarray:
    pts = []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            _read(f, "<Q")  # id
            xyz = _read(f, "<3d")
            f.read(3)       # rgb
            _read(f, "<d")  # error
            (tl,) = _read(f, "<Q")
            f.read(8 * tl)  # track
            pts.append(xyz)
    return np.array(pts)


def read_model(sparse_dir: str) -> Tuple[Dict[int, Camera], Dict[int, Image], np.ndarray]:
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    p3d_path = os.path.join(sparse_dir, "points3D.bin")
    pts = read_points3d_bin(p3d_path) if os.path.exists(p3d_path) else np.zeros((0, 3))
    return cams, imgs, pts
