"""COLMAP sparse-reconstruction readers (binary + text, pure Python).

A copy of the pure-Python reader path of reduced3dgs_tpu/data/colmap.py
(the port does not load the native IO library).  Parses cameras, images
and points3D per the public COLMAP on-disk format: pinhole-family
intrinsics, world-to-camera quaternion + translation extrinsics, and the
sparse point cloud with colours.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# model_id -> (name, num_params); COLMAP camera model table
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


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w,x,y,z world->camera rotation
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec2rotmat(qvec):
    """Quaternion (w,x,y,z) -> rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y],
    ])


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path):
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            f.seek(24 * npts, os.SEEK_CUR)  # skip 2D points (x, y, p3d_id)
            imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                    name.decode("utf-8"))
    return imgs


def read_points3d_binary(path):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n, np.float64)
        for i in range(n):
            _read(f, "<Q")  # point id
            xyz[i] = _read(f, "<3d")
            rgb[i] = _read(f, "<3B")
            err[i] = _read(f, "<d")[0]
            (tl,) = _read(f, "<Q")
            f.seek(8 * tl, os.SEEK_CUR)  # track elements
    return xyz, rgb, err


def read_cameras_text(path):
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            model = parts[1]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            cams[cid] = ColmapCamera(cid, model, w, h, params)
    return cams


def read_images_text(path):
    imgs = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for meta in lines[0::2]:  # every other line is the 2D point list
        parts = meta.split()
        iid = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id, parts[9])
    return imgs


def read_points3d_text(path):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(p) for p in parts[1:4]])
            rgbs.append([int(p) for p in parts[4:7]])
            errs.append(float(parts[7]))
    return (np.array(xyzs), np.array(rgbs, np.uint8), np.array(errs))
