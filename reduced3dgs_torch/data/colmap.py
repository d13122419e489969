"""COLMAP sparse-reconstruction readers (binary + text).

Counterpart of reduced3dgs_tpu/data/colmap.py.  Parses cameras, images
and points3D per the public COLMAP on-disk format: pinhole-family
intrinsics, world-to-camera quaternion + translation extrinsics, and the
sparse point cloud with colours.

``images.bin`` and ``points3D.bin`` are read by the repository's native
parser (native/colmap_io.cpp, a plain C interface) where it can be built:
``native_lib`` compiles it with g++ (native/build.py's flags) into
``reduced3dgs_torch/_build/`` on first use (the committed
native/libr3dgs_io.so is neither read nor written) and loads it with
ctypes.  Without g++ or the source, the pure-Python path reads them.  The
first call prints one line saying which path was taken.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from dataclasses import dataclass
from pathlib import Path

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


NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "colmap_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_ENTRY_POINTS = ("colmap_count_points3d", "colmap_read_points3d",
                 "colmap_count_images", "colmap_read_images")
_NAME_CAP = 512  # bytes per image name in colmap_read_images' buffer
_NATIVE = NotImplemented  # not tried yet; then a ctypes.CDLL or None


def native_library_path() -> Path:
    """Where the native parser's build lands: named by a hash of the
    source and the flags, so an edited source builds anew."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode() + b"\0"
                     + NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libr3dgs_io-{h.hexdigest()[:12]}.so"


def native_lib():
    """ctypes handle to the native parser, built on first use; None when
    it cannot be built or loaded (the pure-Python path then reads)."""
    global _NATIVE
    if _NATIVE is not NotImplemented:
        return _NATIVE
    _NATIVE = None
    try:
        lib_path = native_library_path()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(NATIVE_SRC), "-o",
                            str(tmp)], check=True, capture_output=True,
                           text=True, timeout=120)
            os.replace(tmp, lib_path)  # atomic: a concurrent build is fine
        lib = ctypes.CDLL(str(lib_path))
        for fn in _ENTRY_POINTS:
            getattr(lib, fn).restype = ctypes.c_longlong
        _NATIVE = lib
        print(f"colmap IO: native ({lib_path.name})")
    except Exception as e:  # no g++ or no source: the Python path
        print(f"colmap IO: python ({type(e).__name__}: {e})")
    return _NATIVE


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _native_images(lib, path):
    """images.bin through the native parser; None if it refuses."""
    n = lib.colmap_count_images(path.encode())
    if n < 0:
        return None
    ids = np.empty(n, np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    names = ctypes.create_string_buffer(int(n) * _NAME_CAP)
    got = lib.colmap_read_images(path.encode(), _ptr(ids), _ptr(qvec),
                                 _ptr(tvec), _ptr(cam_ids), names,
                                 ctypes.c_longlong(_NAME_CAP))
    if got != n:
        return None
    out = {}
    for i in range(n):
        raw = names.raw[i * _NAME_CAP:(i + 1) * _NAME_CAP]
        out[int(ids[i])] = ColmapImage(
            int(ids[i]), qvec[i].copy(), tvec[i].copy(), int(cam_ids[i]),
            raw.split(b"\x00", 1)[0].decode("utf-8"))
    return out


def _native_points3d(lib, path):
    """points3D.bin through the native parser (xyz read as float32, as
    the JAX package's native path reads it); None if it refuses."""
    n = lib.colmap_count_points3d(path.encode())
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    if lib.colmap_read_points3d(path.encode(), _ptr(xyz), _ptr(rgb),
                                _ptr(err)) != n:
        return None
    return xyz.astype(np.float64), rgb, err


def read_images_binary(path):
    lib = native_lib()
    if lib is not None:
        got = _native_images(lib, path)
        if got is not None:
            return got
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
    lib = native_lib()
    if lib is not None:
        got = _native_points3d(lib, path)
        if got is not None:
            return got
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
