"""Scene loaders: COLMAP projects + Blender (NeRF-synthetic) transforms.

A copy of reduced3dgs_tpu/data/dataset_readers.py (numpy only): camera
infos with R stored transposed (camera-to-world), NeRF++-style scene
normalization, every-8th test split with --eval, alpha-composited Blender
images and random 100k-point init for synthetic scenes.  PIL is imported
inside the functions that read images, so the module imports where
Pillow is not installed.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from reduced3dgs_torch.data.colmap import (
    qvec2rotmat, read_cameras_binary, read_cameras_text, read_images_binary,
    read_images_text, read_points3d_binary, read_points3d_text,
)
from reduced3dgs_torch.data.ply import read_ply, write_ply
from reduced3dgs_torch.data.png import read_png
from reduced3dgs_torch.ops.transforms import focal2fov, fov2focal


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # camera-to-world rotation (transposed w2c)
    T: np.ndarray  # world-to-camera translation
    fov_y: float
    fov_x: float
    image_path: str
    image_name: str
    width: int
    height: int
    image: Optional[np.ndarray] = None  # lazy-loaded (H,W,3) float or None
    bg_white: bool = False


@dataclass
class SceneInfo:
    point_cloud: tuple  # (xyz, colors) float arrays
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


def _get_nerf_norm(cam_infos):
    """Camera-centroid diagonal * 1.1."""
    centers = []
    for cam in cam_infos:
        w2c = np.zeros((4, 4))
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        w2c[3, 3] = 1.0
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.linalg.norm(centers - avg, axis=0).max()
    radius = diagonal * 1.1
    return {"translate": -avg.flatten(), "radius": radius}


def read_colmap_scene(path, images_dir="images", eval_split=False,
                      llffhold=8):
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams = read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse, "images.txt"))

    cam_infos = []
    for _, im in sorted(imgs.items(), key=lambda kv: kv[1].name):
        cam = cams[im.camera_id]
        r = qvec2rotmat(im.qvec).T  # store transposed
        t = im.tvec
        if cam.model == "SIMPLE_PINHOLE" or cam.model.startswith(
                "SIMPLE_RADIAL"):
            focal_x = focal_y = cam.params[0]
        elif cam.model in ("PINHOLE", "OPENCV", "RADIAL", "FULL_OPENCV"):
            focal_x = cam.params[0]
            focal_y = cam.params[1] if cam.model != "RADIAL" else cam.params[0]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model}; undistort "
                "with `python convert.py` first")
        fov_x = focal2fov(focal_x, cam.width)
        fov_y = focal2fov(focal_y, cam.height)
        cam_infos.append(CameraInfo(
            uid=im.camera_id, R=r, T=t, fov_y=fov_y, fov_x=fov_x,
            image_path=os.path.join(path, images_dir, im.name),
            image_name=os.path.splitext(im.name)[0],
            width=cam.width, height=cam.height,
        ))

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = _get_nerf_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        store_point_cloud_ply(ply_path, xyz, rgb)
    xyz, colors = fetch_point_cloud_ply(ply_path)
    return SceneInfo(
        point_cloud=(xyz, colors), train_cameras=train, test_cameras=test,
        nerf_normalization=norm, ply_path=ply_path,
    )


def read_blender_scene(path, white_background=False, eval_split=True,
                       extension=".png"):
    from PIL import Image

    def read_transforms(fname):
        with open(os.path.join(path, fname)) as f:
            meta = json.load(f)
        fov_x = meta["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"])
            # NeRF 'blender' to COLMAP convention
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            r = np.transpose(w2c[:3, :3])
            t = w2c[:3, 3]
            fp = frame["file_path"]
            img_path = os.path.join(
                path, fp + extension if not fp.endswith(extension) else fp)
            with Image.open(img_path) as probe:
                w, h = probe.size
            fov_y = focal2fov(fov2focal(fov_x, w), h)
            infos.append(CameraInfo(
                uid=idx, R=r, T=t, fov_y=fov_y, fov_x=fov_x,
                image_path=img_path,
                image_name=os.path.basename(fp), width=w, height=h,
                bg_white=white_background,
            ))
        return infos

    train = read_transforms("transforms_train.json")
    test = (read_transforms("transforms_test.json")
            if os.path.exists(os.path.join(path, "transforms_test.json"))
            else [])
    if not eval_split:
        train = train + test
        test = []
    norm = _get_nerf_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # random init inside [-1.3, 1.3]^3
        n = 100_000
        print(f"Generating random point cloud ({n})...")
        xyz = np.random.random((n, 3)) * 2.6 - 1.3
        rgb = (np.random.random((n, 3)) * 255).astype(np.uint8)
        store_point_cloud_ply(ply_path, xyz, rgb)
    xyz, colors = fetch_point_cloud_ply(ply_path)
    return SceneInfo(
        point_cloud=(xyz, colors), train_cameras=train, test_cameras=test,
        nerf_normalization=norm, ply_path=ply_path,
    )


def store_point_cloud_ply(path, xyz, rgb):
    """Input-cloud PLY (x y z nx ny nz red green blue)."""
    dtype = np.dtype([(k, "f4") for k in
                      ("x", "y", "z", "nx", "ny", "nz")]
                     + [(k, "u1") for k in ("red", "green", "blue")])
    rec = np.zeros(len(xyz), dtype=dtype)
    for i, k in enumerate(("x", "y", "z")):
        rec[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = rgb[:, i]
    write_ply(path, [("vertex", rec)])


def fetch_point_cloud_ply(path):
    data = read_ply(path)["vertex"]
    xyz = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(
        np.float32)
    colors = np.stack([data["red"], data["green"], data["blue"]],
                      axis=1).astype(np.float32) / 255.0
    return xyz, colors


def load_image(info: CameraInfo, resolution):
    """PIL load + resize + alpha handling; (H,W,3) float32 in [0,1].
    Without Pillow, PNG files at their own resolution load through
    data/png.py (the same pixels)."""
    try:
        from PIL import Image
    except ImportError:
        arr = read_png(info.image_path)
        if resolution != (arr.shape[1], arr.shape[0]):
            raise RuntimeError(f"{info.image_path}: resizing needs Pillow")
        arr = arr.astype(np.float32) / 255.0
    else:
        with Image.open(info.image_path) as img:
            if resolution != (img.width, img.height):
                img = img.resize(resolution)
            arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] == 4:
        bg = 1.0 if info.bg_white else 0.0
        alpha = arr[:, :, 3:4]
        arr = arr[:, :, :3] * alpha + bg * (1 - alpha)
    return np.clip(arr[:, :, :3], 0.0, 1.0)


def pick_resolution(info: CameraInfo, resolution_arg: int, scale=1.0):
    """-1 => auto-downscale beyond 1600px; 1/2/4/8 => divisors; else the
    target width."""
    orig_w, orig_h = info.width, info.height
    if resolution_arg in (1, 2, 4, 8):
        s = float(resolution_arg) * scale
    elif resolution_arg == -1:
        if orig_w > 1600:
            global_down = orig_w / 1600
        else:
            global_down = 1.0
        s = global_down * scale
    else:
        s = (orig_w / resolution_arg) * scale
    return int(orig_w / s), int(orig_h / s)
