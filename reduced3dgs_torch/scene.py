"""Scene: dataset detection, camera lists, model loading and saving.

Counterpart of reduced3dgs_tpu/scene.py: COLMAP vs Blender
auto-detection, resolution-scaled camera lists, cameras_extent, the
point_cloud[_quantised][_half].ply / _quantised_pack naming, and the
training setup (input.ply and cameras.json copied into the model
directory, the initial pool from the scene's point cloud), and the
redundancy metric of the training cameras that mercy culling reads.
"""

from __future__ import annotations

import json
import os
import random
import shutil

import numpy as np

from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.config import ModelParams
from reduced3dgs_torch.data import dataset_readers as readers
from reduced3dgs_torch.models import gaussians as G
from reduced3dgs_torch.models.ply_io import (
    load_gaussian_ply, pool_from_arrays, save_gaussian_ply,
)
from reduced3dgs_torch.ops.transforms import fov2focal


def camera_to_json(idx, cam: Camera):
    """The reference's camera_to_JSON entry of cameras.json."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = cam.R.transpose()
    rt[:3, 3] = cam.T
    rt[3, 3] = 1.0
    w2c = np.linalg.inv(rt)
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [x.tolist() for x in w2c[:3, :3]],
        "fy": fov2focal(cam.fov_y, cam.height),
        "fx": fov2focal(cam.fov_x, cam.width),
    }


def search_max_iteration(folder):
    return max(int(f.split("_")[-1]) for f in os.listdir(folder))


def ply_name(quantised=False, half_float=False, pack_xyz=False):
    if pack_xyz:
        return "point_cloud_quantised_pack.ply"
    return ("point_cloud" + ("_quantised" if quantised else "")
            + ("_half" if half_float else "") + ".ply")


class Scene:
    """load_iteration: -1 (the latest), an iteration, or None for
    training, which copies input.ply and writes cameras.json into the
    model directory and builds ``self.pool`` from the scene's point cloud
    on `device` (default: the card) unless a pool is given."""

    def __init__(self, args: ModelParams, load_iteration=-1, shuffle=True,
                 resolution_scales=(1.0,), lazy_images=False, pool=None,
                 device=None):
        self.model_path = args.model_path
        self.pool = pool
        self.loaded_iter = None
        if load_iteration == -1:
            self.loaded_iter = search_max_iteration(
                os.path.join(self.model_path, "point_cloud"))
        elif load_iteration is not None:
            self.loaded_iter = load_iteration
        if self.loaded_iter is not None:
            print(f"Loading trained model at iteration {self.loaded_iter}")

        if os.path.exists(os.path.join(args.source_path, "sparse")):
            info = readers.read_colmap_scene(
                args.source_path, args.images, args.eval)
        elif os.path.exists(os.path.join(args.source_path,
                                         "transforms_train.json")):
            print("Found transforms_train.json, assuming Blender data set!")
            info = readers.read_blender_scene(
                args.source_path, args.white_background, args.eval)
        else:
            raise ValueError(
                f"Could not recognize scene type: {args.source_path}")

        if self.loaded_iter is None and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(info.ply_path,
                            os.path.join(self.model_path, "input.ply"))
            cams = info.train_cameras + info.test_cameras
            with open(os.path.join(self.model_path, "cameras.json"),
                      "w") as f:
                json.dump([camera_to_json(i, self._make_camera(c, 1.0, args,
                                                               True))
                           for i, c in enumerate(cams)], f)

        if shuffle:
            random.shuffle(info.train_cameras)
            random.shuffle(info.test_cameras)

        self.cameras_extent = info.nerf_normalization["radius"]
        self.train_cameras = {}
        self.test_cameras = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = [
                self._make_camera(c, scale, args, lazy_images)
                for c in info.train_cameras]
            self.test_cameras[scale] = [
                self._make_camera(c, scale, args, lazy_images)
                for c in info.test_cameras]
        if self.loaded_iter is None and self.pool is None:
            xyz, colors = info.point_cloud
            self.pool = G.create_from_pcd(xyz, colors, device=device)

    @staticmethod
    def _make_camera(info, scale, args, lazy):
        res = readers.pick_resolution(info, args.resolution, scale)
        image = None if lazy else readers.load_image(info, res)
        return Camera(
            uid=info.uid, colmap_id=info.uid, R=info.R, T=info.T,
            fov_x=info.fov_x, fov_y=info.fov_y, image=image,
            image_name=info.image_name, width=res[0], height=res[1],
        )

    def load_model(self, quantised=False, half_float=False, pack_xyz=False,
                   device=None):
        """Load one stored variant as a pool on `device` (default: the
        card)."""
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{self.loaded_iter}",
                            ply_name(quantised, half_float, pack_xyz))
        arrs = load_gaussian_ply(path, quantised=quantised or pack_xyz,
                                 half_float=half_float or pack_xyz)
        return pool_from_arrays(arrs, device)

    def save(self, iteration, codebook_dict=None, quantise=False,
             half_float=False, pack_xyz=False):
        """Write ``self.pool`` as point_cloud/iteration_N/<ply_name>: the
        plain PLY, or with the codebooks the quantised one (uint8 ids +
        centres; half_float: f16 centres and xyz; pack_xyz: the chunked
        u16 xyz codec).  Returns the file's path."""
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}",
                            ply_name(quantise, half_float, pack_xyz))
        save_gaussian_ply(path, self.pool, codebook_dict, quantised=quantise,
                          half_float=half_float,
                          xyz_codec="u16c" if pack_xyz else None)
        return path

    def get_train_cameras(self, scale=1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale=1.0):
        return self.test_cameras[scale]

    def calculate_redundancy_metric(self, pixel_scale=1.0,
                                    num_neighbours=30, columns=None):
        """(min_redundancy (C,) int32, cube_size (C,)) of ``self.pool``
        over the training cameras (ops/redundancy.py, as a Trainer
        computes it from its own cameras).  columns: the (xyz, activated
        scales, normalised rotations, alive) to read in place of
        ``self.pool``'s (a sharded trainer's gathered ones)."""
        from reduced3dgs_torch.ops.redundancy import (
            camera_stack, redundancy_metric,
        )

        if columns is None:
            pool = self.pool
            columns = (pool.params.xyz, pool.get_scaling(),
                       pool.get_rotation(), pool.alive)
        return redundancy_metric(
            *columns, *camera_stack(self.get_train_cameras(),
                                    columns[0].device),
            pixel_scale=pixel_scale, num_neighbours=num_neighbours)
