"""Scene: dataset detection, camera lists and model loading.

Counterpart of the loading path of reduced3dgs_tpu/scene.py: COLMAP vs
Blender auto-detection, resolution-scaled camera lists, cameras_extent,
and the point_cloud[_quantised][_half].ply / _quantised_pack naming.
Training-side setup (initial point cloud, camera JSON dump, saving,
redundancy) comes with training.
"""

from __future__ import annotations

import os
import random

from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.config import ModelParams
from reduced3dgs_torch.data import dataset_readers as readers
from reduced3dgs_torch.models.ply_io import load_gaussian_ply, pool_from_arrays


def search_max_iteration(folder):
    return max(int(f.split("_")[-1]) for f in os.listdir(folder))


def ply_name(quantised=False, half_float=False, pack_xyz=False):
    if pack_xyz:
        return "point_cloud_quantised_pack.ply"
    return ("point_cloud" + ("_quantised" if quantised else "")
            + ("_half" if half_float else "") + ".ply")


class Scene:
    def __init__(self, args: ModelParams, load_iteration=-1, shuffle=True,
                 resolution_scales=(1.0,), lazy_images=False):
        self.model_path = args.model_path
        if load_iteration is None:
            raise NotImplementedError(
                "a scene without a trained model (training setup) is not "
                "ported yet")
        if load_iteration == -1:
            self.loaded_iter = search_max_iteration(
                os.path.join(self.model_path, "point_cloud"))
        else:
            self.loaded_iter = load_iteration
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

    def get_train_cameras(self, scale=1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale=1.0):
        return self.test_cameras[scale]
