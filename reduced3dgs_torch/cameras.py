"""Camera model (host-side numpy construction, tensors on request).

Counterpart of reduced3dgs_tpu/cameras.py: stores the *transposed*
world-view and full-projection matrices (row-vector convention),
znear=0.01 / zfar=100, and the camera center; ``params(device)`` returns
the torch CameraParams bundle on that device, ``camera_vector`` the
pose a replayed graph reads from a device vector (``camera_from_vector``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from reduced3dgs_torch.device import resolve
from reduced3dgs_torch.ops.preprocess import CameraParams
from reduced3dgs_torch.ops.transforms import projection_matrix, world_to_view

ZNEAR = 0.01
ZFAR = 100.0
# camera_vector's length: viewmatrix 16, projmatrix 16, campos 3,
# tan_fovx, tan_fovy
CAMERA_VEC = 37


@dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray  # (3,3) camera-to-world rotation
    T: np.ndarray  # (3,) world-to-camera translation
    fov_x: float
    fov_y: float
    image: Optional[np.ndarray]  # (H,W,3) float32 in [0,1], may be None
    image_name: str
    width: int
    height: int
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        w2v = world_to_view(self.R, self.T, self.trans, self.scale)
        proj = projection_matrix(ZNEAR, ZFAR, self.fov_x, self.fov_y)
        self.world_view_transform = w2v.T.astype(np.float32)
        self.projection_matrix = proj.T.astype(np.float32)
        self.full_proj_transform = (
            self.world_view_transform @ self.projection_matrix
        ).astype(np.float32)
        self.inverse_full_proj_transform = np.linalg.inv(
            self.full_proj_transform).astype(np.float32)
        self.camera_center = np.linalg.inv(
            self.world_view_transform)[3, :3].astype(np.float32)

    @property
    def tan_fovx(self) -> float:
        return math.tan(self.fov_x * 0.5)

    @property
    def tan_fovy(self) -> float:
        return math.tan(self.fov_y * 0.5)

    def params(self, device=None) -> CameraParams:
        """The rasterizer's camera bundle on `device` (default: the card)."""
        dev = resolve(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return CameraParams(
            viewmatrix=t(self.world_view_transform),
            projmatrix=t(self.full_proj_transform),
            campos=t(self.camera_center),
            tan_fovx=t(self.tan_fovx),
            tan_fovy=t(self.tan_fovy),
            width=self.width,
            height=self.height,
        )

    @classmethod
    def look_at(cls, eye, target, up=(0, 1, 0), fov_x=math.radians(60),
                width=256, height=256, uid=0, image=None, image_name=""):
        """Convenience constructor for synthetic scenes and tests."""
        eye = np.asarray(eye, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        dn = np.cross(fwd, right)
        # camera-to-world rotation with columns (right, down, forward)
        R = np.stack([right, dn, fwd], axis=1)
        T = -R.T @ eye  # world-to-camera translation
        fov_y = 2 * math.atan(math.tan(fov_x / 2) * height / width)
        return cls(
            uid=uid, colmap_id=uid, R=R, T=T, fov_x=fov_x, fov_y=fov_y,
            image=image, image_name=image_name, width=width, height=height,
        )


def camera_vector(camera) -> np.ndarray:
    """The camera's float32 (CAMERA_VEC,) vector."""
    return np.concatenate([
        np.asarray(camera.world_view_transform, np.float32).reshape(16),
        np.asarray(camera.full_proj_transform, np.float32).reshape(16),
        np.asarray(camera.camera_center, np.float32).reshape(3),
        np.float32([camera.tan_fovx, camera.tan_fovy])])


def camera_from_vector(vec, width: int, height: int) -> CameraParams:
    """CameraParams as views of a vector whose first CAMERA_VEC floats
    are a camera_vector (no copy)."""
    return CameraParams(
        viewmatrix=vec[0:16].view(4, 4), projmatrix=vec[16:32].view(4, 4),
        campos=vec[32:35], tan_fovx=vec[35], tan_fovy=vec[36],
        width=width, height=height)
