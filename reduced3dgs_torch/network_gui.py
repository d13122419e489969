"""SIBR remote-viewer bridge (TCP) of the port: the counterpart of
reduced3dgs_tpu/network_gui.py, with the same wire protocol.

  client -> 4-byte LE length + JSON {resolution, fovs, znear/zfar, flags,
  scaling_modifier, view matrix, view-projection matrix (Y/Z columns
  sign-flipped)}; server -> raw RGB bytes of the render + 4-byte LE
  length-prefixed source-path string.

The training CLI (``python -m reduced3dgs_torch.train --ip --port``)
polls it at the top of every iteration or step group; each frame renders
the trainer's pool on the trainer's device at its initial budget.
"""

from __future__ import annotations

import json
import math
import socket
import traceback

import numpy as np
import torch


class MiniCam:
    """Viewer-driven camera: the transposed view and full projection
    matrices as the viewer sends them (after the sign flips)."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transform, full_proj_transform):
        self.width = width
        self.height = height
        self.fov_y = fovy
        self.fov_x = fovx
        self.znear = znear
        self.zfar = zfar
        self.world_view_transform = np.asarray(world_view_transform,
                                               np.float32)
        self.full_proj_transform = np.asarray(full_proj_transform,
                                              np.float32)
        self.camera_center = np.linalg.inv(
            self.world_view_transform)[3, :3].astype(np.float32)

    def params(self, device=None):
        """The rasterizer's camera bundle on `device` (default: the
        card)."""
        from reduced3dgs_torch.device import resolve
        from reduced3dgs_torch.ops.preprocess import CameraParams

        dev = resolve(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return CameraParams(
            viewmatrix=t(self.world_view_transform),
            projmatrix=t(self.full_proj_transform),
            campos=t(self.camera_center),
            tan_fovx=t(math.tan(self.fov_x * 0.5)),
            tan_fovy=t(math.tan(self.fov_y * 0.5)),
            width=self.width, height=self.height,
        )


class NetworkGUI:
    """The viewer's server socket.  A bind failure prints "Network GUI
    disabled" and leaves the bridge off (training goes on without it)."""

    def __init__(self, host, port, source_path, trainer, pipe, background):
        self.source_path = source_path
        self.trainer = trainer
        self.pipe = pipe
        self.background = background
        self.conn = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.enabled = True
        try:
            self.listener.bind((host, port))
            self.listener.listen()
            self.listener.settimeout(0)
        except OSError as e:
            print(f"Network GUI disabled ({e})")
            self.enabled = False

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the viewer closed the connection")
            buf += chunk
        return buf

    def _read(self):
        length = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(length).decode("utf-8"))

    def _send(self, image_bytes, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def _receive(self):
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        view = np.reshape(np.array(msg["view_matrix"], np.float32), (4, 4))
        view[:, 1] = -view[:, 1]
        view[:, 2] = -view[:, 2]
        proj = np.reshape(
            np.array(msg["view_projection_matrix"], np.float32), (4, 4))
        proj[:, 1] = -proj[:, 1]
        cam = MiniCam(width, height, msg["fov_y"], msg["fov_x"],
                      msg["z_near"], msg["z_far"], view, proj)
        return (cam, bool(msg["train"]), bool(msg["keep_alive"]),
                msg["scaling_modifier"])

    def poll(self, iteration):
        """The train-loop hook: accept a waiting viewer, then serve its
        frames until it asks for training to go on."""
        if not self.enabled:
            return
        if self.conn is None:
            try:
                self.conn, addr = self.listener.accept()
            except OSError:  # no viewer waiting (non-blocking accept)
                return
            print(f"\nConnected by {addr}")
            self.conn.settimeout(None)
        while self.conn is not None:
            try:
                cam, do_training, keep_alive, scaling_mod = self._receive()
                image_bytes = None
                if cam is not None:
                    image_bytes = self.render(cam, scaling_mod)
                self._send(image_bytes, self.source_path)
                if do_training and (
                        iteration < self.trainer.opt_cfg.iterations
                        or not keep_alive):
                    break
            except ConnectionError as e:
                print(f"\nViewer disconnected ({e})")
                self.conn.close()
                self.conn = None
            except Exception:  # a broken viewer must not stop training
                traceback.print_exc()
                self.conn.close()
                self.conn = None

    def render(self, cam: MiniCam, scaling_modifier):
        """The frame the viewer gets: RGB bytes, row-major, 8 bits."""
        from reduced3dgs_torch.renderer import render

        pool = self.trainer.state.pool
        with torch.inference_mode():
            out = render(
                pool.params.xyz, pool.features(), pool.params.scaling,
                pool.params.rotation, pool.params.opacity[:, 0],
                pool.degrees, cam.params(self.trainer.device),
                self.background, width=cam.width, height=cam.height,
                instance_budget=self.trainer.initial_budget,
                alive_mask=pool.alive,
                scale_modifier=float(scaling_modifier),
                backend=self.pipe.backend)
            img = torch.clamp(out.color, 0.0, 1.0).cpu().numpy()
        return memoryview((img * 255).astype(np.uint8).tobytes())
