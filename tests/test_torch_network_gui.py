"""The port's SIBR viewer bridge (reduced3dgs_torch/network_gui.py)
against the JAX package's, over real loopback sockets, and its hook in
the training CLI.

The same client messages (a 4-byte LE length and JSON: a frame, a
status message of resolution 0, a frame that releases training) go to
the JAX NetworkGUI and to the port's on the same pool: the frames agree
within one 8-bit level, the verify strings are equal and MiniCam.params
agree to rtol 1e-6.  The training CLI with --port 0 polls the bridge at
every iteration and serves a viewer frame of its pool.
"""

import json
import os
import socket
import struct
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch
from test_cli_e2e import make_blender_dataset

from reduced3dgs_torch import network_gui as tgui
from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.models.gaussians import pool_from_numpy
from reduced3dgs_tpu import network_gui as jgui
from reduced3dgs_tpu.models import gaussians as JG

SOURCE = "/data/scene"


def _pools(n=48):
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    jpool = JG.create_from_pcd(pts, cols, capacity=1024)
    leaves = {k: np.array(v) for k, v in jpool.params._asdict().items()}
    leaves.update(degrees=np.array(jpool.degrees),
                  alive=np.array(jpool.alive))
    return jpool, pool_from_numpy(leaves, "cpu")


def _message(w, h, train, keep_alive, scaling=1.0):
    cam = Camera.look_at(eye=(0, 0, -3), target=(0, 0, 0), width=max(w, 1),
                         height=max(h, 1))
    view = cam.world_view_transform.copy()
    view[:, 1:3] *= -1  # the viewer's convention; the server flips back
    proj = cam.full_proj_transform.copy()
    proj[:, 1] *= -1
    msg = {"resolution_x": w, "resolution_y": h, "train": train,
           "keep_alive": keep_alive, "scaling_modifier": scaling,
           "fov_x": cam.fov_x, "fov_y": cam.fov_y, "z_near": 0.01,
           "z_far": 100.0, "view_matrix": view.ravel().tolist(),
           "view_projection_matrix": proj.ravel().tolist()}
    payload = json.dumps(msg).encode()
    return struct.pack("<I", len(payload)) + payload


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


def _session(gui, frames):
    """Send every message, poll once, read the replies: [(frame or None,
    verify string)]."""
    client = socket.create_connection(gui.listener.getsockname())
    for w, h, kw in frames:
        client.sendall(_message(w, h, **kw))
    gui.poll(iteration=50)
    replies = []
    for w, h, _ in frames:
        img = None
        if w:
            img = np.frombuffer(_recv_exact(client, h * w * 3),
                                np.uint8).reshape(h, w, 3)
        vlen = struct.unpack("<I", _recv_exact(client, 4))[0]
        replies.append((img, _recv_exact(client, vlen).decode("ascii")))
    client.close()
    gui.listener.close()
    return replies


def test_viewer_session_matches_jax():
    jpool, tpool = _pools()
    frames = [(64, 48, dict(train=False, keep_alive=True)),
              (96, 80, dict(train=False, keep_alive=True, scaling=0.5)),
              (0, 0, dict(train=False, keep_alive=True)),
              (64, 48, dict(train=True, keep_alive=False))]
    cfg = SimpleNamespace(iterations=100)
    jtr = SimpleNamespace(state=SimpleNamespace(pool=jpool), opt_cfg=cfg,
                          initial_budget=1 << 13)
    ttr = SimpleNamespace(state=SimpleNamespace(pool=tpool), opt_cfg=cfg,
                          initial_budget=1 << 13, device=torch.device("cpu"))
    want = _session(jgui.NetworkGUI("127.0.0.1", 0, SOURCE, jtr,
                                    SimpleNamespace(backend="pallas"),
                                    jnp.zeros(3)), frames)
    got = _session(tgui.NetworkGUI("127.0.0.1", 0, SOURCE, ttr,
                                   SimpleNamespace(backend="tile"),
                                   torch.zeros(3)), frames)
    for (gi, gv), (wi, wv) in zip(got, want):
        assert gv == wv == SOURCE
        assert (gi is None) == (wi is None)
        if gi is not None:
            assert gi.std() > 1.0
            assert np.abs(gi.astype(int) - wi.astype(int)).max() <= 1


def test_minicam_params_match_jax():
    args = (96, 80, 0.9, 1.1, 0.01, 100.0)
    cam = Camera.look_at(eye=(0.5, 0.2, -3), target=(0, 0, 0), width=96,
                         height=80)
    mats = (cam.world_view_transform, cam.full_proj_transform)
    want = jgui.MiniCam(*args, *mats).params()
    got = tgui.MiniCam(*args, *mats).params("cpu")
    for name in ("viewmatrix", "projmatrix", "campos", "tan_fovx",
                 "tan_fovy"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6)
    assert (got.width, got.height) == (want.width, want.height)


def test_bind_failure_disables_the_bridge(capsys):
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    try:
        gui = tgui.NetworkGUI("127.0.0.1", taken.getsockname()[1], SOURCE,
                              None, None, None)
        assert not gui.enabled
        gui.poll(1)  # a no-op
        gui.close()
    finally:
        taken.close()
    assert "Network GUI disabled" in capsys.readouterr().out


def test_training_cli_polls_the_bridge(tmp_path, monkeypatch, capsys):
    """python -m reduced3dgs_torch.train --port 0, run in this process:
    the bridge is polled at the top of every iteration, and a viewer that
    connects at iteration 2 gets a frame of the pool being trained and
    the scene's path."""
    from reduced3dgs_torch.train.__main__ import main

    src = str(tmp_path / "scene")
    make_blender_dataset(src)
    polls, replies = [], []
    poll = tgui.NetworkGUI.poll

    def spy(self, iteration):
        polls.append(iteration)
        if iteration != 2:
            return poll(self, iteration)
        with socket.create_connection(self.listener.getsockname()) as c:
            c.sendall(_message(64, 48, train=True, keep_alive=False))
            poll(self, iteration)
            img = np.frombuffer(_recv_exact(c, 64 * 48 * 3), np.uint8)
            vlen = struct.unpack("<I", _recv_exact(c, 4))[0]
            replies.append((img, _recv_exact(c, vlen).decode("ascii")))

    monkeypatch.setattr(tgui.NetworkGUI, "poll", spy)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main(["-s", src, "-m", str(tmp_path / "model"), "--device", "cpu",
              "--iterations", "4", "--densify_from_iter", "100",
              "--ip", "127.0.0.1", "--port", "0", "--quiet"])
    finally:
        torch.set_num_threads(threads)
    assert polls == [1, 2, 3, 4]
    (img, verify), = replies
    assert verify == src and img.std() > 1.0
    out = capsys.readouterr().out
    assert "Connected by" in out and "Training complete in" in out
    assert os.path.exists(tmp_path / "model" / "point_cloud" /
                          "iteration_4" / "point_cloud_quantised_half.ply")
