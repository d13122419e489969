"""The port's visualisation utilities (reduced3dgs_torch/utils/vis.py)
against the JAX package's (reduced3dgs_tpu/utils/vis.py) on the same
inputs, as numpy arrays and as torch tensors.

The port carries matplotlib's turbo table itself (the card's machine has
no matplotlib): the table must be matplotlib's bit for bit, and the
colormap must pick the entries matplotlib picks, 0, 1, the entry edges
and NaN included.  Image files are compared byte for byte (both write
through Pillow), and the GIF is read back with Pillow.
"""

import os

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
from reduced3dgs_torch.utils import vis as tvis
from reduced3dgs_tpu.utils import vis as jvis


def _inputs():
    rng = np.random.default_rng(5)
    edges = np.arange(257, dtype=np.float64) / 256
    return [
        rng.uniform(0, 1, (17, 23)).astype(np.float32),
        rng.uniform(-0.5, 1.5, 400),
        np.concatenate([edges, np.nextafter(edges, -1), [np.nan, 0.5]]),
        edges.astype(np.float32),
        np.array([0, 1, 2, -3]),
        np.float32(0.25),
    ]


def test_turbo_table_is_matplotlibs():
    want = matplotlib.colormaps["turbo"](np.arange(256))[:, :3]
    assert tvis.TURBO.dtype == want.dtype and np.array_equal(tvis.TURBO,
                                                             want)


@pytest.mark.parametrize("case", range(6))
def test_colormap_turbo_matches(case):
    x = _inputs()[case]
    want = jvis.colormap_turbo(x)
    got = tvis.colormap_turbo(x)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    if np.ndim(x):
        assert np.array_equal(tvis.colormap_turbo(torch.as_tensor(x)), want)


def test_normalise_shapes_and_cameras(tmp_path):
    rng = np.random.default_rng(2)
    a = rng.normal(0, 3, (12, 9, 3)).astype(np.float32)
    for x in (a, np.full((4, 4), 2.0)):
        assert np.array_equal(tvis.normalise_tensor(torch.as_tensor(x)),
                              jvis.normalise_tensor(x))
    scales = np.exp(rng.normal(-3, 1.2, (500, 3))).astype(np.float32)
    scales[:10] = [1.0, 0.1, 0.1]  # needles
    scales[10:20] = [1.0, 0.9, 0.1]  # discs
    want = jvis.compute_shape(scales)
    assert set(want.tolist()) == {0, 1, 2}
    assert np.array_equal(tvis.compute_shape(torch.as_tensor(scales)), want)
    raw = np.log(scales)
    assert np.array_equal(tvis.classify_ellipsoids(torch.as_tensor(raw)),
                          jvis.classify_ellipsoids(raw))
    cs.write_colmap_text(str(tmp_path), cs.ring_cameras(64, 48, n_views=3))
    sparse = str(tmp_path / "sparse" / "0")
    want = jvis.read_camera_path(sparse)
    got = tvis.read_camera_path(sparse)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a_, b_ in zip(g, w):
            assert np.array_equal(np.asarray(a_), np.asarray(b_))
    with pytest.raises(FileNotFoundError):
        tvis.read_camera_path(str(tmp_path))


def test_image_writers_and_gif_match(tmp_path):
    rng = np.random.default_rng(4)
    pred = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    dirs = {}
    for name, mod, conv in (("jax", jvis, np.asarray),
                            ("torch", tvis, torch.as_tensor)):
        d = tmp_path / name
        d.mkdir()
        mod.save_image(str(d / "img.png"), conv(pred))
        mod.save_image(str(d / "gray.png"), conv(pred[..., 0]))
        mod.save_loss_image(str(d / "loss.png"), conv(pred), conv(gt))
        mod.save_tensor(str(d / "t.png"), conv(pred[..., 1]),
                        use_colormap=True)
        mod.save_tensor(str(d / "t2.png"), conv(pred))
        for it in (30, 10, 20):
            loss = np.abs(pred - gt) * it
            mod.save_gif_images(str(d), conv(loss), conv(pred), 3, it, "l1",
                                normalise=it == 20)
        mod.save_gif_images(str(d), conv(gt[..., 0]), conv(gt), 4, 5, "l1")
        dirs[name] = d
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["torch"])) and len(names) == 9
    for n in names:
        assert (dirs["jax"] / n).read_bytes() == (dirs["torch"] / n).read_bytes()
    gif = tvis.generate_gif(str(dirs["torch"]), 3)
    want = jvis.generate_gif(str(dirs["jax"]), 3)
    assert os.path.basename(gif) == os.path.basename(want) == "gif_3.gif"
    assert open(gif, "rb").read() == open(want, "rb").read()
    with Image.open(gif) as im:
        assert im.n_frames == 3 and im.size == (64, 24)
    with pytest.raises(FileNotFoundError):
        tvis.generate_gif(str(dirs["torch"]), 7)
