"""The port's offline compression and metrics CLIs against the root
compress.py and metrics.py (the JAX package), on the CPU.

* ``python -m reduced3dgs_torch.compress --device cpu`` on a model
  directory over the tiny Blender scene of tests/test_cli_e2e.py: the
  lowest-opacity prune keeps the rows the JAX CLI keeps, and with the
  same codebooks injected into both CLIs the written PLYs load to equal
  arrays; with --finetune_iters the fine-tune runs through
  Trainer.step_group;
* ``python -m reduced3dgs_torch.metrics --device cpu`` on folders of
  renders and ground truths: results.json and per_view.json have the
  root metrics.py's keys and values within 1e-5, LPIPS included (random
  VGG16 weights of the right shapes, tests/test_lpips.py);
* data/png.py: every row filter decodes as Pillow decodes it.
"""

import json
import os
import shutil
import struct
import subprocess
import sys
import zlib
from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_cli_e2e import REPO, make_blender_dataset
from test_lpips import _random_weights

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch import compress as tcompress
from reduced3dgs_torch import metrics as tmetrics
from reduced3dgs_torch.data import png
from reduced3dgs_torch.models import ply_io as tply
from reduced3dgs_torch.models.gaussians import padded_leaves, pool_from_numpy
from reduced3dgs_torch.ops import kmeans as tkm
from reduced3dgs_tpu.models import ply_io as jply
from reduced3dgs_tpu.ops import kmeans as jkm

ITERATION = 10
N = 300  # primitives of the stored model (capacity 1024)
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
QUANTISED = ("point_cloud_quantised.ply", "point_cloud_quantised_half.ply",
             "point_cloud_quantised_pack.ply")


def _model_arrays(seed=3):
    rng = np.random.default_rng(seed)
    feats = np.zeros((N, 16, 3), np.float32)
    feats[:, 0] = rng.uniform(-1.0, 1.5, (N, 3))
    feats[:, 1:] = rng.normal(0, 0.1, (N, 15, 3))
    return {
        "xyz": rng.uniform(-0.7, 0.7, (N, 3)).astype(np.float32),
        "features_dc": feats[:, :1].copy(),
        "features_rest": feats[:, 1:].copy(),
        "scaling": np.log(rng.uniform(0.03, 0.1, (N, 3))).astype(np.float32),
        "rotation": rng.normal(0, 1, (N, 4)).astype(np.float32),
        "opacity": rng.uniform(-3, 3, (N, 1)).astype(np.float32),
        "degrees": rng.integers(0, 4, N).astype(np.int32),
    }


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A Blender scene and a model directory over it: cfg_args and a
    stored point_cloud.ply at iteration ITERATION."""
    root = tmp_path_factory.mktemp("torch_compress")
    src = os.path.join(root, "scene")
    make_blender_dataset(src)
    model = os.path.join(root, "model")
    pool = pool_from_numpy(padded_leaves(_model_arrays()), "cpu")
    tply.save_gaussian_ply(os.path.join(
        model, "point_cloud", f"iteration_{ITERATION}", "point_cloud.ply"),
        pool)
    with open(os.path.join(model, "cfg_args"), "w") as f:
        f.write(str(Namespace(
            sh_degree=3, source_path=src, model_path=model, images="images",
            resolution=-1, white_background=False, data_device="cuda",
            eval=False)))
    return model


def _copy(model, dst):
    shutil.copytree(model, dst)
    cfg = os.path.join(dst, "cfg_args")
    with open(cfg) as f:
        text = f.read().replace(f"model_path='{model}'",
                                f"model_path='{dst}'")
    with open(cfg, "w") as f:
        f.write(text)
    return str(dst)


def _codebooks(capacity, seed=11):
    """The 20 codebooks as numpy (ids, centres): random ids of each
    attribute's shape, sorted random centres."""
    rng = np.random.default_rng(seed)
    shapes = {"features_dc": 3, "opacity": 1, "scaling": 3,
              "rotation_re": 1, "rotation_im": 3}
    shapes.update({f"features_rest_{i}": 3 for i in range(15)})
    return {name: (rng.integers(0, 256, (capacity, k)).astype(np.uint8),
                   np.sort(rng.normal(0, 1, (256, 1))).astype(np.float32))
            for name, k in shapes.items()}


def _pc(model):
    return os.path.join(model, "point_cloud", f"iteration_{ITERATION}")


def test_compress_prune_and_plys_match_jax_cli(model_dir, tmp_path,
                                               monkeypatch, capsys):
    """--prune_frac 0.2 --pack_xyz through both CLIs with the same
    codebooks injected: the same rows survive the prune, and every stored
    array of the three quantised files is equal."""
    import compress as jcompress

    books = _codebooks(1024)
    jdir = _copy(model_dir, tmp_path / "jax")
    tdir = _copy(model_dir, tmp_path / "torch")
    seen = {}

    def jax_fit(pool, key, **kw):
        seen["jax_alive"] = np.asarray(pool.alive)
        return {k: jkm.Codebook(jnp.asarray(i), jnp.asarray(c))
                for k, (i, c) in books.items()}

    def torch_fit(pool, **kw):
        seen["torch_alive"] = pool.alive.numpy()
        return tkm.codebooks_from_numpy(books, "cpu")

    monkeypatch.setattr(jkm, "produce_clusters", jax_fit)
    monkeypatch.setattr(tkm, "produce_clusters", torch_fit)
    flags = ["--prune_frac", "0.2", "--pack_xyz"]
    monkeypatch.setattr(sys, "argv", ["compress.py", "-m", jdir, *flags])
    jcompress.main()
    jax_out = capsys.readouterr().out
    tcompress.main(["-m", tdir, *flags, "--device", "cpu"])
    torch_out = capsys.readouterr().out
    np.testing.assert_array_equal(seen["torch_alive"], seen["jax_alive"])
    assert int(seen["jax_alive"].sum()) == N - int(N * 0.2)
    pruned = [ln for ln in jax_out.splitlines() if ln.startswith("Pruned")]
    assert pruned and pruned[0] in torch_out
    for name in QUANTISED:
        kw = dict(quantised=True, half_float="half" in name or "pack" in name)
        want = jply.load_gaussian_ply(os.path.join(_pc(jdir), name), **kw)
        got = tply.load_gaussian_ply(os.path.join(_pc(tdir), name), **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert os.path.getsize(os.path.join(_pc(tdir), name)) == \
            os.path.getsize(os.path.join(_pc(jdir), name))
        assert f"  {name}: " in torch_out


def test_compress_cli_finetune_on_cpu(model_dir, tmp_path):
    """The full CLI in a subprocess: prune, a fine-tune of 8 iterations
    (one step_group of 7 fusible ones, then the final iteration, which
    never steps), the k-means fit and the three quantised files."""
    tdir = _copy(model_dir, tmp_path / "torch")
    r = subprocess.run(
        [sys.executable, "-m", "reduced3dgs_torch.compress", "-m", tdir,
         "--pack_xyz", "--prune_frac", "0.17", "--finetune_iters", "8",
         "--device", "cpu"], cwd=REPO, env=dict(os.environ, **ONE_THREAD),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "Fine-tuned 8 iterations" in out and "Codebooks fitted" in out
    base = os.path.getsize(os.path.join(_pc(tdir), "point_cloud.ply"))
    for name in QUANTISED:
        arrs = tply.load_gaussian_ply(os.path.join(_pc(tdir), name),
                                      quantised=True,
                                      half_float=name != QUANTISED[0])
        assert arrs["xyz"].shape[0] == N - int(N * 0.17)
        assert all(np.isfinite(v).all() for v in arrs.values())
        assert os.path.getsize(os.path.join(_pc(tdir), name)) < base


def test_compress_finetune_groups_fusible_iterations(model_dir):
    """finetune() runs the fusible iterations as step_groups of up to 16
    and the rest (here: the final iteration) one by one; the Trainer ends
    at the last iteration with every leaf stepped once per fusible one."""
    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.scene import Scene

    with open(os.path.join(model_dir, "cfg_args")) as f:
        cfg = eval(f.read(), {"Namespace": Namespace})  # noqa: S307
    scene = Scene(ModelParams(source_path=cfg.source_path,
                              model_path=model_dir),
                  load_iteration=ITERATION, shuffle=False)
    pool = pool_from_numpy(padded_leaves(_model_arrays()), "cpu")
    calls = []
    stats = {}
    from reduced3dgs_torch.train.trainer import Trainer

    group = Trainer.step_group

    def spy(self, iterations):
        calls.append(list(iterations))
        return group(self, iterations)

    Trainer.step_group = spy
    try:
        out = tcompress.finetune(pool, scene, ITERATION, 20, stats)
    finally:
        Trainer.step_group = group
    assert calls == [list(range(11, 27)), list(range(27, 30))]
    tr = stats["trainer"]
    assert list(tr.state.opt.step) == [19] * 6 and tr.iteration == 30
    assert np.isfinite(stats["loss"]) and out.capacity == 1024


def _write_folders(root, seed=0, size=(40, 48)):
    """<root>/{test,train}/<method>/ours_7/{renders,gt}/NNNNN.png written
    by Pillow, as render.py writes them."""
    rng = np.random.default_rng(seed)
    for split, methods, views in (("test", ("baseline", "quantised_half"), 2),
                                  ("train", ("baseline",), 3)):
        for method in methods:
            base = os.path.join(root, split, method, "ours_7")
            for sub in ("renders", "gt"):
                os.makedirs(os.path.join(base, sub), exist_ok=True)
            for v in range(views):
                gt = rng.uniform(0, 1, size + (3,))
                r = np.clip(gt + rng.normal(0, 0.08, gt.shape), 0, 1)
                for sub, img in (("renders", r), ("gt", gt)):
                    Image.fromarray((img * 255).astype(np.uint8)).save(
                        os.path.join(base, sub, f"{v:05d}.png"))


@pytest.mark.parametrize("lpips", [False, True])
def test_metrics_match_root_metrics(tmp_path, lpips):
    import metrics as jmetrics

    weights = _random_weights(tmp_path) if lpips else None
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    _write_folders(jdir)
    shutil.copytree(jdir, tdir)
    jmetrics.evaluate([jdir], lpips_weights=weights)
    tmetrics.main(["-m", tdir, "--device", "cpu"]
                  + (["--lpips_weights", weights] if lpips else []))
    for name in ("results.json", "per_view.json"):
        with open(os.path.join(jdir, name)) as f:
            want = json.load(f)
        with open(os.path.join(tdir, name)) as f:
            got = json.load(f)
        assert sorted(got) == sorted(want) and len(want) == 3
        for key in want:
            assert sorted(got[key]) == sorted(want[key])
            for metric, value in want[key].items():
                if isinstance(value, dict):
                    assert sorted(got[key][metric]) == sorted(value)
                    np.testing.assert_allclose(
                        [got[key][metric][v] for v in sorted(value)],
                        [value[v] for v in sorted(value)], rtol=1e-5)
                elif value is None:
                    assert got[key][metric] is None and not lpips
                else:
                    np.testing.assert_allclose(got[key][metric], value,
                                               rtol=1e-5)
        if lpips and name == "results.json":
            assert all(v["LPIPS"] > 0 for v in got.values())


def test_metrics_cli_rejects_bad_weights_path(tmp_path):
    with pytest.raises(FileNotFoundError):
        tmetrics.evaluate([str(tmp_path)], lpips_weights="/nope.npz",
                          device="cpu")


def _filtered_png(img, kind):
    """PNG bytes of an (H, W, C) uint8 image with every row filtered by
    `kind` (0-4), written here independently of data/png.py."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        cur = a[y]
        up = a[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_filters_decode_as_pillow(kind, tmp_path):
    import io

    rng = np.random.default_rng(kind)
    for c in (1, 2, 3, 4):
        img = rng.integers(0, 256, (7, 9, c)).astype(np.uint8)
        data = _filtered_png(img, kind)
        want = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(want.reshape(img.shape), img)
        np.testing.assert_array_equal(png.decode_png(data), img)
    path = tmp_path / "x.png"
    png.write_png(path, img[:, :, :3])
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img[:, :, :3])
    np.testing.assert_array_equal(png.read_png(path), img[:, :, :3])
    assert torch.equal(torch.as_tensor(png.decode_png(path.read_bytes())),
                       torch.as_tensor(img[:, :, :3]))
