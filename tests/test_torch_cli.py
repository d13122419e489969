"""Port parity: the serving CLI slice on a tiny Blender-style scene.

A JAX pool is saved with the JAX ``save_gaussian_ply`` (plain,
quantised_half, and quantised_pack with the u16c xyz codec); the port's
loader must read the same arrays bit for bit, and
``python -m reduced3dgs_torch.render --device cpu`` must write PNGs within
one 8-bit level of JAX renders of the same cameras, plus fps_results.json.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image
from test_cli_e2e import REPO, make_blender_dataset
from test_tile_render import make_scene

from chip_smoke import quantile_codebooks
from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.models import ply_io as tply
from reduced3dgs_tpu import config as jconfig
from reduced3dgs_tpu.models import ply_io as jply
from reduced3dgs_tpu.renderer import render as jrender
from reduced3dgs_tpu.scene import Scene as JScene

VARIANTS = {
    # name: (file name, save kwargs, load kwargs)
    "baseline": ("point_cloud.ply", {}, {}),
    "quantised_half": ("point_cloud_quantised_half.ply",
                       dict(quantised=True, half_float=True),
                       dict(quantised=True, half_float=True)),
    "quantised_pack": ("point_cloud_quantised_pack.ply",
                       dict(quantised=True, half_float=True,
                            xyz_codec="u16c"),
                       dict(quantised=True, half_float=True)),
}
ITER = 7


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    src = os.path.join(root, "scene")
    make_blender_dataset(src)
    xyz, feats, scales, rots, opac, deg = (np.asarray(a) for a in
                                           make_scene(seed=4, n=200))
    arrs = {"xyz": xyz * 0.6, "features_dc": feats[:, :1],
            "features_rest": feats[:, 1:], "opacity": opac[:, None],
            "scaling": scales, "rotation": rots, "degrees": deg}
    pool = jply.pool_from_arrays(arrs)
    leaves = {"features_dc": pool.params.features_dc,
              "features_rest": pool.params.features_rest,
              "opacity": pool.params.opacity,
              "scaling": pool.params.scaling,
              "rotation": pool.params.rotation}
    books = quantile_codebooks({k: np.asarray(v) for k, v in leaves.items()})
    model = os.path.join(root, "model")
    pc = os.path.join(model, "point_cloud", f"iteration_{ITER}")
    for fname, save_kw, _ in VARIANTS.values():
        jply.save_gaussian_ply(os.path.join(pc, fname), pool,
                               books if save_kw else None, **save_kw)
    with open(os.path.join(model, "cfg_args"), "w") as f:
        f.write(f"Namespace(source_path={src!r}, model_path={model!r}, "
                "sh_degree=3, images='images', resolution=-1, "
                "white_background=False, data_device='cuda', eval=True, "
                "backend='pallas')")
    return model


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_loader_bit_identical(model_dir, variant):
    fname, _, load_kw = VARIANTS[variant]
    path = os.path.join(model_dir, "point_cloud", f"iteration_{ITER}", fname)
    want = jply.load_gaussian_ply(path, **load_kw)
    got = tply.load_gaussian_ply(path, **load_kw)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pool = tply.pool_from_arrays(got, "cpu")
    jpool = jply.pool_from_arrays(want)
    assert pool.capacity == jpool.capacity
    np.testing.assert_array_equal(pool.params.xyz.numpy(),
                                  np.asarray(jpool.params.xyz))
    np.testing.assert_array_equal(pool.alive.numpy(), np.asarray(jpool.alive))


def test_render_cli_matches_jax(model_dir):
    models = ["baseline", "quantised_half"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "reduced3dgs_torch.render", "-m", model_dir,
         "--device", "cpu", "--models", *models],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(os.path.join(model_dir, "fps_results.json")) as f:
        fps = json.load(f)
    assert sorted(fps) == sorted(models) and all(v > 0 for v in fps.values())

    args = jconfig.extract_model(jconfig.get_combined_args(
        _jax_parser(), ["-m", model_dir]))
    scene = JScene(args, load_iteration=-1, shuffle=False)
    assert scene.loaded_iter == ITER
    bg = jnp.zeros(3)
    checked = 0
    for model in models:
        _, _, load_kw = VARIANTS[model]
        pool = scene.load_model(**load_kw)
        for split, cams in (("train", scene.get_train_cameras()),
                            ("test", scene.get_test_cameras())):
            out_dir = os.path.join(model_dir, split, model, f"ours_{ITER}")
            for idx, cam in enumerate(cams):
                out = jrender(
                    pool.params.xyz, pool.features(), pool.params.scaling,
                    pool.params.rotation, pool.params.opacity[:, 0],
                    pool.degrees, cam.params(), bg, width=cam.width,
                    height=cam.height, instance_budget=4096,
                    alive_mask=pool.alive, backend="pallas")
                want = (np.clip(np.asarray(out.color), 0, 1) * 255).astype(
                    np.uint8)
                with Image.open(os.path.join(out_dir, "renders",
                                             f"{idx:05d}.png")) as im:
                    got = np.asarray(im)
                assert got.shape == want.shape and want.max() > 50
                diff = np.abs(got.astype(int) - want.astype(int)).max()
                assert diff <= 1, (model, split, idx, diff)
                assert os.path.exists(os.path.join(out_dir, "gt",
                                                   f"{idx:05d}.png"))
                checked += 1
    assert checked == 2 * 6


def _jax_parser():
    from argparse import ArgumentParser

    parser = ArgumentParser()
    jconfig.add_model_params(parser, fill_none=True)
    return parser


def test_variable_sh_bands_renders_the_dense_images(model_dir):
    """--variable_sh_bands (the pool reordered by degree, colours from the
    ragged blocks) writes the images of the dense path within one 8-bit
    level; the scene's degrees are mixed 0..3."""
    from reduced3dgs_torch.render import main

    def read(split):
        d = os.path.join(model_dir, split, "quantised_half", f"ours_{ITER}",
                         "renders")
        imgs = []
        for name in sorted(os.listdir(d)):
            with Image.open(os.path.join(d, name)) as im:
                imgs.append(np.asarray(im).astype(int))
        return np.stack(imgs)

    common = ["-m", model_dir, "--device", "cpu", "--skip_train",
              "--skip_measure_fps", "--models", "quantised_half"]
    main(common)
    dense = read("test")
    main(common + ["--variable_sh_bands"])
    ragged = read("test")
    assert dense.shape == ragged.shape and dense.max() > 50
    assert np.abs(dense - ragged).max() <= 1
