"""The port's evaluation CLIs against the root scripts they stand for, on the
CPU: ``python -m reduced3dgs_torch.full_eval`` (--dry_run: root
full_eval.py's command list with the port's CLIs and --device),
``generate_results`` (root generate_results.py's rows on one model
directory, without pandas) and ``update_old_ply_format`` (root's output
file byte for byte)."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import full_eval as root_full_eval
import generate_results as root_generate_results
import update_old_ply_format as root_update
from chip_smoke import quantile_codebooks
from reduced3dgs_torch import full_eval, generate_results
from reduced3dgs_torch import update_old_ply_format as update
from reduced3dgs_torch.data.ply import write_ply
from reduced3dgs_tpu.models import ply_io as jply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = {"train.py": "train", "render.py": "render",
            "metrics.py": "metrics"}


def _root_commands(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["full_eval.py", *argv])
    root_full_eval.main()
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("argv", [
    ["--dry_run"],
    ["--dry_run", "-e", "baseline", "mercy_type_opacity", "-s", "garden",
     "truck", "--skip_measure_fps", "--output_path", "/x/eval"],
    ["--dry_run", "--custom_scene", "/data/my_scene/", "--iterations", "30",
     "--skip_metrics"],
])
def test_full_eval_dry_run_is_roots_with_the_port_clis(monkeypatch, capsys,
                                                        argv):
    want = _root_commands(monkeypatch, capsys, argv)
    assert want
    full_eval.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    swapped = []
    for cmd in want:
        script = cmd.split()[1]
        swapped.append(cmd.replace(
            f"python {script}",
            f"{sys.executable} -m reduced3dgs_torch.{PORT_CLI[script]}", 1)
            + " --device cpu")
    assert got == swapped


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory with the four stored variants (written by the
    JAX package), results.json and fps_results.json."""
    root = tmp_path_factory.mktemp("eval_clis")
    rng = np.random.default_rng(8)
    n = 300
    arrs = {"xyz": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            "features_dc": rng.normal(0, 1, (n, 1, 3)).astype(np.float32),
            "features_rest": rng.normal(0, 0.2, (n, 15, 3)).astype(
                np.float32),
            "opacity": rng.normal(0, 1, (n, 1)).astype(np.float32),
            "scaling": rng.normal(-3, 0.5, (n, 3)).astype(np.float32),
            "rotation": rng.normal(0, 1, (n, 4)).astype(np.float32),
            "degrees": rng.integers(0, 4, n).astype(np.int32)}
    pool = jply.pool_from_arrays(arrs)
    books = quantile_codebooks({k: v for k, v in arrs.items()
                                if k not in ("xyz", "degrees")})
    model = root / "model"
    pc = model / "point_cloud" / "iteration_30"
    pc.mkdir(parents=True)
    for name, kw in (("point_cloud.ply", {}),
                     ("point_cloud_quantised.ply", dict(quantised=True)),
                     ("point_cloud_quantised_half.ply",
                      dict(quantised=True, half_float=True)),
                     ("point_cloud_quantised_pack.ply",
                      dict(quantised=True, half_float=True,
                           xyz_codec="u16c"))):
        jply.save_gaussian_ply(str(pc / name), pool, books if kw else None,
                               **kw)
    results = {f"test_{v}/ours_30": {"SSIM": 0.9 - i / 10, "PSNR": 30.0 + i,
                                     "LPIPS": 0.1 * i}
               for i, v in enumerate(("baseline", "quantised_half"))}
    results["train_baseline/ours_30"] = {"SSIM": 0.5, "PSNR": 9.0,
                                         "LPIPS": 0.5}
    (model / "results.json").write_text(json.dumps(results))
    (model / "fps_results.json").write_text(json.dumps(
        {"baseline": 120.5, "quantised_half": 150.25}))
    return str(model)


def _csv_rows(path):
    """The CSV's rows, numbers as floats (pandas writes 1.0 where the
    port writes 1 only in columns that hold no value in some row)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))

    def value(v):
        try:
            return float(v)
        except ValueError:
            return v

    return [{k: value(v) for k, v in r.items()} for r in rows]


def test_generate_results_rows_are_roots(model_dir, monkeypatch, capsys):
    summary = os.path.join(os.path.dirname(model_dir), "summary.csv")
    monkeypatch.setattr(sys, "argv", ["generate_results.py", "-m",
                                      model_dir, "--iteration", "30"])
    root_generate_results.main()
    want = _csv_rows(summary)
    os.remove(summary)
    r = subprocess.run([sys.executable, "-m",
                        "reduced3dgs_torch.generate_results", "-m",
                        model_dir, "--iteration", "30"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = _csv_rows(summary)
    assert len(got) == len(want) == 4
    assert [list(g) for g in got] == [list(w) for w in want]
    assert got == want  # an empty cell (no value) stays "" on both sides
    assert "quantised_pack" in r.stdout and "Written" in r.stdout
    recs = generate_results.records([model_dir], 30)
    assert recs[2]["fps"] == 150.25 and recs[2]["PSNR"] == 31.0


def test_update_old_ply_format_is_roots(tmp_path):
    rng = np.random.default_rng(9)
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(45)]
             + ["opacity"] + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    v = np.empty(77, dtype=[(n, "<f4") for n in names])
    for n in names:
        v[n] = rng.normal(0, 1, 77)
    old = tmp_path / "old.ply"
    write_ply(str(old), [("vertex", v)])
    root_update.convert_ply(str(old), str(tmp_path / "root.ply"))
    update.main(["-m", str(old), "-o", str(tmp_path / "port.ply")])
    assert ((tmp_path / "root.ply").read_bytes()
            == (tmp_path / "port.ply").read_bytes())
    # without -o the input is rewritten in place
    update.convert_ply(str(old))
    assert old.read_bytes() == (tmp_path / "root.ply").read_bytes()
    with pytest.raises(ValueError, match="no 'vertex'"):
        update.convert_ply(str(old))
    assert update.infer_max_sh_order(59) == 3 and \
        update.infer_max_sh_order(14) == 0
