"""The last line's contract, the refusal without a card, and the imports:
nothing the benchmark runs is JAX or the JAX package, and the reference
takes nothing of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from splatbench import run
from splatbench.record import Outcome
from splatbench.run import CHECKOUT, HERE, Bench

FORBIDDEN = {"jax", "jaxlib", "flax", "reduced3dgs_tpu"}


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_the_benchmark_runs_imports_jax_or_its_package():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for path in files:
        found = _top_level_imports(path) & FORBIDDEN
        assert not found, (path, found)


def test_the_reference_takes_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        names = _top_level_imports(path)
        assert "reduced3dgs_torch" not in names, path
        assert not names & FORBIDDEN, path


def test_a_run_loads_no_forbidden_module():
    """A whole small run in a fresh process leaves no module whose
    top-level name is JAX's or its package's (compared whole: the
    program's name begins with the JAX package's)."""
    script = (
        "import torch, sys\n"
        "from splatbench import run\n"
        "from splatbench.tests import tiny\n"
        "b = run.Bench(); cell = b.cell('tnt_reduced_dense.train')\n"
        "run.measure(b, cell, 1, 0.1, False, torch.device('cpu'),\n"
        "            cfg=tiny.config('tnt_reduced_dense'),\n"
        "            traffic=tiny.traffic('train'))\n"
        "print(run.forbidden_modules())\n"
        "print('reduced3dgs_torch' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300,
                         env={"OMP_NUM_THREADS": "2", "PATH": "/usr/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-2:] == ["[]", "True"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "reduced3dgs_tpu_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "reduced3dgs_tpu.ops", sys)
    assert run.forbidden_modules() == ["reduced3dgs_tpu"]


def test_result_line_keys_and_order():
    bench = Bench()
    cell = bench.cell("tnt_reduced_dense.view")
    out = Outcome(0.0, {"render_fps": 100.5, "frame_ms_p95": 9.25},
                  {"kind": "view"}, {"pool_gap": 0.0, "frame_mean_gap": 1e-7,
                                     "frame_max_gap": 0.5},
                  400, 0, 123)
    line, checks = run.result_line(bench, cell, out, bench.limits(cell),
                                   False, 12.5, {"platform": "gpu",
                                                 "kind": "X", "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is False  # frame_max_gap over its limit
    assert line["metrics"] == {
        "setup_s": {"value": 12.5, "unit": "s"},
        "render_fps": {"value": 100.5, "unit": "frames/s"},
        "frame_ms_p95": {"value": 9.25, "unit": "ms"}}
    assert line["device"]["memory_peak_bytes"] == 123
    assert line["checks"]["frame_max_gap"] == {"value": 0.5, "limit": 0.05}
    assert checks[-1] == "check frame_max_gap 0.5 limit 0.05"
    json.dumps(line)


def test_a_number_without_a_limit_fails():
    from splatbench.judge import verdict

    assert verdict({"a": 1.0}, {"a": 1.0})[0] is True
    assert verdict({"a": 1.0, "frames_missing": 2.0}, {"a": 1.0})[0] is False
    assert verdict({"a": float("nan")}, {"a": 1.0})[0] is False


def test_no_card_no_result(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for var in ("OMP_NUM_THREADS", "TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    rc = run.main(["--workload", "tnt_reduced_dense.view", "--seed", "1",
                   "--seconds", "1"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_files_are_not_enough(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's folder alone
    exits non-zero and prints no result."""
    shutil.copytree(HERE, tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    # the command with this interpreter in place of "python3"
    command = [sys.executable] + spec["command"][1:]
    res = subprocess.run(command + ["--workload", "tnt_reduced_dense.view",
                                    "--seed", "1", "--seconds", "1",
                                    "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    """One short run of each kind of cell on the card: the last line is
    the contract's and `correct` holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for cell in ("tnt_reduced_dense.view", "tnt_reduced_dense.train"):
        res = subprocess.run(
            [sys.executable] + spec["command"][1:]
            + ["--workload", cell, "--seed", str(2 ** 31 + 5),
               "--seconds", "3", "--trace", "0"],
            cwd=CHECKOUT, capture_output=True, text=True, timeout=360)
        assert res.returncode == 0, res.stderr[-2000:]
        line = json.loads(res.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line["checks"]
        assert line["device"]["platform"] == "gpu"
        assert list(line)[-1] == "checks"
