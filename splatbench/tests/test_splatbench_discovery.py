"""BENCHMARK.json's names resolve to files, and a new cell, configuration,
traffic mix and per-layer metric need only new files and entries."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from splatbench.run import CHECKOUT, HERE, Bench, layer_reader

NAME = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def test_every_name_resolves_to_its_file():
    bench = Bench()
    spec = bench.spec
    for cell in spec["workloads"]:
        assert bench.config(cell)["name"] == cell["config"]
        traffic = bench.traffic(cell)
        assert (HERE / "generators" / f"{traffic['generator']}.py").is_file()
        assert set(bench.limits(cell)) >= {"frame_mean_gap"} or set(
            bench.limits(cell)) >= {"loss_gap"}
        assert bench.per_layer(cell), cell["name"]
        assert any(m["name"] == "setup_s" for m in bench.end_to_end(cell))
    for metric in spec["per_layer"]:
        assert callable(layer_reader(metric["name"]))


def test_benchmark_json_keeps_the_contract():
    spec = Bench().spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["splatbench"]
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"] + spec["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert set(n) <= NAME and len(n) <= 64 and n[0] not in ".-"
    for c in spec["configs"]:
        assert (CHECKOUT / c["file"]).is_file()
        assert c["file"].startswith("splatbench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert 0.01 <= min(m["bound"] for m in e2e.values())
    assert max(m["bound"] for m in e2e.values()) <= 0.25
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    assert all(w["chips"] == 1 for w in spec["workloads"])
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_new_cell_needs_only_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a per-layer
    metric and a cell as files and entries, and run the new cell at a
    small size on the CPU through the unchanged harness."""
    shutil.copytree(HERE, tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    new = tmp_path / "splatbench"
    cfg = json.loads((new / "configs" / "tnt_reduced_dense.json").read_text())
    cfg["name"] = "tnt_probe"
    (new / "configs" / "tnt_probe.json").write_text(json.dumps(cfg))
    traffic = json.loads((new / "traffic" / "view.json").read_text())
    traffic["check_frames"] = 2
    (new / "traffic" / "view_probe.json").write_text(json.dumps(traffic))
    (new / "limits" / "tnt_probe.view_probe.json").write_text(
        (new / "limits" / "tnt_reduced_dense.view.json").read_text())
    (new / "layer_metrics" / "frames_probe.view.py").write_text(
        "def read(record, trace):\n    return float(record['frames'])\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tnt_probe", "source": "a copy",
                            "file": "splatbench/configs/tnt_probe.json",
                            "reduced": [], "why": "a probe"})
    spec["workloads"].append({"name": "tnt_probe.view_probe",
                              "config": "tnt_probe", "traffic": "view_probe",
                              "chips": 1, "why": "a probe"})
    for m in spec["end_to_end"]:
        if m["name"] in ("render_fps", "frame_ms_p95"):
            m["workloads"].append("tnt_probe.view_probe")
    spec["per_layer"].append({"name": "frames_probe.view", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "render_fps",
                              "workloads": ["tnt_probe.view_probe"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    script = textwrap.dedent("""
        import json, sys, torch
        torch.set_num_threads(2)
        from splatbench import run
        from splatbench.tests import tiny
        assert run.HERE.parent == __import__("pathlib").Path.cwd()
        bench = run.Bench()
        cell = bench.cell("tnt_probe.view_probe")
        assert bench.config(cell)["name"] == "tnt_probe"
        cfg = tiny.config("tnt_probe")
        traffic = tiny.traffic("view_probe", check_frames=2, check_from=2)
        out = run.measure(bench, cell, 3, 1.0, True, torch.device("cpu"),
                          cfg=cfg, traffic=traffic)
        line, _ = run.result_line(bench, cell, out, bench.limits(cell), True,
                                  1.0, {"platform": "cpu"})
        print(json.dumps(line))
    """)
    # the copy's splatbench comes first; the program from the checkout
    env = dict(os.environ, PYTHONPATH=str(CHECKOUT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line
    assert line["metrics"]["frames_probe.view"]["value"] >= 1
