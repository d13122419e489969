"""Rules of the PyTorch port that no parity test covers.

* The port and chip_smoke.py import neither jax nor reduced3dgs_tpu.
* Entry points raise without a card unless the CPU was asked for, and a
  kernel wrapper never falls back to its plain version on a CUDA tensor.
* chip_smoke.py's phases, rehearsed on the CPU at a tiny size; run without
  a card, or away from the repository, it exits non-zero with no result.
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "reduced3dgs_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "reduced3dgs_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            bad += [(path, m) for m in mods
                    if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_no_matplotlib_pandas_or_pillow_at_module_level():
    """The card's machine has no matplotlib, pandas or Pillow: the port
    never imports the first two, and Pillow only inside the functions
    that write JPEG frames and GIFs (or read images where no PNG codec of
    its own does).  The modules of the viewer bridge, the benchmark, the
    graphs, the evaluation CLIs and vis are among those checked."""
    files = _port_files()
    names = {os.path.relpath(f, REPO) for f in files}
    assert {os.path.join("reduced3dgs_torch", n) for n in (
        "bench.py", "graphs.py", "network_gui.py", "full_eval.py",
        "generate_results.py", "update_old_ply_format.py",
        os.path.join("utils", "vis.py"))} <= names
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        top = set(map(id, tree.body))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                if root in ("matplotlib", "pandas") or (
                        root == "PIL" and id(node) in top):
                    bad.append((path, node.lineno, m))
    assert not bad, bad


def test_no_card_needs_explicit_cpu():
    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.device import resolve

    cam = Camera.look_at(eye=(0, 0, -3), target=(0, 0, 0))
    assert resolve("cpu") == torch.device("cpu")
    assert cam.params("cpu").viewmatrix.device.type == "cpu"
    if torch.cuda.is_available():
        assert resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve(None)
        with pytest.raises(RuntimeError):
            cam.params()


def test_kernel_wrappers_never_fall_back():
    """On a tensor that is not on the CPU the wrappers launch their kernel
    or raise; here a 'meta' tensor must raise, not run a plain version."""
    from reduced3dgs_torch.ops import binning, tile_render

    kernels = (binning.EXPAND, tile_render.TILE_FWD, tile_render.TILE_BWD,
               tile_render.TILE_TRANS, tile_render.SEG_REDUCE_F32,
               tile_render.SEG_REDUCE_PACKED)
    before = [k.launches for k in kernels]
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        binning.bin_keys(meta, meta, meta, meta[:5], meta[:1], 2, 16, 32)
    feat = torch.empty((9, 128), device="meta")
    ranges = torch.empty((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tile_render.tile_fwd(feat, ranges, meta[:1], 1, 16, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        tile_render.tile_trans(feat, ranges, meta[:1], 1, 16, 16)
    pix = torch.empty((1, 8, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tile_render.tile_bwd(feat, ranges, meta[:1], 1, 16, 16, pix, pix)
    order = torch.empty(128, dtype=torch.int64, device="meta")
    for packed in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            tile_render.seg_reduce(feat, order, meta[:3], packed)
    assert [k.launches for k in kernels] == before


def test_chip_smoke_main_path_rehearsal(tmp_path, monkeypatch):
    """The main path of chip_smoke.py on the CPU at a tiny size: model
    files written and loaded through Scene/ply_io, a ring of views
    rendered up the budget ladder, FPS measured (over 4 frames here, not
    32: the CPU times nothing of the card); the plain versions run, so no
    kernel launch is counted."""
    import chip_smoke as cs
    from reduced3dgs_torch import render as trender
    from reduced3dgs_torch.ops import binning, tile_render

    monkeypatch.setattr(trender, "FPS_MIN_FRAMES", 4)

    before = (binning.EXPAND.launches, tile_render.TILE_FWD.launches)
    res = cs.main_path("cpu", str(tmp_path), 96, 64, 3000, (0.02, 0.08), 0,
                       n_views=2)
    for variant in ("baseline", "quantised_half"):
        r = res[variant]
        assert r["images"].shape == (2, 64, 96, 3)
        assert r["fps"] > 0 and r["frames"] == 2 * r["reps"] == 4
        assert max(r["num_rendered"]) <= min(r["budgets"])
    assert cs.psnr(res["baseline"]["images"],
                   res["quantised_half"]["images"]) > 12.0
    assert (binning.EXPAND.launches,
            tile_render.TILE_FWD.launches) == before


def test_chip_smoke_kernel_inputs_and_cases():
    import chip_smoke as cs
    from reduced3dgs_torch.ops import binning, tile_render

    names = []
    for name, case in cs.expand_cases():
        names.append(name)
        kw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in case.items()}
        out = binning.bin_keys_plain(**kw)
        assert out.shape == (case["b_pad"],) and out.dtype == torch.int64
        p, budget = case["counts"].size, case["budget"]
        tiles = case["pad_start"].size - 1
        # slots past nv: tile num_tiles, rank P, but for the pads that
        # spill there (rank P of a tile, then tile num_tiles); pads: rank
        # P of a tile
        past = out[int(case["nv"][0]):budget]
        unused = tiles * (p + 1) + p
        if name.startswith("padding spilled"):
            spilled = int((past != unused).sum())
            assert spilled > 0 and bool((past[spilled:] == unused).all())
            assert bool((past % (p + 1) == p).all())
        else:
            assert bool((past == unused).all())
        assert bool((out[budget:] % (p + 1) == p).all())
        if name == "empty":
            assert past.numel() == budget
    assert {"truncate", "empty", "P=0", "P=1"} <= set(names)
    _, b, k2in = cs.kernel_inputs("cpu", 64, 48, 2000, (0.02, 0.08), 8192)
    out, pairs = tile_render.tile_fwd_plain(*k2in, 4, 64, 48,
                                            count_pairs=True)
    assert cs.k2_ops(pairs) >= cs.K2_OPS_WALKED * pairs["walked"] > 0
    assert cs.compare_k2(out, out) == (0.0, 1.0)
    assert cs.bound(3.35e9, 0)[1] == "bytes"
    books = cs.quantile_codebooks(cs.make_arrays(500, (0.01, 0.02), 1))
    assert len(books) == 20 and all(
        c.centers.shape == (256, 1) for c in books.values())


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    for cwd in (REPO, str(lone)):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_colmap_text_roundtrip(tmp_path):
    """chip_smoke's COLMAP text writer + the port's reader give back the
    ring cameras' matrices."""
    import chip_smoke as cs
    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.data import dataset_readers as readers

    cams = cs.ring_cameras(160, 90, n_views=3)
    cs.write_colmap_text(str(tmp_path), cams)
    info = readers.read_colmap_scene(str(tmp_path))
    assert [c.image_name for c in info.train_cameras] == [
        c.image_name for c in cams]
    args = ModelParams(resolution=1)
    from reduced3dgs_torch.scene import Scene

    for ci, cam in zip(info.train_cameras, cams):
        back = Scene._make_camera(ci, 1.0, args, lazy=True)
        assert (back.width, back.height) == (160, 90)
        np.testing.assert_allclose(back.full_proj_transform,
                                   cam.full_proj_transform, atol=1e-5)


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A built library's name hashes its source and every csrc header it
    includes, so an edited header is never served by a stale library."""
    from reduced3dgs_torch.ops import _cuda

    for n in ("tile_bwd", "tile_fwd", "tile_trans"):
        assert {p.name for p in _cuda.source_files(n)} == {
            f"{n}.cu", "tile_walk.cuh"}
    assert [p.name for p in _cuda.source_files("expand")] == ["expand.cu"]
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    before = {n: _cuda.library_path(n) for n in _cuda.SOURCES}
    assert before == {n: _cuda.library_path(n) for n in _cuda.SOURCES}
    with open(csrc / "tile_walk.cuh", "ab") as f:
        f.write(b"\n// edited\n")
    after = {n: _cuda.library_path(n) for n in _cuda.SOURCES}
    for n in ("tile_fwd", "tile_bwd", "tile_trans"):
        assert after[n] != before[n]
    for n in ("expand", "seg_reduce"):
        assert after[n] == before[n]
    with open(csrc / "tile_fwd.cu", "ab") as f:
        f.write(b"\n// edited\n")
    assert _cuda.library_path("tile_fwd") != after["tile_fwd"]
    assert _cuda.library_path("tile_bwd") == after["tile_bwd"]


def test_walk_constants_mirror_the_kernel_sources(tmp_path, monkeypatch):
    """tile_render.walk_layout (read by the lane utilisation and staging
    counts) gives the tile-walk defaults that stand in csrc/, and follows
    an edit of them."""
    from reduced3dgs_torch.ops import _cuda
    from reduced3dgs_torch.ops import tile_render as ttr

    for source, ppts in (("tile_fwd", (1,)), ("tile_bwd", (1, 2, 4)),
                         ("tile_trans", (1,))):
        lay = ttr.walk_layout(source)
        assert lay["warp_shape"][0] * lay["warp_shape"][1] == 32
        assert lay["pixels_per_thread"] in ppts
        assert ttr.K % lay["batch"] == 0
        ttr.warp_pixels(lay["warp_shape"], lay["pixels_per_thread"])
    with pytest.raises(KeyError):
        _cuda.define_default("tile_fwd.cu", "TILE_FWD_NO_SUCH")
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    before = ttr.walk_layout("tile_bwd")
    text = (csrc / "tile_bwd.cu").read_text()
    old = f"#define TILE_BWD_PPT {before['pixels_per_thread']} "
    assert old in text
    (csrc / "tile_bwd.cu").write_text(
        text.replace(old, "#define TILE_BWD_PPT 4 "))
    head = (csrc / "tile_walk.cuh").read_text()
    old = f"#define WALK_WARP_W {before['warp_shape'][0]} "
    assert old in head
    (csrc / "tile_walk.cuh").write_text(
        head.replace(old, "#define WALK_WARP_W 16 "))
    assert ttr.walk_layout("tile_bwd") == dict(
        before, pixels_per_thread=4, warp_shape=(16, 2))
    assert ttr.walk_layout("tile_fwd")["warp_shape"] == (16, 2)


def test_variant_builds_get_their_own_library():
    """A build with -D flags (chip_smoke's expf builds of K2 and K4) is a
    library of its own; the default build's name does not change."""
    from reduced3dgs_torch.ops import _cuda

    expf = ("-DWALK_EXP2=0",)
    for n in ("tile_fwd", "tile_trans"):
        assert _cuda.library_path(n, expf) != _cuda.library_path(n)
        assert _cuda.library_path(n, ()) == _cuda.library_path(n)
    k = _cuda.Kernel("tile_trans", "tile_trans_launch", [], expf)
    assert k.defines == expf and k.launches == 0


def _code(path):
    """A CUDA source without its // comments."""
    with open(path) as f:
        return "\n".join(ln.split("//")[0] for ln in f)


def test_tile_trans_runs_on_the_shared_walk():
    """K4 walks as K2 does: the shared header, its blend decision and its
    exponent (no expf of its own), and no atomics."""
    csrc = os.path.join(REPO, "reduced3dgs_torch", "csrc")
    k4 = _code(os.path.join(csrc, "tile_trans.cu"))
    k2 = _code(os.path.join(csrc, "tile_fwd.cu"))
    assert '#include "tile_walk.cuh"' in k4
    assert "expf" not in k4 and "atomic" not in k4
    assert "pair_alpha(" in k4 and "pair_alpha(" in k2
    assert "Stage<kBatch, kThreads, 2>" in k4


def test_walk_layout_tile_trans_mirrors_the_sources(tmp_path, monkeypatch):
    """walk_layout("tile_trans") is K4's footprint as csrc/ defines it,
    read independently here, and follows an edit of its batch."""
    import re

    from reduced3dgs_torch.ops import _cuda
    from reduced3dgs_torch.ops import tile_render as ttr

    csrc = os.path.join(REPO, "reduced3dgs_torch", "csrc")
    head = open(os.path.join(csrc, "tile_walk.cuh")).read()
    k4 = open(os.path.join(csrc, "tile_trans.cu")).read()
    wide = int(re.search(r"#define WALK_WARP_W (\d+)", head).group(1))
    batch = int(re.search(r"#define TILE_TRANS_BATCH (\d+)", k4).group(1))
    assert ttr.walk_layout("tile_trans") == dict(
        warp_shape=(wide, 32 // wide), pixels_per_thread=1, batch=batch)
    copy = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, copy)
    monkeypatch.setattr(_cuda, "CSRC", copy)
    (copy / "tile_trans.cu").write_text(k4.replace(
        f"#define TILE_TRANS_BATCH {batch} ", "#define TILE_TRANS_BATCH 32 "))
    assert ttr.walk_layout("tile_trans")["batch"] == 32


def test_parallel_and_utils_import_no_jax():
    """parallel/ and utils/ are among the files the import rule reads, and
    importing them (what spawn_local's children import) loads neither jax
    nor reduced3dgs_tpu."""
    files = _port_files()
    for sub in ("parallel", "utils"):
        assert any(f"{os.sep}{sub}{os.sep}" in f for f in files), sub
    code = ("import sys; import reduced3dgs_torch.parallel.launch, "
            "reduced3dgs_torch.parallel.sharded, "
            "reduced3dgs_torch.utils.profiling; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


TOOLS = {
    "profile_components": ["32", "32", "256", "4096"],
    "profile_trace": ["32", "32", "256", "4096", "1"],
    "microbench_gather": ["--rows", "64", "--batch", "128", "--iters", "1"],
    "microbench_binning": ["--batch", "256", "--prims", "64"],
}


def test_profiling_tools_import_no_jax():
    """The four profiling tools are among the files the import rule reads,
    and importing them loads neither jax nor reduced3dgs_tpu."""
    names = {os.path.relpath(f, REPO) for f in _port_files()}
    assert {os.path.join("reduced3dgs_torch", f"{t}.py")
            for t in TOOLS} <= names
    code = ("import sys; "
            + "; ".join(f"import reduced3dgs_torch.{t}" for t in TOOLS)
            + "; print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_profiling_tool_runs_on_the_cpu_only_when_asked(tool, tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """python -m reduced3dgs_torch.<tool> ... --device cpu runs at a tiny
    size; without a card and without --device cpu it raises before any
    work."""
    import importlib

    mod = importlib.import_module(f"reduced3dgs_torch.{tool}")
    extra = ["--logdir", str(tmp_path)] if tool == "profile_trace" else []
    if tool == "profile_components":
        monkeypatch.setattr(mod, "REPS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert mod.main(TOOLS[tool] + ["--device", "cpu"] + extra) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu" and len(out) > 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(TOOLS[tool] + extra)
    assert not capsys.readouterr().out


QUALITY_EXPERIMENTS = ("half_float_ablation", "prune_finetune",
                       "grad_reduce_ab")


def test_quality_experiments_import_no_jax():
    """The three quality experiments are among the files the import rule
    reads, and importing them loads neither jax nor reduced3dgs_tpu."""
    names = {os.path.relpath(f, REPO) for f in _port_files()}
    assert {os.path.join("reduced3dgs_torch", f"{m}.py")
            for m in QUALITY_EXPERIMENTS} <= names
    code = ("import sys; "
            + "; ".join(f"import reduced3dgs_torch.{m}"
                        for m in QUALITY_EXPERIMENTS)
            + "; print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


@pytest.mark.parametrize("name", QUALITY_EXPERIMENTS)
def test_quality_experiment_needs_a_card_unless_asked(name, tmp_path,
                                                      monkeypatch, capsys):
    """Without a card, python -m reduced3dgs_torch.<name> raises before
    any work or output unless --device cpu is given (the CPU runs are in
    tests/test_torch_chip_rehearsal_tools.py's phase 20)."""
    import importlib

    mod = importlib.import_module(f"reduced3dgs_torch.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--root", str(tmp_path)])
    assert not capsys.readouterr().out
    assert os.listdir(tmp_path) == []


def test_profiling_scope_and_trace(tmp_path):
    """span names a range the torch.profiler trace holds (no NVTX on the
    CPU) and, while the profiler records, adds its host seconds and calls
    to the snapshot; off, it records nothing; stop_trace writes a Chrome
    trace."""
    import json

    from reduced3dgs_torch.utils import profiling

    profiling.reset()
    with profiling.span("scope_under_test"):
        pass
    assert profiling.snapshot()["spans"] == {}
    profiling.start_trace(str(tmp_path / "trace"))
    with profiling.span("scope_under_test"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = profiling.stop_trace()
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "scope_under_test" for e in events)
    spans = profiling.snapshot()["spans"]
    assert spans["scope_under_test"]["calls"] == 1
    assert spans["scope_under_test"]["s"] > 0
    profiling.reset()
    with pytest.raises(RuntimeError):
        profiling.stop_trace()


EVAL_SCRIPTS = ("compression_eval", "fps_table")


def test_evaluation_scripts_import_no_jax():
    """The two evaluation scripts are among the files the import rule
    reads, and importing them loads neither jax nor reduced3dgs_tpu."""
    names = {os.path.relpath(f, REPO) for f in _port_files()}
    assert {os.path.join("reduced3dgs_torch", f"{d}.py")
            for d in EVAL_SCRIPTS} <= names
    code = ("import sys; "
            + "; ".join(f"import reduced3dgs_torch.{d}"
                        for d in EVAL_SCRIPTS)
            + "; print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


@pytest.mark.parametrize("script", EVAL_SCRIPTS)
def test_evaluation_script_needs_card_or_explicit_cpu(script, tmp_path,
                                                      monkeypatch, capsys):
    """Without a card and without --device cpu a script raises before it
    writes or starts anything."""
    import importlib

    mod = importlib.import_module(f"reduced3dgs_torch.{script}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--root", str(tmp_path / "eval")])
    assert not capsys.readouterr().out
    assert not (tmp_path / "eval").exists()
