"""The port's profiling tools against root's scripts and the JAX package,
on the CPU at small sizes: reduced3dgs_torch.profile_components,
profile_trace (its chained step and its reader), microbench_binning and
microbench_gather.

The JAX side is root profile_trace.py's own jitted loop (build_step:
bench's draws, the camera at (0, 0, -3.6), L1 against a zero target, the
five gradients, the Pallas kernels in interpret mode), whose one-iteration
run is root profile_components.py's fwd+bwd step.  Tolerances: the image
at the render tolerance (atol 2e-5 / rtol 1e-4, tests/test_tile_render.py),
num_rendered exactly, the loss rtol 1e-5, gradients leaf by leaf atol
2e-4 max|g| / rtol 2e-3 (tests/test_torch_train.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import profile_trace as root_trace
import pytest
import torch

from reduced3dgs_torch import graphs
from reduced3dgs_torch import microbench_binning as mbin
from reduced3dgs_torch import microbench_gather as mgat
from reduced3dgs_torch import profile_components as pcomp
from reduced3dgs_torch import profile_trace as ptrace
from reduced3dgs_torch.bench import FwdBwd, bench_arrays

W = H = 64
N = 1 << 10
BUDGET = 1 << 13


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small CPU runs share the machine with
    the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_loop():
    """Root's jitted loop at the small size and profile_components'
    scales, with its leaves, and its runs of one and two iterations from
    a zero carry."""
    run, args = root_trace.build_step(W, H, N, BUDGET, *pcomp.SCALES)
    return args, [run(k, 0.0, *args) for k in (1, 2)]


def _grads_close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=2e-3, atol=2e-4 * max(np.abs(b).max(), 1e-12),
            err_msg=f"{what}: gradient {i}")


def test_components_draw_roots_scene(jax_loop):
    """profile_components' leaves are root's default_rng(0) draws (root
    profile_components.py and profile_trace.py draw alike)."""
    args, _ = jax_loop
    comp = pcomp.Components(W, H, N, BUDGET, "cpu")
    for a, b in zip(comp.leaves, args):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    np.testing.assert_array_equal(comp.degrees.numpy(), np.full(N, 3))
    np.testing.assert_array_equal(
        bench_arrays(N, *pcomp.SCALES)[0], np.asarray(args[0]))


def test_components_match_jax_render(jax_loop):
    """The forward stage's image and num_rendered against the JAX render
    (backend "pallas"), the fwd+bwd stage's loss, num_rendered and five
    gradients against root's step; each stage as its runner replays it."""
    from reduced3dgs_tpu.cameras import Camera
    from reduced3dgs_tpu.renderer import render

    args, ((l1, nr1, g1), _) = jax_loop
    comp = pcomp.Components(W, H, N, BUDGET, "cpu")
    runs = {s: graphs.runner(getattr(comp, s), "cpu") for s in pcomp.STAGES}
    for run in runs.values():
        run.replay()
    cp = Camera.look_at(eye=(0, 0, -3.6), target=(0, 0, 0), width=W,
                        height=H).params()
    out = render(*args, jnp.full(N, 3, jnp.int32), cp, jnp.zeros(3),
                 width=W, height=H, instance_budget=BUDGET, backend="pallas")
    color, nr = runs["forward"].out
    assert int(nr) == int(out.num_rendered) == int(nr1) <= BUDGET
    np.testing.assert_allclose(color.numpy(), np.asarray(out.color),
                               atol=2e-5, rtol=1e-4)
    b = runs["binning"].out
    assert int(b.num_rendered) == int(nr)
    assert runs["preprocess"].out.radii.shape == (N,)
    loss, nr2, grads = runs["step"].out
    assert int(nr2) == int(nr)
    np.testing.assert_allclose(float(loss), float(l1), rtol=1e-5)
    _grads_close(grads, g1, "profile_components step")


def test_chained_step_matches_root_loop(jax_loop):
    """profile_trace's step (bench.FwdBwd chained) over two iterations
    from a zero carry (xyz + 1e-30 * l_prev) against root's loop of two
    iterations."""
    args, (_, (l2, nr2, g2)) = jax_loop
    chain = FwdBwd(W, H, N, *pcomp.SCALES, BUDGET, "cpu", "f32",
                   chained=True)
    run = chain.runner()
    chain.carry.zero_()
    for _ in range(2):
        run.replay()
    loss, nr, grads = run.out
    assert int(nr) == int(nr2)
    np.testing.assert_allclose(float(loss), float(l2), rtol=1e-5)
    _grads_close(grads, g2, "profile_trace chain")


def test_trace_reader_on_a_cpu_trace(tmp_path, monkeypatch):
    """profile_trace's body on the CPU: the Chrome trace is written to the
    log directory and read back as root's table (a line per thread, its
    busy time within its span, the top ops and "(other N ops)")."""
    monkeypatch.delenv("R3DGS_GRAD_REDUCE", raising=False)
    lines = []
    trace = ptrace.run(32, 32, 256, 4096, 1, *pcomp.SCALES, "cpu",
                       logdir=str(tmp_path), printer=lines.append, top=5)
    text = "\n".join(lines)
    assert lines[0].startswith("num_rendered=") and "grad_reduce=f32" in text
    assert lines[1].startswith("wall: ") and "px/s" in lines[1]
    assert "-- line: 'cpu thread" in text and "(other " in text
    assert (tmp_path / "trace.json").exists()
    main = trace.lines[0]
    assert 0 < main.busy_ms <= main.span_ms * 1.01
    assert len(main.ops) > 50 and main.ops == sorted(main.ops, reverse=True)
    assert sum(r[0] for r in trace.kernel_rows()) == pytest.approx(
        trace.busy_ms)


def test_trace_reader_on_device_lines(tmp_path):
    """A card's trace: one line per CUDA stream (kernels, copies and sets,
    not the annotations), durations summed per name and divided by the
    iterations, the span from first start to last end, and the host's
    runtime calls counted."""
    ev = [dict(ph="X", cat="kernel", name="k1", ts=0.0, dur=3.0,
               args={"device": 0, "stream": 7}),
          dict(ph="X", cat="kernel", name="k1", ts=10.0, dur=5.0,
               args={"device": 0, "stream": 7}),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoD", ts=4.0,
               dur=2.0, args={"device": 0, "stream": 7}),
          dict(ph="X", cat="kernel", name="k2", ts=1.0, dur=1.0,
               args={"device": 0, "stream": 9}),
          dict(ph="X", cat="gpu_user_annotation", name="scope", ts=0.0,
               dur=20.0, args={"device": 0, "stream": 7}),
          dict(ph="X", cat="cuda_runtime", name="cudaGraphLaunch", ts=0.0,
               dur=1.0),
          dict(ph="X", cat="cpu_op", name="aten::add", ts=0.0, dur=1.0),
          dict(ph="f", cat="ac2g", name="flow", ts=0.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    trace = ptrace.read_trace(str(path), iters=2)
    assert [ln.name for ln in trace.lines] == ["device 0 stream 7",
                                               "device 0 stream 9"]
    s7 = trace.lines[0]
    assert s7.ops == [(4e-3, 1.0, "k1"), (1e-3, 0.5, "Memcpy DtoD")]
    assert s7.busy_ms == pytest.approx(5e-3)
    assert s7.span_ms == pytest.approx(7.5e-3)
    assert trace.host_calls == {"cudaGraphLaunch": 1}
    assert trace.kernel_rows()[0] == (4e-3, 1.0, "k1")
    lines = []
    ptrace.print_table(trace, lines.append, top=1)
    assert any("(other 1 ops)" in ln for ln in lines)


@jax.jit
def _jax_rows(d):
    """Root microbench_binning.py's rows on the arrays of `d`, each with
    all of its sort's outputs (one jitted program)."""
    tile, dkey, gid, pad = (d[k] for k in ("tile", "dkey", "gid", "pad"))
    rows5, f32 = d["rows5"], d["f32"]
    b, p = tile.shape[0], rows5.shape[0]
    ar = jnp.arange(1024, dtype=jnp.int32)
    return {
        "sort1key_1M": jax.lax.sort((dkey,), num_keys=1)[0],
        "sort1key_stable_1M": jax.lax.sort((dkey,), num_keys=1,
                                           is_stable=True)[0],
        "sort2key+1pay_1M": jax.lax.sort((tile, dkey, gid), num_keys=2,
                                         is_stable=True),
        "sort2key+2pay_1M": jax.lax.sort((tile, dkey, gid, pad),
                                         num_keys=2, is_stable=True),
        "sort1key+2pay_1M": jax.lax.sort((dkey, gid, pad), num_keys=1,
                                         is_stable=True),
        "argsort_1M": jnp.argsort(dkey),
        "rowgather_1M_x5": rows5[gid],
        "gather1d_1M": f32[gid % b],
        "scatter_max_P": jnp.zeros((b,), jnp.int32).at[gid].max(
            jnp.arange(b, dtype=jnp.int32) % p, mode="drop"),
        "assoc_scan_max_1M": jax.lax.associative_scan(jnp.maximum, tile),
        "cumsum_1M": jnp.cumsum(tile),
        "searchsorted_1k_in_1M": jnp.searchsorted(dkey, ar),
        "searchsorted_1M_in_1k": jnp.searchsorted(ar, tile),
    }


def _as_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def test_binning_rows_match_jax_rows():
    """Every row at B = 2^12 (P = 2^9) computes its JAX row's output:
    the sorts all their sorted operands (two keys as one int64 key), the
    stable argsort, gathers, the scatter-max, cummax for the associative
    scan, an int32 cumsum.  Where root's rows are at fault: sort64key
    against numpy's stable sort of the real int64 key; searchsorted of the
    unsorted dkey compared on a sorted copy only."""
    d = mbin.draws(1 << 12, 1 << 9)
    got = {k: fn() for k, fn in mbin.rows(mbin.on_device(d, "cpu")).items()}
    assert len(got) == 14
    want = _jax_rows(d)
    for name, w in want.items():
        if name == "searchsorted_1k_in_1M":
            continue
        g = _as_list(got[name])
        w = _as_list(w)
        assert len(g) == len(w), name
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert got["cumsum_1M"].dtype == torch.int32
    key = (d["tile"].astype(np.int64) << 32) | d["dkey"].astype(np.int64)
    perm = np.argsort(key, kind="stable")
    for a, b in zip(got["sort64key+2pay_1M"],
                    (key[perm], d["gid"][perm], d["pad"][perm])):
        np.testing.assert_array_equal(a.numpy(), b)
    d_sorted = dict(d, dkey=np.sort(d["dkey"]))
    row = mbin.rows(mbin.on_device(d_sorted, "cpu"))["searchsorted_1k_in_1M"]
    np.testing.assert_array_equal(row().numpy(), np.asarray(jnp.searchsorted(
        jnp.asarray(d_sorted["dkey"]), jnp.arange(1024, dtype=jnp.int32))))


def test_reference_sort64key_is_dkey():
    """Root's sort64key row without jax_enable_x64: tile.astype(int64)
    stays int32 and << 32 leaves it (XLA masks the shift count), so the
    key equals dkey and the row sorts dkey; the port's key does not."""
    assert not jax.config.jax_enable_x64
    d = mbin.draws(1 << 12, 1 << 9)
    tile, dkey = jnp.asarray(d["tile"]), jnp.asarray(d["dkey"])
    key64 = (tile.astype(jnp.int64) << 32) | dkey.astype(jnp.int64)
    assert key64.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(key64), d["dkey"])
    port = mbin.rows(mbin.on_device(d, "cpu"))["sort64key+2pay_1M"]()[0]
    assert port.dtype == torch.int64 and not np.array_equal(
        np.sort(d["dkey"]), port.numpy())


@pytest.mark.parametrize("width,name", [(9, "float32"), (3, "int32"),
                                        (9, "bfloat16")])
def test_gather_sums_match_numpy(width, name):
    """microbench_gather's loop at small P and B against a numpy
    gather-sum of the same table: int32 sums wrap alike and are exact,
    float sums within rtol 1e-5 of float64; its timed row runs."""
    dtype = getattr(torch, name)
    p, b, iters = 257, 1000, 3
    table, idx = mgat.make_inputs(width, dtype, p, b, "cpu")
    got = float(mgat.gather_sums(table, idx, iters))
    tnp, inp = table.to(torch.float32 if name != "int32" else torch.int32)\
        .numpy(), idx.numpy().astype(np.int64)
    if name == "int32":
        want = np.float32(0)
        for i in range(iters):
            want += np.float32(tnp[(inp + i) % p].sum(dtype=np.int32))
        assert got == float(want)
    else:
        want = sum(tnp[(inp + i) % p].astype(np.float64).sum()
                   for i in range(iters))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    per_iter, total = mgat.bench_row(width, dtype, "cpu", p, b, iters, 1)
    assert per_iter > 0 and total == got
