"""The port's timing experiments against the JAX package's scripts, on the
CPU at small sizes: reduced3dgs_torch.multicam_step, microbench_sort,
microbench_reduce, microbench_sortscale and microbench_scatter_pack.

Both packages get the same numpy draws (the scripts' default_rng(0)).
The JAX bodies are the scripts' own, copied here and run at l = 0 (their
chain(l, x) salt then adds nothing).  Tolerances: integer results and
the scatters bit for bit; float sums rtol 1e-5; the port's own rows
(its key sort + K5, on the plain version here) against float64 segment
sums within 2e-5 relative plus 1e-5 of the segment's sum of magnitudes
(chip_smoke.check_seg); the k-view step's loss rtol 1e-6, its five
gradients atol 2e-4 max|g| / rtol 2e-3 (the whole-render tolerance), and
root's update applied to the JAX gradients within float rounding (rtol
1e-6).  Many-step trajectories are not compared: root's sign-like update
turns a lost low digit into a whole step.
"""

import contextlib
import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch import graphs
from reduced3dgs_torch import microbench_reduce as mred
from reduced3dgs_torch import microbench_scatter_pack as mscat
from reduced3dgs_torch import microbench_sort as msort
from reduced3dgs_torch import microbench_sortscale as mscale
from reduced3dgs_torch import multicam_step as mcam

SB, SP = 4096, 512  # small slots and primitives
MODULES = ("multicam_step", "microbench_sort", "microbench_reduce",
           "microbench_sortscale", "microbench_scatter_pack")


def chain(l, x):
    return x + (l * 1e-30).astype(x.dtype)


def _at_zero(bodies):
    """Each root body jitted and run at l = 0."""
    return {name: np.asarray(jax.jit(body)(jnp.float32(0)))
            for name, body in bodies.items()}


def _jax_sort_rows(d):
    """experiments/microbench_sort.py's four bodies."""
    key0, cols = jnp.asarray(d["key"]), jnp.asarray(d["cols"])
    b = key0.shape[0]

    def body_a(l):
        cs = tuple(chain(l, cols[:, i]) for i in range(9))
        srt = jax.lax.sort((chain(l, key0).astype(jnp.int32),) + cs,
                           num_keys=1, is_stable=False)
        return sum(c.sum() for c in srt[1:])

    def body_b(l):
        iota = jnp.arange(b, dtype=jnp.int32)
        k, perm = jax.lax.sort(
            (chain(l, key0).astype(jnp.int32), iota), num_keys=1,
            is_stable=False)
        g = chain(l, cols[:, :9])[perm]
        return g.sum()

    def body_c(l):
        iota = jnp.arange(b, dtype=jnp.int32)
        k, perm = jax.lax.sort(
            (chain(l, key0).astype(jnp.int32), iota), num_keys=1,
            is_stable=False)
        g = chain(l, cols)[perm]
        return g[:, :9].sum()

    def body_d(l):
        srt = jax.lax.sort(chain(l, key0).astype(jnp.int32))
        return srt.sum().astype(jnp.float32)

    return _at_zero({"a_multi_payload_sort": body_a,
                     "b_perm_sort+gather9": body_b,
                     "c_perm_sort+gather16": body_c,
                     "d_key_only_sort": body_d})


def _jax_reduce_rows(d):
    """experiments/microbench_reduce.py's five bodies."""
    cols, zb = jnp.asarray(d["cols"]), jnp.asarray(d["zb"])
    key0 = jnp.asarray(d["key"])
    b = cols.shape[1]

    def body_a(l):
        cs = [chain(l, cols[i]) for i in range(9)]
        ps = jnp.stack(
            [jnp.concatenate([jnp.zeros((1,), jnp.float32), jnp.cumsum(c)])
             for c in cs], axis=1)  # (B+1, 9)
        v = ps[zb]
        d = v[1:] - v[:-1]
        return d.sum()

    def body_b(l):
        ps = jnp.cumsum(chain(l, cols), axis=1)  # (9, B)
        ps = jnp.concatenate([jnp.zeros((9, 1), jnp.float32), ps], axis=1)
        v = jnp.take(ps, zb, axis=1)  # (9, P+1)
        d = v[:, 1:] - v[:, :-1]
        return d.sum()

    def body_c(l):
        ps = jnp.cumsum(chain(l, cols), axis=1)  # (9, B) inclusive
        hi = jnp.take(ps, jnp.maximum(zb[1:] - 1, 0), axis=1)
        lo = jnp.take(ps, jnp.maximum(zb[:-1] - 1, 0), axis=1)
        d = jnp.where(zb[1:] > 0, hi, 0.0) - jnp.where(zb[:-1] > 0, lo, 0.0)
        return d.sum()

    def body_d(l):
        cs = tuple(chain(l, cols[i]) for i in range(9))
        srt = jax.lax.sort((chain(l, key0),) + cs, num_keys=1,
                           is_stable=False)
        return sum(c.sum() for c in srt[1:])

    ns = 17
    bs = b // ns

    def body_e(l):
        tot = jnp.float32(0)
        for s in range(ns):
            cs = tuple(chain(l, cols[i, s * bs:(s + 1) * bs])
                       for i in range(9))
            srt = jax.lax.sort((chain(l, key0[s * bs:(s + 1) * bs]),) + cs,
                               num_keys=1, is_stable=False)
            tot = tot + sum(c.sum() for c in srt[1:])
        return tot

    return _at_zero({"a_9cumsum_rowgather": body_a,
                     "b_1cumsum_take1": body_b,
                     "c_1cumsum_take2": body_c,
                     "d_one_big_sort": body_d,
                     "e_17_strip_sorts": body_e})


def _jax_sortscale_row(d):
    """experiments/microbench_sortscale.py's child body (ncols = 9)."""
    key0, cols = jnp.asarray(d["key"]), jnp.asarray(d["cols"])
    ncols = cols.shape[0]

    def body(l):
        cs = tuple(chain(l, cols[i]) for i in range(ncols))
        srt = jax.lax.sort((chain(l, key0),) + cs, num_keys=1,
                           is_stable=False)
        return sum(c.sum() for c in srt[1:]) if ncols else srt[0].sum() * 1.0

    return _at_zero({"ms": body})["ms"]


def _jax_scatter_rows(d, b):
    """experiments/microbench_scatter_pack.py's three functions at B =
    b."""
    pos, v1, v2 = (jnp.asarray(d[k]) for k in ("pos", "v1", "v2"))

    def two_s32(pos, v1, v2):
        a = jnp.zeros(b, jnp.int32).at[pos].add(v1, mode="drop")
        bb = jnp.zeros(b, jnp.int32).at[pos].add(v2, mode="drop")
        return a, bb

    def one_c64(pos, v1, v2):
        z = v1.astype(jnp.float32) + 1j * v2.astype(jnp.float32)
        return (jnp.zeros(b, jnp.complex64).at[pos].add(
            z.astype(jnp.complex64), mode="drop"),)

    def one_s32(pos, v1):
        return (jnp.zeros(b, jnp.int32).at[pos].add(v1, mode="drop"),)

    return {"one s32 scatter ": jax.jit(one_s32)(pos, v1),
            "two s32 scatters": jax.jit(two_s32)(pos, v1, v2),
            "one c64 scatter ": jax.jit(one_c64)(pos, v1, v2)}


def _port_rows(module_rows):
    return {name: fn() for name, fn in module_rows.items()}


def _float64_segment_sums(cols9, order, bounds):
    """(sums, sums of magnitudes), (9, P) float64, of segment r =
    cols9[:, order[bounds[r]:bounds[r + 1]]]."""
    p = bounds.shape[0] - 1
    sums = np.zeros((9, p))
    mags = np.zeros((9, p))
    vals = cols9.astype(np.float64)
    for r in range(p):
        seg = vals[:, order[bounds[r]:bounds[r + 1]]]
        sums[:, r] = seg.sum(axis=1)
        mags[:, r] = np.abs(seg).sum(axis=1)
    return sums, mags


def _check_segment_sums(got, cols9, order, bounds):
    sums, mags = _float64_segment_sums(cols9, order, bounds)
    err = np.abs(got.numpy().astype(np.float64) - sums)
    assert got.shape == sums.shape and got.dtype == torch.float32
    assert (err <= 2e-5 * np.abs(sums) + 1e-5 * mags + 1e-30).all(), \
        err.max()


def test_sort_rows_match_jax():
    """microbench_sort's four rows at B = 4096, P = 512 against root's
    bodies: the float sums rtol 1e-5, the key-only row's int32 sum bit
    for bit; its port_current row against the float64 segment sums of
    the key's segments."""
    d = msort.draws(SB, SP)
    got = _port_rows(msort.rows(msort.on_device(d, "cpu"), SP))
    want = _jax_sort_rows(d)
    assert list(got) == list(want) + ["port_current_key_sort+K5"]
    for name in ("a_multi_payload_sort", "b_perm_sort+gather9",
                 "c_perm_sort+gather16"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)
    assert float(got["d_key_only_sort"]) == float(want["d_key_only_sort"])
    order = np.argsort(d["key"], kind="stable")
    bounds = np.searchsorted(d["key"][order], np.arange(SP + 1))
    _check_segment_sums(got["port_current_key_sort+K5"],
                        d["cols"][:, :9].T, order, bounds)


def test_reduce_rows_match_jax():
    """microbench_reduce's five rows at B = 4096, P = 512 against root's
    bodies (rtol 1e-5); its port_current row (K5's plain version, the
    identity order, bounds that start past slot 0) against the float64
    segment sums."""
    d = mred.draws(SB, SP)
    assert d["zb"][0] > 0
    got = _port_rows(mred.rows(mred.on_device(d, "cpu")))
    want = _jax_reduce_rows(d)
    assert list(got) == list(want) + ["port_current_K5"]
    for name, w in want.items():
        np.testing.assert_allclose(float(got[name]), float(w), rtol=1e-5,
                                   err_msg=name)
    _check_segment_sums(got["port_current_K5"], d["cols"], np.arange(SB),
                        d["zb"])


@pytest.mark.parametrize("b", [1088, 2176])
def test_sortscale_rows_match_jax(b):
    """microbench_sortscale's two formulations at a small B (P = 512):
    root's multi-payload sort rtol 1e-5, the port's against the float64
    segment sums; its line carries root's keys."""
    d = mscale.draws(b, SP)
    got = _port_rows(mscale.rows(mscale.on_device(d, "cpu"), SP))
    np.testing.assert_allclose(float(got["ms"]),
                               float(_jax_sortscale_row(d)), rtol=1e-5)
    order = np.argsort(d["key"], kind="stable")
    bounds = np.searchsorted(d["key"][order], np.arange(SP + 1))
    _check_segment_sums(got["port_current_ms"], d["cols"], order, bounds)
    line = mscale.size_line(b, "cpu", SP)
    assert {"b", "ncols", "ms"} <= set(line) and line["b"] == b
    assert line["ncols"] == 9 and line["port_current_ms"] > 0


def test_scatter_rows_match_jax():
    """microbench_scatter_pack's three rows at B = 4096, P = 2048 (many
    positions hit twice) against root's functions, bit for bit."""
    b, p = SB, 2048
    d = mscat.draws(b, p)
    assert len(np.unique(d["pos"])) < p
    got = _port_rows(mscat.rows(mscat.on_device(d, "cpu"), b))
    want = _jax_scatter_rows(d, b)
    assert list(got) == list(want)
    for name, w in want.items():
        assert len(got[name]) == len(w)
        for a, bb in zip(got[name], w):
            bb = np.asarray(bb)
            assert a.dtype == {np.dtype("int32"): torch.int32,
                               np.dtype("complex64"): torch.complex64}[
                bb.dtype]
            np.testing.assert_array_equal(a.numpy(), bb, name)


# the k-view step: 64x48, 256 primitives, a budget that holds every view
MW, MH, MN, MBUDGET = 64, 48, 256, 1 << 13


def _jax_multicam(k):
    """experiments/multicam_step.py's loss and update for k views (its
    scene draws, cameras, target and background): (its five drawn
    parameters, (loss, the five gradients, the parameters, m and v after
    one update from zero moments)), numpy arrays."""
    from reduced3dgs_tpu.cameras import Camera
    from reduced3dgs_tpu.ops import binning as binning_ops
    from reduced3dgs_tpu.ops import preprocess as prep_ops
    from reduced3dgs_tpu.ops.tile_render import tile_render

    width, height, n, budget = MW, MH, MN, MBUDGET
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    feats[:, 1:] = rng.normal(0, 0.2, (n, 15, 3)).astype(np.float32)
    scales = np.log(rng.uniform(0.00432, 0.0189, (n, 3))).astype(
        np.float32)
    rots = rng.normal(0, 1, (n, 4)).astype(np.float32)
    opac = rng.uniform(-2, 3, n).astype(np.float32)
    degrees = np.full(n, 3, np.int32)
    cams = [Camera.look_at(eye=(0.2 * k, 0, -3.6), target=(0, 0, 0),
                           width=width, height=height).params()
            for k in range(2)]
    bg = np.zeros(3, np.float32)
    target = np.zeros((height, width, 3), np.float32)
    cps = cams[:k]

    def loss(xyz, feats, scales, rots, opac):
        total = 0.0
        for cp in cps:
            prep = prep_ops.preprocess(
                xyz, scales, rots, opac, feats, degrees, cp)
            b = binning_ops.bin_gaussians(
                prep, width, height, budget)
            color, _, _, _ = tile_render(
                prep, b, bg, width, height,
                grad_reduce="bf16x2")
            total = total + jnp.abs(color - target).mean()
        return total / k

    @jax.jit
    def one_step(xyz, feats, scales, rots, opac, m, v):
        l, grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3, 4))(
            xyz, feats, scales, rots, opac)
        params = (xyz, feats, scales, rots, opac)
        new_p, new_m, new_v = [], [], []
        for p, g, mm, vv in zip(params, grads, m, v):
            mm = 0.9 * mm + 0.1 * g
            vv = 0.999 * vv + 0.001 * g * g
            new_p.append(p - 1e-4 * mm / (jnp.sqrt(vv) + 1e-8))
            new_m.append(mm)
            new_v.append(vv)
        return l, grads, new_p, new_m, new_v

    args0 = tuple(jnp.asarray(a) for a in (xyz, feats, scales, rots, opac))
    zeros = tuple(jnp.zeros_like(a) for a in args0)
    out = one_step(*args0, zeros, zeros)
    return (xyz, feats, scales, rots, opac), jax.tree_util.tree_map(
        np.asarray, out)


@pytest.mark.parametrize("k", [1, 2])
def test_multicam_step_matches_jax(k):
    """One k-view step from root's draws: the loss, the five
    gradients, and root's update (the port's, applied to the JAX
    gradients from zero moments) against the JAX script's step; the
    port's own step's views all inside the budget."""
    drawn, (j_loss, j_grads, j_p, j_m, j_v) = _jax_multicam(k)
    sim = mcam.MultiCam(k, MW, MH, MN, MBUDGET, "cpu")
    for a, w in zip(sim.init, drawn, strict=True):
        np.testing.assert_array_equal(a.numpy(), w)
    assert (sim.degrees.numpy() == 3).all()
    loss, rendered, grads = sim.step()
    assert rendered.shape == (k,) and int(rendered.max()) <= MBUDGET
    assert int(rendered.min()) > 0
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    for i, (a, b) in enumerate(zip(grads, j_grads)):
        np.testing.assert_allclose(
            a.numpy(), b, rtol=2e-3, atol=2e-4 * np.abs(b).max(),
            err_msg=f"gradient {i}")
    params = [torch.as_tensor(a).clone() for a in sim.init]
    m = [torch.zeros_like(a) for a in params]
    v = [torch.zeros_like(a) for a in params]
    mcam.update(params, [torch.tensor(g) for g in j_grads], m, v)
    for got, want in ((params, j_p), (m, j_m), (v, j_v)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)


def test_multicam_graph_check_and_reset():
    """On the CPU the runner is the eager loop: the check of the replay
    against an eager step holds, a second step from the reset state
    repeats the first bit for bit, and reset() restores the drawn
    parameters with zero moments."""
    sim = mcam.MultiCam(1, MW, MH, MN, MBUDGET, "cpu")
    run = graphs.runner(sim.step, "cpu")
    assert mcam.graphed_equals_eager(sim, run)
    first = sim.state()
    assert not torch.equal(first[0], sim.init[0])
    sim.reset()
    assert all(torch.equal(a, b) for a, b in zip(sim.state()[:5], sim.init))
    assert all(not t.any() for t in sim.state()[5:])
    sim.step()
    assert all(torch.equal(a, b) for a, b in zip(sim.state(), first))


@pytest.mark.parametrize("module", MODULES)
def test_entry_point_needs_a_card(module, monkeypatch):
    """Without --device cpu every entry point raises where no card is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"reduced3dgs_torch.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


SMALL_ARGS = {
    "multicam_step": ["48", "32", "128", "4096", "1"],
    "microbench_sort": ["--batch", "2048", "--prims", "256"],
    "microbench_reduce": ["--batch", "2048", "--prims", "256"],
    "microbench_sortscale": ["--sizes", "1088", "2176", "--prims", "256"],
    "microbench_scatter_pack": ["--batch", "2048", "--prims", "512"],
}


@pytest.mark.parametrize("module", MODULES)
def test_entry_point_prints_root_lines(module, monkeypatch):
    """Each entry point with --device cpu at a small size: the device
    first, then root's lines in root's format."""
    monkeypatch.setattr(graphs, "best_window", lambda run, device: (
        graphs.time_replays(run, 1, device), 1))
    mod = importlib.import_module(f"reduced3dgs_torch.{module}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(SMALL_ARGS[module] + ["--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "cpu"
    text = "\n".join(lines)
    if module == "multicam_step":
        for k in (1, 2):
            assert any(ln.startswith(f"k={k}: ") and ln.endswith(
                f" ms/camera)") and " ms/step (" in ln for ln in lines)
            assert (f"k={k}: num_rendered per view " in text
                    and "no view overflowed it" in text)
        assert lines[-1].startswith(
            "per-camera amortization from 2-view batching: ")
        assert lines[-1].endswith("% of a 1-camera step)")
    elif module == "microbench_sortscale":
        rows = [json.loads(ln) for ln in lines[1:]]
        assert [r["b"] for r in rows] == [1088, 2176]
        assert all(r["ncols"] == 9 and r["ms"] > 0 for r in rows)
    else:
        names = {"microbench_sort": list(msort.rows(msort.on_device(
            msort.draws(64, 8), "cpu"), 8)),
            "microbench_reduce": list(mred.rows(mred.on_device(
                mred.draws(64, 8), "cpu"))),
            "microbench_scatter_pack": list(mscat.rows(mscat.on_device(
                mscat.draws(64, 8), "cpu"), 64))}[module]
        rows = lines[2:]
        assert len(rows) == len(names)
        for name, ln in zip(names, rows):
            head = (f"{name}: " if module == "microbench_scatter_pack"
                    else f"{name:24s} ")
            assert ln.startswith(head) and " ms; 1 replays a window" in ln
