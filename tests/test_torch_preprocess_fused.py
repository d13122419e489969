"""The fused preprocess kernel (csrc/preprocess_fwd.cu) and its dispatch.

On the CPU: `preprocess`'s three-way rule (the forward kernel with no
gradient asked, PreprocessFunction for a gradient of the raw parameters
or the screen offset, the torch ops for CPU tensors, a screen offset
without a gradient, precomputed colours or a camera that asks for a
gradient), none of which records a `preprocess_fused` counter here; the wrapper
refuses tensors off a card; chip_smoke.py's phase 22 helpers rehearsed
(the pre-rounding floats it excuses rows by reproduce the torch path's
integer outputs; its parity pool reaches every kind of row).

Marked `gpu` (skipped with a reason where no card is present; run on a
card with `python -m pytest tests/test_torch_preprocess_fused.py
--noconftest -o addopts= -p no:cacheprovider`): the kernel against the
torch path on seeded pools of 2^18 rows at both benchmark scenes'
cameras -- floats within 1e-5 relative, radii, rects and tiles_touched
equal but on rows whose pre-rounding float lies within 4 ulps of an
integer (at most 1e-5 of the rows), two launches bit for bit; a
captured graph bit for bit its eager launches, counted once a replay;
rendered frames within 1e-6 mean gap of the torch path's.
"""

import math

import pytest
import torch

import chip_smoke as cs
from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.ops import preprocess as tprep
from reduced3dgs_torch.utils import profiling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _small(seed=3, n=2048):
    pool = cs.prep_pool(n, seed, torch.device("cpu"), dead_share=0.05,
                        degenerate=32)
    return pool, cs.prep_cameras("m360", torch.device("cpu"))[0]


ROUTES = {"cpu": "torch", "grad_input": "function", "screen_offset": "torch",
          "card_no_grad": "fused", "card_grad_input_no_grad": "fused",
          "cpu_grad_input": "torch", "grad_screen_offset": "function",
          "grad_precomp": "torch", "grad_camera": "torch"}


@pytest.mark.parametrize("case", list(ROUTES))
def test_dispatch_rule(case, monkeypatch):
    """Which path `preprocess` takes.  The card is simulated: `_on_card`
    answers True for the CPU tensors, the kernel's wrapper is a spy that
    runs the torch path, and the Function's entry is a spy that runs it
    on the CPU tensors.  With no gradient asked (grad mode off, or no
    input requiring one), every input on a card and no screen offset:
    the forward kernel; with a gradient asked of the raw parameters or
    the screen offset alone, on a card, colours from SH: the Function;
    every other call, the CPU always: autograd through preprocess_torch.
    No path records the preprocess_fused counter here."""
    pool, cam = _small()
    args = list(cs.prep_args(pool))
    kw = {"alive_mask": pool["alive"]}
    calls = []

    def spy(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(tprep, "preprocess_fused",
                        spy("fused", tprep.preprocess_torch))
    monkeypatch.setattr(tprep, "preprocess_function",
                        spy("function", tprep.preprocess_function))
    if not case.startswith("cpu"):
        monkeypatch.setattr(tprep, "_on_card", lambda t: True)
    if "grad_input" in case or case in ("grad_precomp", "grad_camera"):
        args[0] = args[0].clone().requires_grad_()
    if "screen_offset" in case:
        kw["screen_offset"] = torch.zeros((args[0].shape[0], 2),
                                          requires_grad=case.startswith(
                                              "grad"))
    if case == "grad_precomp":
        kw["color_precomp"] = torch.rand((args[0].shape[0], 3))
    if case == "grad_camera":
        cam = cam._replace(campos=cam.campos.clone().requires_grad_())
    profiling.reset()
    with profiling.enable():
        with torch.set_grad_enabled(not case.endswith("no_grad")):
            out = tprep.preprocess(*args, cam, **kw)
        snap = profiling.snapshot()
    want = ROUTES[case]
    assert calls == ([] if want == "torch" else [want])
    assert "preprocess_fused" not in snap["counters"]
    assert out.means2d.requires_grad == (case in (
        "grad_input", "cpu_grad_input", "grad_screen_offset",
        "grad_precomp", "grad_camera"))
    assert torch.equal(out.radii, tprep.preprocess_torch(
        *[a.detach() for a in args], cam, **kw).radii)


def test_wrapper_refuses_tensors_off_a_card():
    pool, cam = _small()
    before = tprep.PREPROCESS_FWD.launches
    with pytest.raises(ValueError, match="on one card"):
        tprep.preprocess_fused(*cs.prep_args(pool), cam)
    assert tprep.PREPROCESS_FWD.launches == before


@pytest.mark.parametrize("size", sorted(cs.PREP_SIZES))
def test_phase22_rounding_floats_reproduce_the_integer_outputs(size):
    """The floats phase 22 excuses integer mismatches by are the torch
    path's own: their ceil gives its radii, their truncation (clamped as
    _tile_index clamps) its rects, on every case of prep_cases; and the
    comparison finds a changed radius on a row no rounding excuses."""
    pool, _ = _small(n=4096)
    for name, cam, kw in cs.prep_cases(pool, size):
        args = cs.prep_args(pool, kw.get("color_precomp"))
        want = tprep.preprocess_torch(*args, cam, **kw)
        floats, det0, behind = cs.prep_rounding_floats(
            pool, cam, "alive_mask" in kw, kw.get("scale_modifier", 1.0))
        valid = want.radii > 0
        assert torch.equal(torch.ceil(floats[valid, 0]).int(),
                           want.radii[valid]), name
        gx, gy = tprep.tile_grid(cam.width, cam.height)
        for col, grid, out, axis in ((5, gx, want.rect_min, 0),
                                     (6, gy, want.rect_min, 1),
                                     (7, gx, want.rect_max, 0),
                                     (8, gy, want.rect_max, 1)):
            v = floats[:, col]
            got = torch.clamp(v.to(torch.int32), 0, grid)
            moved = v != 0.5  # the clip decides where the helper put 0.5
            assert torch.equal(got[moved], out[moved, axis]), name
        near = cs.near_integer(floats)
        same = cs.compare_prep(want, want, near)
        assert same["differ"] == 0 and max(same["gaps"].values()) == 0.0
        row = int(torch.nonzero(valid & ~near)[0])
        bumped = want._replace(radii=want.radii.clone())
        bumped.radii[row] += 1
        assert cs.compare_prep(bumped, want, near)["unexcused"] == 1
        assert int(det0.sum()) > 0 and int(behind.sum()) > 0


def test_phase22_pool_and_bytes():
    """prep_pool's rows: mixed degrees, dead rows, far-shell rows behind
    the camera, degenerate rows; prep_bytes counts every row's 113 bytes
    and the visible rows' kept coefficients."""
    pool, cam = _small(n=8192)
    assert set(pool["degrees"].tolist()) == {0, 1, 2, 3}
    assert 0 < int((~pool["alive"]).sum()) < 8192 * 0.1
    out = tprep.preprocess_torch(*cs.prep_args(pool), cam,
                                 alive_mask=pool["alive"])
    vis = out.radii > 0
    d = pool["degrees"].long()
    want = 8192 * 113 + 12 * int(((d + 1) ** 2)[vis].sum())
    assert cs.prep_bytes(pool, out, False) == want
    assert cs.prep_bytes(pool, out, True) == 8192 * 113 + 12 * int(vis.sum())
    assert math.isclose(cs.bound(want, 0)[0], want / 3.35e9)


@pytest.mark.gpu
def test_kernel_matches_the_torch_path(cuda):
    worst, most = cs.prep_parity(cuda, 2718281828)
    assert worst <= cs.PREP_FLOAT_GAP
    assert most <= cs.PREP_EXCUSED_SHARE * cs.PREP_PARITY_ROWS


@pytest.mark.gpu
def test_graph_counter_and_frames(cuda):
    assert cs.prep_frame_checks(cuda, 3141592653) <= cs.PREP_FRAME_GAP


@pytest.mark.gpu
def test_dispatch_on_the_card(cuda):
    """No-grad and inference renders launch the kernel once; a training
    render (an input requiring grad) and a screen offset launch none, and
    the training render's backward launches csrc/preprocess_bwd.cu
    once."""
    pool = cs.prep_pool(4096, 11, cuda)
    cam = cs.prep_cameras("tnt", cuda)[0]
    args = cs.prep_args(pool)
    k = tprep.PREPROCESS_FWD
    for ctx, want in ((torch.no_grad, 1), (torch.inference_mode, 1)):
        before = k.launches
        with ctx():
            tprep.preprocess(*args, cam, alive_mask=pool["alive"])
        assert k.launches == before + want
    before, bwd = k.launches, tprep.PREPROCESS_BWD.launches
    grad_args = (args[0].clone().requires_grad_(),) + args[1:]
    out = tprep.preprocess(*grad_args, cam, alive_mask=pool["alive"])
    assert out.means2d.requires_grad and k.launches == before
    out.conic.sum().backward()
    assert tprep.PREPROCESS_BWD.launches == bwd + 1
    assert grad_args[0].grad.abs().max() > 0
    with torch.no_grad():
        tprep.preprocess(*args, cam, screen_offset=torch.zeros(
            (4096, 2), device=cuda))
    assert k.launches == before
    with pytest.raises(ValueError, match="want torch.float32"):
        tprep.preprocess_fused(args[0].double(), *args[1:], cam)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ["C1", "C4", "C9", "C16_unaligned"])
def test_sh_rows_read_a_float_at_a_time(cuda, rows):
    """SH blocks of fewer than 16 coefficients, and 16-coefficient rows
    off a 16-byte boundary, take the kernel's scalar loads: the same
    outputs as the torch path's, by phase 22's criterion."""
    pool = cs.prep_pool(1 << 14, 17, cuda, dead_share=0.05)
    if rows == "C16_unaligned":
        flat = torch.empty(pool["sh"].numel() + 1, device=cuda)
        sh = flat[1:].view(pool["sh"].shape)
        sh.copy_(pool["sh"])
        assert sh.data_ptr() % 16 != 0
    else:
        sh = pool["sh"][:, :int(rows[1:])].contiguous()
    cam = cs.prep_cameras("m360", cuda)[1]
    args = (pool["xyz"], pool["scales"], pool["rots"], pool["opac"], sh,
            pool["degrees"])
    with torch.no_grad():
        want = tprep.preprocess_torch(*args, cam, alive_mask=pool["alive"])
        got = tprep.preprocess_fused(*args, cam, alive_mask=pool["alive"])
    floats, _, _ = cs.prep_rounding_floats(pool, cam)
    res = cs.compare_prep(got, want, cs.near_integer(floats))
    assert max(res["gaps"].values()) <= cs.PREP_FLOAT_GAP, res
    assert res["unexcused"] == 0, res
