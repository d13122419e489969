"""Alignment pads past the slack pool (ops/binning.py, csrc/expand.cu).

The witness: the benchmark's `m360_full` scene (splatbench/configs, its
published density) cut to 320x200 and 60,000 primitives, seed 7, pose 6
of its viewing path.  At a budget with room its binning needs 25,540
alignment pads against a slack pool of 23,552 slots, and the instances
with their pads fit in B_pad.  The JAX package's layout drops the pads
past the pool, so the last tile row rendered black; the port lays them
into the budget's unused slots.  Here the port's frame and one training
step are held to the benchmark's plain reference (splatbench/reference,
which imports nothing of the program), and the sorted layout is checked
tile by tile.  The `gpu` case holds K1's keys to the plain version's on
the witness (run on a card: `python -m pytest tests/test_torch_pad_spill.py
--noconftest -o addopts= -p no:cacheprovider`).  This file imports no JAX.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.models.gaussians import GaussianParams, GaussianPool
from reduced3dgs_torch.ops import binning
from reduced3dgs_torch.ops import preprocess as prep_ops
from reduced3dgs_torch.render import PoolView, render_view
from reduced3dgs_torch.train import trainer as T
from reduced3dgs_torch.train import adam
from splatbench import scene
from splatbench.generators import view as vw
from splatbench.generators.train import view_of
from splatbench.reference import raster
from splatbench.reference import train as ref_train
from splatbench.run import HERE, load_json

W, H, N, SEED, POSE = 320, 200, 60_000, 7, 6
BUDGET = 1 << 17  # room for every instance (~74,000)
CPU = torch.device("cpu")


def _config():
    cfg = load_json(HERE / "configs" / "m360_full.json")
    cfg.update(width=W, height=H, primitives=N, capacity=65_536)
    return cfg


def make_witness():
    """The witness's config, pool, pose and camera."""
    cfg = _config()
    leaves = scene.primitives(cfg, SEED, CPU)
    pool = GaussianPool(
        params=GaussianParams(*(leaves[k] for k in scene.LEAVES)),
        degrees=leaves["degrees"], alive=leaves["alive"],
        active_sh_degree=cfg["sh_degree"])
    pose = scene.viewing_path(cfg, SEED, 24)[POSE]
    R, T_, _ = pose
    cam = Camera(uid=0, colmap_id=0, R=R, T=T_,
                 fov_x=np.radians(cfg["assumed"]["fov_x_deg"]),
                 fov_y=scene.fov_y(cfg), image=None, image_name="witness",
                 width=W, height=H)
    return dict(cfg=cfg, pool=pool, pose=pose, cam=cam)


@pytest.fixture(scope="module")
def witness():
    return make_witness()


def _binning(w):
    pv = PoolView(w["pool"])
    with torch.inference_mode():
        prep = prep_ops.preprocess(
            pv.xyz, pv.scaling, pv.rotation, pv.opacity, pv.features,
            pv.degrees, w["cam"].params(CPU), alive_mask=pv.alive)
        return prep, binning.bin_gaussians(prep, W, H, BUDGET)


def test_the_witness_needs_pads_past_the_pool(witness):
    _, b = _binning(witness)
    b_pad = b.gauss_aligned.shape[0]
    nv = min(int(b.num_rendered), BUDGET)
    need, pool = int(b.total_padded) - nv, b_pad - BUDGET
    assert (need, pool) == (25_540, 23_552)
    assert int(b.num_rendered) <= BUDGET and int(b.total_padded) <= b_pad


def test_the_sorted_layout_holds_every_tile_whole(witness):
    """Tile t's slots [start, start + padded): its instances in depth
    order, then its pads; past total_padded nothing but unused slots."""
    _, b = _binning(witness)
    tiles = b.tile_ranges.shape[1]
    start, end = b.tile_ranges.long()
    counts = end - start
    padded = (counts + binning.ALIGN - 1) // binning.ALIGN * binning.ALIGN
    assert torch.equal(start, torch.cumsum(padded, 0) - padded)
    total = int(b.total_padded)
    assert total == int(padded.sum())
    slot = torch.arange(b.gauss_aligned.shape[0])
    owner = torch.searchsorted(torch.cumsum(padded, 0), slot, right=True)
    live = slot < total
    assert torch.equal(b.tile_id[live].long(), owner[live])
    assert bool((b.tile_id[~live] == tiles).all())
    is_inst = live & (slot < start[owner.clamp(max=tiles - 1)]
                      + counts[owner.clamp(max=tiles - 1)])
    assert torch.equal(~b.pad_mask, is_inst)
    # within a tile the instances keep the depth order
    rank = b.gauss_aligned.long()
    same = is_inst[1:] & is_inst[:-1] & (owner[1:] == owner[:-1])
    assert bool((rank[1:][same] > rank[:-1][same]).all())


def test_the_frame_matches_the_reference(witness):
    cfg = witness["cfg"]
    bg = torch.zeros(3)
    out, budget = render_view(PoolView(witness["pool"]), witness["cam"], bg,
                              BUDGET)
    assert budget == BUDGET
    model = vw.reference_model(cfg, SEED, CPU)
    want, share = vw.reference_frame(cfg, model, witness["pose"], CPU)
    assert share > 1.0  # pad need over the pool, as raster.pad_share sees it
    gap = (out.color - want).abs()
    assert float(gap.mean()) <= 1e-5 and float(gap.max()) <= 1e-3
    # the last tile row (pixel rows 192-199) is lit, as the reference's
    assert float(want[192:].mean()) > 0.05
    assert float(out.color[192:].mean()) > 0.05


def test_a_training_step_matches_the_reference(witness, monkeypatch):
    """Loss and each leaf's gradient norm of one step at the witness
    view, the port's train_step ("tile" backend, its plain versions, f32
    reduction) against the reference's loss_and_grads, within the
    tolerances of tests/test_torch_train.py's step parity (rtol 1e-5 on a
    loss, 2e-3 on a gradient).  Readings: the loss within 1e-6, the norms
    within 2.2e-4 (xyz) and 6e-5 (the rest)."""
    cfg = witness["cfg"]
    tr_cfg = cfg["training"]
    # the reference composites in smaller chunks (memory of the test run)
    monkeypatch.setattr(raster, "_chunks",
                        functools.partial(raster._chunks, pairs=1 << 22))
    gt = scene.ground_truth(cfg, SEED, 0, CPU)
    bg = torch.zeros(3)
    pool = witness["pool"]
    opt_cfg = dataclasses.replace(
        OptimizationParams(), lambda_dssim=tr_cfg["lambda_dssim"],
        lambda_alpha_regul=tr_cfg["lambda_alpha_regul"],
        lambda_sh_sparsity=tr_cfg["lambda_sh_sparsity"])
    state = T.TrainState(pool, adam.init(pool.params), None)
    _, metrics, grads = T.train_step(
        state, witness["cam"].params(CPU), gt, bg, 1, width=W, height=H,
        budget=BUDGET, backend="tile", opt_cfg=opt_cfg, spatial_lr_scale=1.0,
        skip_update=True, grad_reduce="f32")
    assert int(metrics["num_rendered"]) <= BUDGET
    n = cfg["primitives"]
    params = {k: getattr(pool.params, k)[:n] for k in ref_train.LEAVES}
    loss, want, share = ref_train.loss_and_grads(
        params, pool.degrees[:n], pool.alive[:n],
        view_of(cfg, witness["pose"], CPU), gt, bg, tr_cfg)
    assert share > 1.0
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-5)
    for k in ref_train.LEAVES:
        np.testing.assert_allclose(float(getattr(grads, k)[:n].norm()),
                                   float(want[k].norm()), rtol=2e-3,
                                   err_msg=k)


def test_phase23_rehearsal(witness):
    """chip_smoke.py's phase 23 at the witness size: the FrameServer's
    frames against the reference within the m360_full.serve limits, and
    pads_spilled where the pad need is over the pool."""
    import chip_smoke as cs

    lines = []
    rows = cs.spill_frames(CPU, SEED, witness["cfg"], poses=(0, POSE),
                           path=24, say=lines.append)
    assert [r[0] for r in rows] == [0, POSE] and len(lines) == 2
    for _, need, spilled, share, mean, top in rows:
        assert need > 1000 and spilled > 0 and share > 1.0
        assert mean <= 1e-5 and top <= 1e-3
    assert rows[1][2] == 25_540 - 23_552


@pytest.mark.gpu
def test_k1_keys_equal_the_plain_version_on_the_witness(witness,
                                                        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seen = []
    plain = binning.bin_keys

    def spy(*a):
        seen.append(a)
        return plain(*a)

    monkeypatch.setattr(binning, "bin_keys", spy)
    _binning(witness)
    (args,) = seen
    cuda = torch.device("cuda")
    on_card = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    got = binning._bin_keys_cuda(*on_card)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), binning.bin_keys_plain(*args))
