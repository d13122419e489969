"""The port's FPS ring (reduced3dgs_torch/render.py measure_fps) against
root render.py on the CPU, at 96x64 and a few thousand primitives.

Root render.py repeats the views to at least 32 frames
(``reps = max(1, -(-32 // n_views))``) and settles one budget for all of
them on the {2^k, 3*2^(k-1)} ladder, rendering every view at each rung
(the JAX renderer's num_rendered, counted here by its own preprocess and
binning); the port must settle the same budget, dense and variable-SH,
and time the same number of frames.  On the CPU the ring is a loop of
render_once, whose images must equal the eager frames bit for bit; on
the card it is a CUDA graph, which cannot hold a host copy or read: a
TorchDispatchMode over one dense and one variable-SH frame finds any.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_arrays
from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.models.gaussians import padded_leaves, pool_from_numpy
from reduced3dgs_torch.render import (
    PoolView, fps_ring, measure_fps, render_once, ring_reps, settle_budget,
)
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.ops import binning as jbin
from reduced3dgs_tpu.ops import preprocess as jprep

W, H, N = 96, 64, 3000
START = 4096  # under the views' need, so that the ladder climbs


def _eyes(n_views):
    return [(3.6 * math.sin(2 * math.pi * i / n_views), 0.3,
             -3.6 * math.cos(2 * math.pi * i / n_views))
            for i in range(n_views)]


@pytest.fixture(scope="module")
def scene():
    arrs = make_arrays(N, (0.02, 0.08), 0)
    arrs["degrees"] = np.random.default_rng(1).integers(
        0, 4, N).astype(np.int32)
    return padded_leaves(arrs, capacity=4096)


@pytest.fixture(scope="module")
def root_budget(scene):
    """Root render.py:154-204's budget for the views from START: every
    view counted at the budget as the JAX renderer counts it (its
    preprocess and binning, and the fold of a slack overflow into
    num_rendered, reduced3dgs_tpu/renderer.py:92-111), climbing while the
    largest count exceeds it."""
    feats = jnp.asarray(np.concatenate(
        [scene["features_dc"], scene["features_rest"]], axis=1))

    @partial(jax.jit, static_argnums=(1,))
    def count(cp, budget):
        prep = jprep.preprocess(
            jnp.asarray(scene["xyz"]), jnp.asarray(scene["scaling"]),
            jnp.asarray(scene["rotation"]),
            jnp.asarray(scene["opacity"][:, 0]), feats,
            jnp.asarray(scene["degrees"]), cp,
            alive_mask=jnp.asarray(scene["alive"]))
        b = jbin.bin_gaussians(prep, W, H, budget)
        return jnp.where(b.total_padded > b.gauss_aligned.shape[0],
                         jnp.maximum(b.num_rendered, budget + 1),
                         b.num_rendered)

    cps = [JCamera.look_at(eye=e, target=(0, 0, 0), width=W,
                           height=H).params() for e in _eyes(3)]
    budget = START
    while True:
        needed = max(int(count(cp, budget)) for cp in cps)
        if needed <= budget:
            return budget
        while budget < needed:
            budget = (budget // 2 * 3 if budget & (budget - 1) == 0
                      else budget // 3 * 4)


def _cams():
    return [Camera.look_at(eye=e, target=(0, 0, 0), width=W, height=H)
            for e in _eyes(3)]


def test_ring_reps_is_root_renders():
    for n_views in (1, 3, 5, 8, 31, 32, 33, 50):
        assert ring_reps(n_views) == max(1, -(-32 // n_views))


def test_measure_fps_budget_and_frames(scene, root_budget):
    pv = PoolView(pool_from_numpy(scene, "cpu"))
    res = measure_fps(pv, _cams(), torch.zeros(3), budget=START)
    assert res["budget"] == root_budget > START
    assert res["reps"] == 11 and res["frames"] == 33
    assert res["fps"] > 0 and res["capture_s"] == 0.0
    assert res["num_rendered_max"] <= res["budget"]
    assert set(res["launches"]) >= {"expand", "tile_fwd"}


@pytest.mark.parametrize("variable_sh", [False, True])
def test_ring_images_equal_eager_frames(scene, root_budget, variable_sh):
    pv = PoolView(pool_from_numpy(scene, "cpu"), variable_sh=variable_sh)
    bg = torch.zeros(3)
    cps = [c.params("cpu") for c in _cams()]
    budget, needed = settle_budget(pv, cps, bg, START)
    assert budget == root_budget and needed <= budget
    ring = fps_ring(pv, cps, bg, budget)
    ring.replay()
    for cp, got in zip(cps, ring.out):
        want = render_once(pv, cp, bg, budget)
        assert torch.equal(got.color, want.color)
        assert torch.equal(got.final_t, want.final_t)
        assert int(got.num_rendered) == int(want.num_rendered)


def test_frame_has_no_host_transfer(scene):
    """What the graphed ring cannot capture, caught on the CPU: a dense
    and a variable-SH frame make no tensor from host data and read no
    device value on the host, outside the kernels' plain versions."""
    from host_transfers import HostTransfers

    watch = HostTransfers()
    pool = pool_from_numpy(scene, "cpu")
    cp = Camera.look_at(eye=_eyes(3)[1], target=(0, 0, 0), width=W,
                        height=H).params("cpu")
    bg = torch.zeros(3)
    for variable_sh in (False, True):
        pv = PoolView(pool, variable_sh=variable_sh)
        with watch:
            out = render_once(pv, cp, bg, 1 << 15)
        assert 0 < int(out.num_rendered) <= 1 << 15
    assert len(watch.seen) > 100 and not watch.bad, watch.bad
