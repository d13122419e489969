"""The port's checkpoints (train/checkpoint.py) against the JAX package's
(reduced3dgs_tpu/train/checkpoint.py): one .npz layout both ways, every
leaf equal; the scalar-step layout of older files; a resumed Trainer that
steps as the unbroken one does; ``--start_checkpoint`` /
``--checkpoint_iterations`` of the training CLI (with --fused_steps)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_cli_e2e import REPO, make_blender_dataset
from test_torch_trainer import make_trainer

from reduced3dgs_torch.train import checkpoint as tck
from reduced3dgs_torch.train import trainer as T
from reduced3dgs_tpu.models import gaussians as JG
from reduced3dgs_tpu.train import adam as jadam
from reduced3dgs_tpu.train import checkpoint as jck
from reduced3dgs_tpu.train.trainer import TrainState as JTrainState

ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _trained(steps=6):
    """A port Trainer after `steps` iterations with a densify at 5 (so the
    statistics, degrees and alive mask are not the initial ones)."""
    tr = make_trainer(True)
    for i in range(1, steps + 1):
        tr.step(i)
    return tr


def _jax_state(seed=0, key=3):
    rng = np.random.default_rng(seed)
    pool = JG.create_from_pcd(
        rng.normal(0, 1, (30, 3)).astype(np.float32),
        rng.uniform(0, 1, (30, 3)).astype(np.float32), capacity=64)
    pool = pool._replace(
        max_radii2d=jnp.asarray(rng.uniform(0, 9, 64).astype(np.float32)),
        active_sh_degree=jnp.int32(2))
    opt = jadam.init(pool.params)
    opt = opt._replace(step=jax.tree.map(lambda _: jnp.int32(17), opt.step),
                       mu=jax.tree.map(lambda x: x + 0.5, opt.mu))
    return JTrainState(pool, opt, jax.random.PRNGKey(key))


def _assert_leaves_equal(got, want):
    assert len(got) == len(want) == 31
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_port_round_trip(tmp_path):
    tr = _trained()
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, tr.state, 6, 2.5)
    state, it, slr = tck.load_checkpoint(path, "cpu")
    assert it == 6 and slr == 2.5
    _assert_leaves_equal(tck.state_leaves(state),
                         tck.state_leaves(tr.state))
    assert state.pool.active_sh_degree == tr.state.pool.active_sh_degree
    assert list(state.opt.step) == list(tr.state.opt.step) == [6] * 6
    assert state.generator.initial_seed() == 1
    assert state.pool.alive.dtype == torch.bool
    assert state.pool.degrees.dtype == torch.int32


def test_jax_written_loads_in_the_port(tmp_path):
    state = _jax_state()
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, state, 1234, 2.5)
    got, it, slr = tck.load_checkpoint(path, "cpu")
    assert it == 1234 and slr == 2.5
    _assert_leaves_equal(tck.state_leaves(got), jax.tree.leaves(state))
    assert got.pool.capacity == 64 and got.pool.active_sh_degree == 2
    assert got.generator.initial_seed() == 3  # PRNGKey(3) is [0, 3]


def test_port_written_loads_in_jax(tmp_path):
    tr = _trained()
    path = str(tmp_path / "torch.npz")
    tck.save_checkpoint(path, tr.state, 6, 3.0)
    state, it, slr = jck.load_checkpoint(path)
    assert it == 6 and slr == 3.0
    _assert_leaves_equal(jax.tree.leaves(state), tck.state_leaves(tr.state))
    assert int(jax.tree.leaves(state.opt.step)[0]) == 6
    np.testing.assert_array_equal(np.asarray(state.key), [0, 1])


def test_legacy_scalar_step_file(tmp_path):
    """A file of the older layout (one scalar Adam step, written here by
    the JAX package) loads with that step on every leaf."""
    state = _jax_state(seed=1)
    legacy = state._replace(opt=state.opt._replace(step=jnp.int32(42)))
    path = str(tmp_path / "legacy.npz")
    jck.save_checkpoint(path, legacy, 500, 1.0)
    got, it, _ = tck.load_checkpoint(path, "cpu")
    assert it == 500 and list(got.opt.step) == [42] * 6
    for a, b in zip(tck.state_leaves(got)[:24], jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_resumed_trainer_steps_as_the_unbroken_one(tmp_path):
    """Save after 6 iterations, load into a fresh Trainer that takes over
    the host state (camera order, budgets): its next steps, one of them a
    step_group, equal the unbroken trainer's bit for bit."""
    a = _trained()
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, a.state, 6, a.spatial_lr_scale)
    b = make_trainer(True)
    b.state, _, b.spatial_lr_scale = tck.load_checkpoint(path, "cpu")
    b.rng.bit_generator.state = a.rng.bit_generator.state
    b._stack, b.budgets = list(a._stack), dict(a.budgets)
    ma = [a.step(7)] + a.step_group([8, 9])
    mb = [b.step(7)] + b.step_group([8, 9])
    for x, y in zip(ma, mb):
        assert float(x["loss"]) == float(y["loss"])
    for x, y in zip(T.carried(a.state), T.carried(b.state)):
        assert torch.equal(x, y)


def _run_train(args):
    return subprocess.run(
        [sys.executable, "-m", "reduced3dgs_torch.train", *args], cwd=REPO,
        env=dict(os.environ, **ONE_THREAD), capture_output=True, text=True,
        timeout=300)


def test_cli_checkpoints_and_resume(tmp_path):
    """--checkpoint_iterations 6 with --fused_steps 4 (groups 1-4 and 5-6
    end at the checkpoint), then a second run from chkpnt6.npz: it starts
    at 7; both runs write the final files, and the checkpoint
    loads in the JAX package."""
    src = str(tmp_path / "scene")
    make_blender_dataset(src)
    common = ["-s", src, "--device", "cpu", "--iterations", "12",
              "--test_iterations", "12", "--save_iterations", "12",
              "--densify_from_iter", "100", "--fused_steps", "4"]
    first = str(tmp_path / "first")
    r = _run_train(common + ["-m", first, "--checkpoint_iterations", "6"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[ITER 6] Saving Checkpoint" in r.stdout
    ck = os.path.join(first, "chkpnt6.npz")
    state, it, _ = jck.load_checkpoint(ck)
    assert it == 6 and int(jax.tree.leaves(state.opt.step)[0]) == 6
    second = str(tmp_path / "second")
    r = _run_train(common + ["-m", second, "--start_checkpoint", ck])
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"Resuming from {ck} at iteration 6" in r.stdout
    assert "[ITER 10] loss" in r.stdout and "[ITER 6]" not in r.stdout
    for model in (first, second):
        assert os.path.exists(os.path.join(
            model, "point_cloud", "iteration_12",
            "point_cloud_quantised_pack.ply"))
