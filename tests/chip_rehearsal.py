"""What the rehearsals of chip_smoke.py's phases share (the
test_torch_chip_rehearsal*.py files): the tiny scene, and the
``cpu_card`` fixture, which replaces the CUDA wrappers by their plain
versions (counting launches here as the kernels do), CUDA events by a
host clock and the profiled step by nothing, and shortens the timed
loops (the FPS ring to one pass over the views, the bench's windows to
one of two steps): on the CPU they time nothing of the card.  What the rehearsals check
is the phases' control flow, shapes and checks, not the kernels
(tests/test_torch_gpu.py does that on a card)."""

import time

import pytest
import torch

import chip_smoke as cs
from reduced3dgs_torch import bench
from reduced3dgs_torch import render as trender
from reduced3dgs_torch.ops import binning as tbin
from reduced3dgs_torch.ops import preprocess as tp
from reduced3dgs_torch.ops import tile_render as ttr

SMALL = dict(width=96, height=64, n=3000, scales=(0.02, 0.08))


class _HostEvent:
    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _counting(fn, kernel):
    def run(*a, **kw):
        kernel.launches += 1
        return fn(*a, **kw)
    return run


def _from_table(plain):
    """A walk's plain version taking the kernel's WalkFeatures."""
    def run(src, *a, **kw):
        return plain(src.table(), *a, **kw)
    return run


def plain_counting(setattr):
    """The kernels' plain versions in place of the CUDA wrappers, each
    counting a launch as its kernel does, and the FPS ring and the
    bench's windows shortened; `setattr` applies each replacement
    (monkeypatch.setattr in a test, the builtin in a child process)."""
    setattr(trender, "FPS_MIN_FRAMES", 1)
    setattr(bench, "ITERS", 2)
    setattr(bench, "WINDOWS", 1)
    setattr(ttr, "_tile_fwd_cuda", _from_table(ttr.tile_fwd_plain))
    setattr(ttr, "_tile_bwd_cuda", _from_table(ttr.tile_bwd_plain))
    setattr(ttr, "_seg_reduce_cuda", ttr.seg_reduce_plain)
    setattr(ttr, "_tile_trans_cuda", _from_table(ttr.tile_trans_plain))
    setattr(tbin, "_bin_keys_cuda", tbin.bin_keys_plain)
    setattr(tbin, "_tile_counts_cuda", tbin.tile_counts_plain)
    setattr(tbin, "tile_counts_plain", _counting(tbin.tile_counts_plain,
                                                 tbin.TILE_COUNTS))
    setattr(ttr, "tile_trans_plain", _counting(ttr.tile_trans_plain,
                                               ttr.TILE_TRANS))
    setattr(tbin, "bin_keys_plain", _counting(tbin.bin_keys_plain,
                                              tbin.EXPAND))
    setattr(ttr, "tile_fwd_plain", _counting(ttr.tile_fwd_plain,
                                             ttr.TILE_FWD))
    setattr(ttr, "tile_bwd_plain", _counting(ttr.tile_bwd_plain,
                                             ttr.TILE_BWD))
    plain_seg = ttr.seg_reduce_plain

    def seg(rows, order, bounds, packed):
        k = ttr.SEG_REDUCE_PACKED if packed else ttr.SEG_REDUCE_F32
        k.launches += 1
        return plain_seg(rows, order, bounds, packed)

    setattr(ttr, "seg_reduce_plain", seg)


def cpu_card_patches(monkeypatch):
    """What cpu_card replaces, on a pytest MonkeyPatch (a module fixture
    passes its own)."""
    monkeypatch.setattr(cs, "MAIN", SMALL)
    monkeypatch.setattr(cs, "K2_SCENE", dict(SMALL, budget=1 << 15))
    monkeypatch.setattr(cs, "TRAIN", dict(cs.TRAIN, grad_threshold=1e-6))
    monkeypatch.setattr(cs, "BENCH_BUDGET", 1 << 16)
    monkeypatch.setattr(cs, "SKEWED", dict(
        p=4000, n_long=2, long_len=3000, n_mid=20, mid_len=(33, 300),
        short_max=3))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(cs, "profile_step", lambda *a: None)
    plain_counting(monkeypatch.setattr)


@pytest.fixture
def cpu_card(monkeypatch):
    cpu_card_patches(monkeypatch)
    return torch.device("cpu")


def counted(fn):
    """chip_smoke.profiled on the CPU: the kernels' counts are the plain
    versions' launches during fn(); no kernel time is known."""
    kernels = {"expand": tbin.EXPAND, "tile_fwd": ttr.TILE_FWD,
               "tile_bwd": ttr.TILE_BWD,
               "seg_reduce_packed": ttr.SEG_REDUCE_PACKED,
               "seg_reduce_f32": ttr.SEG_REDUCE_F32,
               "preprocess_bwd": tp.PREPROCESS_BWD}
    before = {n: kern.launches for n, kern in kernels.items()}
    fn()
    return ({n: kern.launches - before[n] for n, kern in kernels.items()},
            0.0, 1.0, 0, 0)
