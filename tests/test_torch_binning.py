"""Port parity: ops/binning.py, torch vs JAX — bit-identical.

``expand_stream`` (the mark scatter + running max of ``expand_marks_plain``)
is held against the JAX ``_expand_stream`` (its Pallas kernel in interpret
mode) on every budget slot; ``bin_gaussians`` is fed JAX's own
PreprocessOut (as numpy, so no float rounding upstream can move a rect)
and every BinningOut field must be identical, including budget truncation
and alignment-slack overflow.

K1 (csrc/expand.cu) computes binning's slot keys by binary search, not the
JAX package's way; its algorithm, written here with ``torch.searchsorted``
(``keys_by_search``), must give ``bin_keys_plain``'s keys bit for bit on
chip_smoke's K1 cases and on the keys of every bit-identity scene.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_binning import make_prep
from test_tile_render import H, W, make_scene

import chip_smoke as cs
from reduced3dgs_torch.ops import binning as tbin
from reduced3dgs_torch.ops import preprocess as tprep
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.ops import binning as jbin
from reduced3dgs_tpu.ops import preprocess as jprep


def _marks(p, budget, seed=11, truncate=False, empty=False):
    """mark_pos / rank1 / rectpack as bin_gaussians builds them."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(11, p).astype(np.int64)
    counts[:80] = 0
    counts[rng.integers(0, p, 60)] = 0
    if empty:
        counts[:] = 0
    offsets = np.cumsum(counts)
    if not truncate:
        assert offsets[-1] < budget
    else:
        assert offsets[-1] > budget
    starts = (offsets - counts).astype(np.int32)
    mark_pos = np.where(counts > 0, starts, budget).astype(np.int32)
    rank1 = np.arange(1, p + 1, dtype=np.int32)
    rectpack = rng.integers(0, 1 << 30, p, dtype=np.int64).astype(np.int32)
    return mark_pos, rank1, rectpack


@pytest.mark.parametrize("p,budget,kind", [
    (700, 8192 + 1024, "plain"),      # test_binning.py:213 cases
    (2200, 32 * 1024, "plain"),
    (2200, 16 * 1024, "truncate"),    # marks past the budget
    (300, 2048, "empty"),             # no marks at all
])
def test_expand_matches_jax_stream(p, budget, kind):
    arrs = _marks(p, budget, truncate=kind == "truncate",
                  empty=kind == "empty")
    want = jbin._expand_stream(*(jnp.asarray(a) for a in arrs), budget)
    got = tbin.expand_stream(*(torch.as_tensor(a) for a in arrs), budget)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and g.shape == (budget,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _scene_prep(eye=(0.3, -0.2, -3.2)):
    xyz, feats, scales, rots, opac, deg = make_scene()
    cam = JCamera.look_at(eye=eye, target=(0, 0, 0), width=W, height=H)
    return jprep.preprocess(xyz, scales, rots, opac, feats, deg,
                            cam.params())


def _slack_prep():
    """One 1-tile splat per tile of an 8x8 grid: the K-alignment slack
    need exceeds the statistical pool (total_padded > b_pad)."""
    n = 64
    ys, xs = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    rmin = np.stack([xs.reshape(-1), ys.reshape(-1)], 1).astype(np.int32)
    z = np.zeros((n, 2), np.float32)
    return jprep.PreprocessOut(
        means2d=z, depths=np.linspace(1, 2, n).astype(np.float32),
        conic=np.zeros((n, 3), np.float32), opacity=np.zeros(n, np.float32),
        color=np.zeros((n, 3), np.float32), radii=np.ones(n, np.int32),
        rect_min=rmin, rect_max=rmin + 1, tiles_touched=np.ones(n, np.int32))


CASES = {
    # name: (PreprocessOut factory, width, height, budget)
    "scene": (_scene_prep, W, H, 4096),
    "scene_overflow": (_scene_prep, W, H, 128),
    "synthetic": (lambda: make_prep(200, 7, 5, np.random.default_rng(3)),
                  112, 80, 4096),
    "synthetic_truncated": (
        lambda: make_prep(150, 6, 4, np.random.default_rng(5), 0.1),
        96, 64, 256),
    "slack_overflow": (_slack_prep, 128, 128, 128),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bin_gaussians_bit_identical(name):
    build, width, height, budget = CASES[name]
    prep_np = jprep.PreprocessOut(*(np.asarray(a) for a in build()))
    want = jbin.bin_gaussians(
        jprep.PreprocessOut(*(jnp.asarray(a) for a in prep_np)), width,
        height, budget)
    got = tbin.bin_gaussians(
        tprep.PreprocessOut(*(torch.as_tensor(a) for a in prep_np)), width,
        height, budget)
    for field in want._fields:
        a = np.asarray(getattr(want, field))
        b = getattr(got, field).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    nr, tp = int(want.num_rendered), int(want.total_padded)
    if name.endswith("overflow") or name.endswith("truncated"):
        assert nr > budget or tp > want.gauss_aligned.shape[0]


def test_padded_size_matches_jax():
    for w, h, b in [(56, 40, 4096), (1920, 1080, 1 << 22), (512, 512, 3 << 18),
                    (128, 128, 100)]:
        assert tbin.padded_size(b, w, h) == jbin.padded_size(b, w, h)


def test_zero_primitives():
    """An empty pool bins to all-padding with empty tile ranges."""
    z = torch.zeros((0, 2), dtype=torch.int32)
    f = torch.zeros((0,))
    prep = tprep.PreprocessOut(
        means2d=torch.zeros((0, 2)), depths=f, conic=torch.zeros((0, 3)),
        opacity=f, color=torch.zeros((0, 3)),
        radii=torch.zeros(0, dtype=torch.int32), rect_min=z, rect_max=z,
        tiles_touched=torch.zeros(0, dtype=torch.int32))
    b = tbin.bin_gaussians(prep, 64, 48, 1024)
    assert int(b.num_rendered) == 0 and bool(b.pad_mask.all())
    assert torch.equal(b.tile_ranges[0], b.tile_ranges[1])
    assert b.seg_bounds.tolist() == [0]


def keys_by_search(offsets, counts, rectpack, pad_start, nv, grid_x, budget,
                   b_pad):
    """csrc/expand.cu's algorithm in torch: a real slot below nv is owned
    by the first rank whose inclusive offset exceeds it, a pad slot by the
    last tile whose padding prefix sum is at or below it; real slot nv + j
    holds pad b_pad - budget + j where every pad fits in b_pad."""
    p = offsets.shape[0]
    num_tiles = pad_start.shape[0] - 1
    pp1 = p + 1
    s = torch.arange(budget, dtype=torch.int32)
    key = torch.full((budget,), num_tiles * pp1 + p, dtype=torch.int64)
    if p > 0:
        i = torch.searchsorted(offsets, s, right=True).clamp(max=p - 1)
        r = s - (offsets[i] - counts[i])
        rect = rectpack[i]
        w = (rect & 1023) + 1
        ty = ((rect >> 10) & 1023) + torch.div(r, w, rounding_mode="trunc")
        tx = (rect >> 20) + torch.fmod(r, w)
        real = (ty * grid_x + tx).long() * pp1 + i
        key = torch.where(s < nv, real, key)
    need = pad_start[-1]
    k = b_pad - budget + s - nv
    t = torch.searchsorted(pad_start, k, right=True) - 1
    spill = (s >= nv) & (nv + need <= b_pad) & (k < need)
    key = torch.where(spill, t.long() * pp1 + p, key)
    k = torch.arange(b_pad - budget, dtype=torch.int32)
    t = torch.searchsorted(pad_start, k, right=True) - 1
    return torch.cat([key, t.long() * pp1 + p])


EXPAND_CASES = cs.expand_cases()


@pytest.mark.parametrize("idx", range(len(EXPAND_CASES)),
                         ids=[f"{i}-{c[0]}" for i, c in
                              enumerate(EXPAND_CASES)])
def test_bin_keys_search_matches_plain(idx):
    name, case = EXPAND_CASES[idx]
    kw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in case.items()}
    want = tbin.bin_keys_plain(**kw)
    assert want.dtype == torch.int64 and want.shape == (case["b_pad"],)
    assert torch.equal(keys_by_search(**kw), want), name
    # the CPU dispatch is the plain version
    assert torch.equal(tbin.bin_keys(**kw), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bin_keys_search_on_binning_scenes(name, monkeypatch):
    """The keys of each bit-identity scene, as bin_gaussians asks for
    them."""
    build, width, height, budget = CASES[name]
    prep = tprep.PreprocessOut(*(torch.as_tensor(np.array(a))
                                 for a in build()))
    seen = []
    plain = tbin.bin_keys

    def spy(*a):
        seen.append(a)
        return plain(*a)

    monkeypatch.setattr(tbin, "bin_keys", spy)
    tbin.bin_gaussians(prep, width, height, budget)
    (args,) = seen
    assert torch.equal(keys_by_search(*args), tbin.bin_keys_plain(*args))
