"""The per-primitive gradient reduction of the port (K5 / K6 plain versions
and segment_reduce_by_src) against the JAX package and against the bf16x2
packing it replaces.

JAX runs on the CPU with its Pallas kernels in interpret mode, as
tests/test_tile_render.py runs them; the port runs the plain versions of
its kernels (the CUDA kernels are held to these on a card, in
tests/test_torch_gpu.py and chip_smoke.py).  Tolerances:

* segment sums against the JAX package: rtol 2e-5, atol 2e-4
  (tests/test_tile_render.py:192; the JAX kernels difference two running
  prefix sums, the port sums each segment directly);
* K6's plain version against pack_bf16x2 -> unpack_bf16x2 -> a sequential
  f32 sum: bit-identical (the same values added in the same order);
* the record layout (the transposed view of K3's slot-major output)
  against contiguous rows: bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    kernel_inputs, plain_inputs, ragged_segments, skewed_lens,
)

from reduced3dgs_torch.ops import binning as tbin
from reduced3dgs_torch.ops import tile_render as ttr
from reduced3dgs_tpu.ops import binning as jbin
from reduced3dgs_tpu.ops import tile_render as jtr

MODES = ("f32", "bf16x2")


def _layout(name):
    """(fields, (9, B_pad) rows in slot order, the rows in segment order)
    of one named segment layout."""
    if name.startswith("ragged"):
        return ragged_segments(int(name[len("ragged"):]))
    if name == "skewed":
        # a few segments of 2,000+ slots and of 33-300 among thousands of 0-3
        lens = skewed_lens(p=3000, n_long=3, long_len=2500, n_mid=8,
                           mid_len=(33, 300), short_max=3)
        return ragged_segments(3000, lens=lens)
    if name == "mostly_empty":
        lens = np.zeros(900, np.int64)
        lens[[0, 17, 18, 450, 899]] = [3, 1, 40, 7, 2]
        return ragged_segments(900, lens=lens)
    assert name == "all_pads"
    return ragged_segments(300, lens=np.zeros(300, np.int64))


def _binnings(fields):
    jb = jbin.BinningOut(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = tbin.BinningOut(**{k: torch.as_tensor(np.asarray(v))
                            for k, v in fields.items()})
    return jb, tb


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["ragged700", "ragged2500", "skewed",
                                  "mostly_empty", "all_pads"])
def test_segment_reduce_by_src_matches_jax(name, mode):
    fields, cols, cols_sorted = _layout(name)
    jb, tb = _binnings(fields)
    p = fields["prim_inv"].shape[0]
    bounds = fields["seg_bounds"]
    lens = np.diff(bounds)
    if name == "skewed":
        assert (lens >= 2000).sum() >= 3 and (lens <= 3).sum() > 2900
    if name == "all_pads":
        assert int(bounds[-1]) == 0
    want = np.stack([np.asarray(o) for o in jax.jit(
        jtr._segment_reduce_by_src, static_argnums=2)(
            [jnp.asarray(c) for c in cols], jb, mode)])
    got = ttr.segment_reduce_by_src(torch.as_tensor(cols), tb, mode).numpy()
    assert got.shape == (9, p) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
    empty = (lens == 0)[fields["prim_inv"]]
    np.testing.assert_array_equal(got[:, empty], 0.0)
    if mode == "f32":
        ref = np.zeros((9, p))
        for r in np.nonzero(lens)[0]:
            ref[:, r] = cols_sorted[:, bounds[r]:bounds[r + 1]].sum(
                axis=1, dtype=np.float64)
        np.testing.assert_allclose(got, ref[:, fields["prim_inv"]],
                                   rtol=2e-5, atol=2e-4)


def _bf16_rne(x):
    """f32 -> the nearest bf16 (ties to even), widened back to f32, by
    integer arithmetic on the bits (finite inputs)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def _rounding_probes():
    """f32 values around bf16 rounding boundaries: exact ties (to even, up
    and down), just above and below a tie, a round-up that crosses a
    power of two, negatives of all of them, zeros of both signs, tiny and
    large magnitudes."""
    bits = np.array([
        0x3F808000,  # 1 + 2^-8: a tie, the even neighbour is below
        0x3F818000,  # a tie whose even neighbour is above
        0x3F808001, 0x3F807FFF,  # just above / below a tie
        0x3F7FFFFF,  # rounds up across 1.0
        0x3F7F8000,  # a tie that rounds up across 1.0
        0x477FE000,  # 65504
        0x00800001, 0x7F7F0000,  # near the smallest normal, large
        0x3DCCCCCD, 0x40490FDB,  # 0.1, pi
        0x00000000,
    ], np.uint32)
    vals = bits.view(np.float32)
    return np.concatenate([vals, -vals])


def test_through_bf16x2_is_round_to_nearest_even():
    v = _rounding_probes()
    rows = np.tile(v, (9, 1))
    got = ttr.through_bf16x2(torch.as_tensor(rows)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.tile(_bf16_rne(v),
                                                            (9, 1))))
    # a tie goes to the even neighbour, below or above
    assert _bits(_bf16_rne(v[:2])).tolist() == [0x3F800000, 0x3F820000]
    assert _bf16_rne(v[4:6]).tolist() == [1.0, 1.0]


def test_packed_plain_is_bitwise_pack_unpack_sum():
    """K6's plain version on f32 rows: bit for bit the sequential f32 sum,
    in segment order, of the values that pack_bf16x2 -> unpack_bf16x2
    carry, on normal values salted with the rounding probes."""
    fields, cols, _ = ragged_segments(700)
    probes = _rounding_probes()
    rng = np.random.default_rng(9)
    cols = cols.copy()
    where = rng.integers(0, cols.shape[1], (9, 4 * probes.size))
    for r in range(9):
        cols[r, where[r]] = np.tile(probes, 4)
    _, tb = _binnings(fields)
    order = ttr.segment_order(tb)
    bounds = tb.seg_bounds
    got = ttr.seg_reduce_plain(torch.as_tensor(cols), order, bounds,
                               packed=True).numpy()
    rounded = _bf16_rne(cols).reshape(cols.shape)[:, order.numpy()]
    want = np.zeros_like(got)
    b = bounds.numpy()
    for r in range(b.size - 1):
        acc = np.zeros(9, np.float32)
        for s in range(b[r], b[r + 1]):
            acc = acc + rounded[:, s]
        want[:, r] = acc
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the rounding matters on this input
    exact = ttr.seg_reduce_plain(torch.as_tensor(cols), order, bounds,
                                 packed=False).numpy()
    assert not np.array_equal(got, exact)


def _packed_rows_route(dfeat, binning):
    """The reduction as it ran before K6 rounded in registers: the rows
    packed in bf16 pairs over every slot, gathered through the sort's
    index as int32, unpacked and added."""
    rows = torch.cat([dfeat[:9], torch.zeros_like(dfeat[:1])])
    rows = ttr.pack_bf16x2(rows[0::2], rows[1::2])  # (5, B_pad) int32
    order = ttr.segment_order(binning)
    bounds = binning.seg_bounds
    n = int(bounds[-1])
    hi, lo = ttr.unpack_bf16x2(rows[:, order[:n]])
    vals = torch.stack([hi, lo], dim=1).reshape(-1, n)[:9]
    num_p = bounds.shape[0] - 1
    seg = torch.repeat_interleave(torch.arange(num_p),
                                  (bounds[1:] - bounds[:-1]).long(),
                                  output_size=n)
    sums = torch.zeros((9, num_p)).index_add_(1, seg, vals)
    return sums[:, binning.prim_inv.long()]


def test_bf16x2_reduction_is_bitwise_the_packed_rows_route():
    """segment_reduce_by_src(bf16x2) on K3's gradients of a small scene,
    and on a ragged layout, against the packed-rows route it replaces."""
    _, b, walk_in = kernel_inputs("cpu", 96, 64, 3000, (0.02, 0.08),
                                  1 << 15)
    feat, ranges, limit = plain_inputs(walk_in)
    packed = ttr.tile_fwd_plain(feat, ranges, limit, 6, 96, 64)
    g = torch.as_tensor(np.random.default_rng(4).normal(
        0, 1, tuple(packed.shape)).astype(np.float32))
    dfeat = ttr.tile_bwd_plain(feat, ranges, limit, 6, 96, 64, g, packed)
    assert int(b.seg_bounds[-1]) > 3000
    got = ttr.segment_reduce_by_src(dfeat, b, "bf16x2")
    assert torch.equal(got, _packed_rows_route(dfeat, b))
    assert not torch.equal(got, ttr.segment_reduce_by_src(dfeat, b, "f32"))
    fields, cols, _ = ragged_segments(2500)
    _, tb = _binnings(fields)
    cols = torch.as_tensor(cols)
    assert torch.equal(ttr.segment_reduce_by_src(cols, tb, "bf16x2"),
                       _packed_rows_route(cols, tb))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rec", [12, 16])
def test_record_layout_gives_the_same_sums(rec, packed):
    """The plain versions on the transposed view of (B_pad, rec) slot-major
    records, the layout K3 writes on the card, against contiguous rows."""
    fields, cols, _ = ragged_segments(700)
    _, tb = _binnings(fields)
    rows = torch.as_tensor(cols)
    view = ttr.as_records(rows, rec)
    assert view.shape == rows.shape and view.stride() == (1, rec)
    assert view.data_ptr() % 16 == 0 and torch.equal(view, rows)
    base = view.T  # (B_pad, 9) of the (B_pad, rec) records
    assert base.stride() == (rec, 1)
    order = ttr.segment_order(tb)
    a = ttr.seg_reduce_plain(view, order, tb.seg_bounds, packed)
    b = ttr.seg_reduce_plain(rows, order, tb.seg_bounds, packed)
    assert torch.equal(a, b)
    mode = "bf16x2" if packed else "f32"
    assert torch.equal(ttr.segment_reduce_by_src(view, tb, mode),
                       ttr.segment_reduce_by_src(rows, tb, mode))


def test_card_wrapper_takes_only_the_record_layout():
    """_seg_reduce_cuda refuses contiguous rows, a record width that is
    not a multiple of 4 floats, and int32 packed rows, before any launch."""
    order = torch.zeros(128, dtype=torch.int64)
    bounds = torch.zeros(3, dtype=torch.int32)
    before = (ttr.SEG_REDUCE_F32.launches, ttr.SEG_REDUCE_PACKED.launches)
    bad = [torch.zeros((9, 128)),
           torch.zeros((128, 9)).T,
           torch.zeros((128, 14)).T[:9],
           torch.zeros((5, 128), dtype=torch.int32)]
    for rows in bad:
        for packed in (False, True):
            with pytest.raises(ValueError, match="slot-major records"):
                ttr._seg_reduce_cuda(rows, order, bounds, packed)
    assert (ttr.SEG_REDUCE_F32.launches,
            ttr.SEG_REDUCE_PACKED.launches) == before
