"""The port's kNN (reduced3dgs_torch/ops/knn.py) against the JAX package's
(reduced3dgs_tpu/ops/knn.py), on the same numpy-seeded points.

* morton_codes: bit for bit, every grid offset of the window sweep;
* _window_knn: indices equal, distances rtol 1e-6;
* _blocked_knn_step at box 128 on the clustered mix of tests/test_knn.py:
  the same certificate at every shortlist size; where certified, the
  distances within rtol 1e-5 / atol 2e-6 of the exact ones (tests/
  test_knn.py's tolerance: the expanded form's cancellation breaks near
  ties in another order in each framework, so indices are compared by
  the distances they give);
* the ladder on the collinear case; auto-select above EXACT_LIMIT against
  knn_exact; absent (+inf) rows never a neighbour on the blocked path.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reduced3dgs_torch.ops import knn as tknn
from reduced3dgs_tpu.ops import knn as jknn


def _clustered(seed=7):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(0, 0.15, (900, 3)),
        rng.uniform(-2, 2, (700, 3)),
        rng.normal([1.5, -1.0, 0.5], 0.02, (400, 3)),
    ]).astype(np.float32)


def _collinear():
    t = np.linspace(0, 1, 3000, dtype=np.float32)
    rng = np.random.default_rng(3)
    return np.stack([t, t, t], 1) + rng.normal(0, 1e-4, (3000, 3)).astype(
        np.float32)


def _direct(pts, idx):
    return ((pts[idx].astype(np.float64) - pts[:, None, :]) ** 2).sum(-1)


@pytest.fixture
def searches(monkeypatch):
    """The searches knn() ran, in call order: ("blocked", m, certified) per
    rung of the ladder, ("window",) and ("brute",) (the exact search on
    the real rows)."""
    calls = []
    step, window, real = (tknn._blocked_knn_step, tknn._window_knn,
                          tknn._knn_real)

    def rec_step(points, k, m, box):
        out = step(points, k, m, box)
        calls.append(("blocked", m, bool(out[2])))
        return out

    def rec_window(points, k, w):
        calls.append(("window",))
        return window(points, k, w)

    def rec_real(points, k):
        calls.append(("brute",))
        return real(points, k)

    monkeypatch.setattr(tknn, "_blocked_knn_step", rec_step)
    monkeypatch.setattr(tknn, "_window_knn", rec_window)
    monkeypatch.setattr(tknn, "_knn_real", rec_real)
    return calls


def _certified(calls):
    """The rungs ran and the last one certified; its shortlist size."""
    assert calls and all(c[0] == "blocked" for c in calls), calls
    assert calls[-1][2] and not any(c[2] for c in calls[:-1]), calls
    return calls[-1][1]


def _same_neighbours(pts, d2, idx, want_d2, rtol=1e-5, atol=2e-6):
    """d2 / idx are a true k-NN answer: the distances agree with the exact
    ones and the listed indices really lie at them."""
    np.testing.assert_allclose(d2, want_d2, rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.sort(_direct(pts, idx), 1),
                               np.sort(want_d2, 1), rtol=1e-4, atol=atol)


@pytest.mark.parametrize("offset", [0.0, 341.0, 682.0, 170.0])
def test_morton_codes_bit_exact(offset):
    pts = _clustered()
    pts[::97] = np.inf  # absent rows land in the top cell in both
    for perm in ((0, 1, 2), (2, 0, 1)):
        p = pts[:, list(perm)]
        want = np.asarray(jknn.morton_codes(jnp.asarray(p), offset))
        got = tknn.morton_codes(torch.as_tensor(p), offset)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_window_knn_matches_jax(searches):
    pts = _clustered()
    d_j, i_j = jknn._window_knn(jnp.asarray(pts), 6, 16)
    d_t, i_t = tknn._window_knn(torch.as_tensor(pts), 6, 16)
    searches.clear()
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6)
    # the auto-selected opt-in path is the same sweep
    d_k, i_k = tknn.knn(torch.as_tensor(pts), 6, window=16, exact=False)
    assert torch.equal(i_k, i_t) and searches == [("window",)]


@pytest.mark.parametrize("m", [1, 4, 8, 15])
def test_blocked_step_certificate_matches_jax(m):
    pts = _clustered()
    d2_j, _, ok_j = jknn._blocked_knn_step(jnp.asarray(pts), 6, m, 128)
    d2_t, i_t, ok_t = tknn._blocked_knn_step(torch.as_tensor(pts), 6, m,
                                             128)
    assert ok_t.dtype == torch.bool and ok_t.ndim == 0
    assert bool(ok_t) == bool(ok_j)
    if bool(ok_t):  # certified claims are true claims
        want, _ = tknn.knn_exact(torch.as_tensor(pts), 6)
        _same_neighbours(pts, d2_t.numpy(), i_t.numpy(), want.numpy())
        np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j),
                                   rtol=1e-5, atol=2e-6)


def test_blocked_ladder_on_the_collinear_case(searches):
    """m = 1 on collinear points: the same certificate bit as the JAX
    package; the ladder ends exact."""
    pts = _collinear()
    _, _, ok_j = jknn._blocked_knn_step(jnp.asarray(pts), 4, 1, 128)
    _, _, ok_t = tknn._blocked_knn_step(torch.as_tensor(pts), 4, 1, 128)
    assert bool(ok_t) == bool(ok_j)
    searches.clear()
    d2, idx = tknn._blocked_knn(torch.as_tensor(pts), 4, box=128)
    _certified(searches)
    want, _ = tknn.knn_exact(torch.as_tensor(pts), 4)
    _same_neighbours(pts, d2.numpy(), idx.numpy(), want.numpy(), rtol=1e-4)


def test_blocked_ladder_falls_back_with_a_warning(monkeypatch, searches):
    """A ladder that never certifies warns and answers by brute force."""
    pts = torch.as_tensor(_clustered()[:600])
    monkeypatch.setattr(tknn, "_M_LADDER", (1,))
    with pytest.warns(RuntimeWarning, match="falling back"):
        d2, idx = tknn._blocked_knn(pts, 6, box=128)
    assert searches == [("blocked", 1, False), ("brute",)]
    want, want_i = tknn.knn_exact(pts, 6)
    assert torch.equal(d2, want) and torch.equal(idx, want_i)


def test_knn_auto_select_above_the_exact_limit(searches):
    """~40k points: knn() takes the certified blocked search (the JAX
    package's rule) and gives knn_exact's neighbours; below the limit it
    is knn_exact."""
    rng = np.random.default_rng(11)
    n = tknn.EXACT_LIMIT + 7232
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    t = torch.as_tensor(pts)
    d2, idx = tknn.knn(t, 3)
    assert _certified(searches) in tknn._M_LADDER
    want, want_i = tknn.knn_exact(t, 3)
    np.testing.assert_allclose(d2.numpy(), want.numpy(), rtol=1e-5,
                               atol=2e-6)
    same = (np.sort(idx.numpy(), 1) == np.sort(want_i.numpy(), 1)).all(1)
    assert same.mean() > 0.999  # the rest are near ties
    np.testing.assert_allclose(np.sort(_direct(pts, idx.numpy()), 1),
                               np.sort(want.numpy(), 1), rtol=1e-4,
                               atol=2e-6)
    small = t[:1000]
    searches.clear()
    assert torch.equal(tknn.knn_indices(small, 5), tknn.knn_exact(small,
                                                                   5)[1])
    assert searches[0] == ("brute",)
    assert torch.equal(tknn.mean_knn_dist2(small),
                       tknn.knn_exact(small, 3)[0].mean(1))


def test_absent_rows_are_never_neighbours_on_the_blocked_path(searches):
    """A compacted pool above EXACT_LIMIT rows with +inf padding: the
    blocked search runs on the real rows, whose lists hold real rows only;
    the padding's own lists are inf."""
    rng = np.random.default_rng(4)
    n_real = tknn.EXACT_LIMIT + 1000
    pts = np.full((1 << 16, 3), np.inf, np.float32)
    pts[:n_real] = rng.uniform(-1, 1, (n_real, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        d2, idx = tknn.knn(torch.as_tensor(pts), 4)
    _certified(searches)
    assert bool((idx[:n_real] < n_real).all())
    assert bool(torch.isfinite(d2[:n_real]).all())
    assert bool(torch.isinf(d2[n_real:]).all())
    assert not torch.isnan(d2).any()
    real = pts[:n_real].astype(np.float64)
    for q in range(0, n_real, 997):  # sampled rows against numpy
        dq = ((real - real[q]) ** 2).sum(1)
        dq[q] = np.inf
        np.testing.assert_allclose(d2[q].numpy(), np.sort(dq)[:4],
                                   rtol=1e-5, atol=2e-6)
