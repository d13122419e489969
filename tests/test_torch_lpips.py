"""The port's LPIPS (reduced3dgs_torch/ops/lpips.py) against the JAX
package's (reduced3dgs_tpu/ops/lpips.py) with the random VGG16 + head
weights of tests/test_lpips.py (the real ones are not in the repository):
rtol 1e-5 on images of several sizes, zero on identical images, symmetric;
no weights file gives None in both."""

import numpy as np
import pytest
import torch
from test_lpips import _random_weights

from reduced3dgs_torch.ops import lpips as TL
from reduced3dgs_tpu.ops import lpips as JL


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _random_weights(tmp_path_factory.mktemp("lpips"))


@pytest.mark.parametrize("shape", [(48, 48), (40, 56), (37, 29)])
def test_lpips_matches_jax(weights, shape):
    jfn = JL.lpips_fn(weights)
    tfn = TL.lpips_fn(weights, "cpu")
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.15, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    want = float(jfn(a, b))
    got = float(tfn(ta, tb))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(tfn(ta, ta)) == 0.0
    np.testing.assert_allclose(float(tfn(tb, ta)), got, rtol=1e-6)


def test_lpips_layout_and_weights_path_match_jax(monkeypatch, tmp_path):
    assert TL.VGG_CFG == JL._VGG_CFG and TL.TAPS == JL._TAPS
    np.testing.assert_array_equal(np.float32(TL._SHIFT), JL._SHIFT)
    np.testing.assert_array_equal(np.float32(TL._SCALE), JL._SCALE)
    assert TL.weights_path() == JL._weights_path()
    monkeypatch.setenv("R3DGS_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    assert TL.weights_path() == JL._weights_path() == str(tmp_path / "w.npz")


def test_lpips_missing_weights_gives_none():
    assert TL.lpips_fn("/nonexistent/weights.npz", "cpu") is None
    assert JL.lpips_fn("/nonexistent/weights.npz") is None
