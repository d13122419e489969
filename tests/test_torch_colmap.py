"""The port's COLMAP binary readers (reduced3dgs_torch/data/colmap.py):
the native parser (native/colmap_io.cpp built by the port into
reduced3dgs_torch/_build/) against the port's pure-Python path and against
the JAX package's reader, on files written as tests/test_colmap_io.py
writes them.

The JAX reader runs its pure-Python path here (its ``_NATIVE`` set to
None), so this file never builds the JAX package's library; the committed
native/libr3dgs_io.so must keep its bytes and mtime through the port's
build.  xyz goes through float32 on the native path of both packages:
atol 1e-5 against the float64 Python path, everything else exact.
"""

import os

import numpy as np
import pytest
from test_colmap_io import write_images_bin, write_points3d_bin

from reduced3dgs_torch.data import colmap as tcolmap
from reduced3dgs_tpu.data import colmap as jcolmap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "native", "libr3dgs_io.so")


@pytest.fixture(scope="module")
def native():
    """The port's native library, built (or found) once; the committed
    library is untouched by it."""
    before = (open(COMMITTED, "rb").read(), os.stat(COMMITTED).st_mtime_ns)
    lib = tcolmap.native_lib()
    assert lib is not None, "the port could not build native/colmap_io.cpp"
    path = tcolmap.native_library_path()
    assert path.parent == tcolmap.BUILD_DIR and path.exists()
    assert os.path.realpath(lib._name) == os.path.realpath(path)
    assert (open(COMMITTED, "rb").read(),
            os.stat(COMMITTED).st_mtime_ns) == before
    return lib


def _python_path(module, monkeypatch):
    monkeypatch.setattr(module, "_NATIVE", None)


def test_points3d_native_matches_python_and_jax(tmp_path, native,
                                               monkeypatch):
    rng = np.random.default_rng(0)
    n = 500
    xyz = rng.normal(0, 10, (n, 3))
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    err = rng.uniform(0, 2, n)
    path = str(tmp_path / "points3D.bin")
    write_points3d_bin(path, xyz, rgb, err, rng.integers(0, 9, n))

    x1, r1, e1 = tcolmap.read_points3d_binary(path)
    _python_path(tcolmap, monkeypatch)
    x2, r2, e2 = tcolmap.read_points3d_binary(path)
    _python_path(jcolmap, monkeypatch)
    x3, r3, e3 = jcolmap.read_points3d_binary(path)
    np.testing.assert_array_equal(x2, xyz)
    np.testing.assert_array_equal(x3, x2)
    np.testing.assert_allclose(x1, x2, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(x1, xyz.astype(np.float32))
    for got in (r1, r2, r3):
        np.testing.assert_array_equal(got, rgb)
    for got in (e1, e2, e3):
        np.testing.assert_array_equal(got, err)


def test_images_native_matches_python_and_jax(tmp_path, native,
                                             monkeypatch):
    rng = np.random.default_rng(1)
    images = [(i + 1, rng.normal(0, 1, 4), rng.normal(0, 1, 3), 1 + i % 3,
               f"frame_{i:04d}.jpg", int(rng.integers(0, 50)))
              for i in range(20)]
    path = str(tmp_path / "images.bin")
    write_images_bin(path, images)

    got = tcolmap.read_images_binary(path)
    _python_path(tcolmap, monkeypatch)
    py = tcolmap.read_images_binary(path)
    _python_path(jcolmap, monkeypatch)
    ref = jcolmap.read_images_binary(path)
    assert sorted(got) == sorted(py) == sorted(ref) == list(range(1, 21))
    for iid, qvec, tvec, cam_id, name, _ in images:
        for table in (got, py, ref):
            im = table[iid]
            assert (im.id, im.camera_id, im.name) == (iid, cam_id, name)
            np.testing.assert_array_equal(im.qvec, qvec)
            np.testing.assert_array_equal(im.tvec, tvec)
