"""reduced3dgs_torch — the PyTorch + CUDA (Hopper) port of reduced3dgs_tpu.

The module layout mirrors the JAX package (``ops/``, ``models/``,
``data/``, ``renderer.py``, ``scene.py``, ``cameras.py``) so every file has
one counterpart there.  This package imports torch and never jax; the
kernels of the render path are hand-written CUDA C++ under ``csrc/``,
built with nvcc on first use into ``_build/`` and bound with ctypes
(``ops/_cuda.py``).  Entry points run on the card unless the caller asks
for ``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
