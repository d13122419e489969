"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles on first use into one shared library with
a plain C interface under ``reduced3dgs_torch/_build/``; the file name
carries a hash of the source, of every header of ``csrc/`` it includes
and of the flags, so an edited source or header rebuilds and a stale
library is never loaded.  Nothing here runs at import time: this
module imports on machines without nvcc or a card (the CPU tests), and a
kernel is only built when a wrapper is first handed a CUDA tensor.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``Kernel.__call__`` raises on a non-zero value,
and counts a launch only after it succeeded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("expand", "tile_counts", "tile_fwd", "tile_bwd", "tile_trans",
           "seg_reduce", "stamp", "preprocess_fwd", "preprocess_bwd", "knn")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every file of ``csrc/`` it includes with
    quotes, directly or through another such file."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(CSRC / inc.decode())
    return files


def define_default(file: str, macro: str) -> int:
    """The integer ``csrc/<file>`` gives ``macro`` when no -D overrides it
    (``#ifndef MACRO`` / ``#define MACRO N``)."""
    m = re.search(rb"^#ifndef %b\n#define %b (\d+)" % ((macro.encode(),) * 2),
                  (CSRC / file).read_bytes(), re.M)
    if m is None:
        raise KeyError(f"{file} has no default for {macro}")
    return int(m.group(1))


def library_path(name: str, defines: tuple = ()) -> Path:
    """The library of ``csrc/<name>.cu`` built with the -D flags
    `defines` (e.g. ``("-DWALK_EXP2=0",)``; none for the sources'
    defaults)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES, variants=()) -> None:
    """Compile the named sources and the (name, defines) `variants` that
    are not built yet, one nvcc process per library, all started
    together."""
    jobs = [(n, ()) for n in names] + [(n, tuple(d)) for n, d in variants]
    todo = [j for j in jobs if not library_path(*j).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, defines in todo:
        out = library_path(name, defines)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent build is harmless
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


@functools.cache
def _library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    build((), [(name, defines)])
    lib = ctypes.CDLL(str(library_path(name, defines)))
    lib.r3dgs_error_string.restype = ctypes.c_char_p
    lib.r3dgs_error_string.argtypes = [ctypes.c_int]
    return lib


def int_constant(source: str, symbol: str) -> int:
    """What the C function `symbol` of ``csrc/<source>.cu`` (no arguments,
    returning int) returns: a constant of the source, read from its build
    (so it builds the source)."""
    return int(getattr(_library(source), symbol)())


class Kernel:
    """One C entry point of one source, with its launch count.

    ``launches`` counts successful launches only; callers that want to
    show a run went through the kernel reset it to 0 before the run.
    ``defines``: -D flags of a build other than the sources' defaults.
    """

    def __init__(self, source: str, symbol: str, argtypes, defines=()):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.defines = tuple(defines)
        self.launches = 0
        self._bound = None

    def __call__(self, *args) -> None:
        if self._bound is None:  # build + bind on the first launch
            fn = getattr(_library(self.source, self.defines), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._bound = fn
        err = self._bound(*args)
        if err != 0:
            msg = _library(self.source, self.defines).r3dgs_error_string(
                err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
