"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, and loaded with ``ctypes``. Libraries go to ``build/`` inside the
package (git-ignored), named by a hash of their source and of every
header ``csrc/*.cuh``, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import: the CPU
tests import every module on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..base import MXNetError

__all__ = ["SOURCES", "library", "build_all", "build_log"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
#: every kernel source of the package, by name (``csrc/<name>.cu``)
SOURCES = ("fused_lstm", "fused_lstm_train", "conv1x1_s2_dgrad",
           "flash_attention", "multi_tensor_update", "greedy_nms",
           "sparse_row_update")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise MXNetError("nvcc not found (PATH, $CUDA_HOME/bin, "
                         "/usr/local/cuda/bin): the CUDA kernels of "
                         "mxnet_tpu_torch are built at first use")
    return path


def _target(name):
    """(source, library path): the name hashes the source and every
    header of ``CSRC``, which any source may include."""
    src = CSRC / ("%s.cu" % name)
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:16]
    return src, BUILD_DIR / ("lib%s-%s.so" % (name, tag))


def build_log(name):
    """The compiler's output for ``name`` (``-Xptxas=-v`` register and
    shared-memory report), or None when it was not built here."""
    log = _target(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else None


def _start(name):
    """Start nvcc for ``name`` unless its library exists; returns
    (proc, tmp, so) or None."""
    src, so = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(so.name + ".%d.tmp" % os.getpid())
    log = open(so.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=log,
                                stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp, so


def _finish(name, started):
    if started is not None:
        proc, tmp, so = started
        if proc.wait() != 0:
            raise MXNetError("nvcc failed for csrc/%s.cu:\n%s"
                             % (name, build_log(name)))
        os.replace(tmp, so)
    _libs[name] = ctypes.CDLL(str(_target(name)[1]))


def build_all(names=SOURCES):
    """Build every named kernel library, all nvcc processes at once;
    returns the wall seconds it took. Already-loaded libraries cost 0."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = {n: _start(n) for n in todo}
        errors = []
        for n in todo:    # wait for every nvcc before reporting a failure
            try:
                _finish(n, started[n])
            except MXNetError as exc:
                errors.append(exc)
        if errors:
            raise errors[0]
    return time.perf_counter() - t0


def library(name) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib
