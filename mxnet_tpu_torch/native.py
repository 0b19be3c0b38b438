"""Build the ``MXPred*`` C predict library and its C client.

Counterpart of the JAX package's ``src/Makefile`` targets ``predict`` and
``tests/predict_demo``: ``csrc/c_predict_api.cc`` (with ``csrc/error.cc``)
is compiled with the host C++ compiler into
``build/libmxtorch_predict-<hash>.so``, a shared library that embeds
CPython and delegates every ``MXPred*`` call to the ``_c_*`` helpers of
`predict.py`, and ``csrc/predict_client.c`` with the host C compiler into
``build/predict_client-<hash>``, linked against it. Both are built at
first use, from :func:`predict_library` / :func:`predict_client`, and
named by a hash of the sources, the compilers and the Python they embed,
so an edited source is rebuilt and an unchanged one is reused. The
include and link flags come from `sysconfig` (``python3-config`` is not
on every host). ``CXX`` and ``CC`` name the compilers (default ``g++``
and ``cc``).

A process that loads the library must find ``mxnet_tpu_torch`` and
``torch`` on its ``PYTHONPATH``: :func:`client_env` gives the
environment the client needs.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

from .base import MXNetError

__all__ = ["predict_library", "predict_client", "client_env"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_LIB_SOURCES = ("c_predict_api.cc", "error.cc")
_HEADERS = ("py_embed.h", "error.h")
_CLIENT = "predict_client.c"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-fvisibility=hidden",
            "-pthread")

_lock = threading.Lock()


def _python_flags():
    """(include flags, link flags) of this Python for embedding, from
    `sysconfig`."""
    inc = ["-I" + sysconfig.get_paths()["include"]]
    plat = sysconfig.get_paths().get("platinclude")
    if plat and "-I" + plat not in inc:
        inc.append("-I" + plat)
    var = sysconfig.get_config_var
    version = var("LDVERSION") or var("VERSION")
    libdir = var("LIBDIR") or ""
    link = []
    for d in (libdir, var("LIBPL")):
        if d and os.path.isdir(d):
            link += ["-L" + d, "-Wl,-rpath," + d]
    link.append("-lpython" + version)
    for flags in (var("LIBS"), var("SYSLIBS")):
        link += (flags or "").split()
    return inc, link


def _tag(files, *extra):
    digest = hashlib.sha256()
    for f in files:
        digest.update(f.encode())
        digest.update((CSRC / f).read_bytes())
    for e in extra:
        digest.update(repr(e).encode())
    return digest.hexdigest()[:16]


def _compile(cmd, out):
    """Run ``cmd`` writing ``out`` through a temporary name; raise with
    the compiler's output when it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
    proc = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError("building %s failed (%s):\n%s%s"
                         % (out.name, " ".join(cmd), proc.stdout,
                            proc.stderr))
    os.replace(tmp, out)
    return out


def predict_library():
    """The path of the ``MXPred*`` shared library, built if needed."""
    cxx = os.environ.get("CXX", "g++")
    inc, link = _python_flags()
    tag = _tag(_LIB_SOURCES + _HEADERS, cxx, CXXFLAGS, inc, link,
               sys.version)
    out = BUILD_DIR / ("libmxtorch_predict-%s.so" % tag)
    with _lock:
        if not out.exists():
            _compile([cxx, *CXXFLAGS, *inc, "-shared",
                      *[str(CSRC / f) for f in _LIB_SOURCES], *link], out)
    return out


def predict_client():
    """The path of the C client (``csrc/predict_client.c``), built
    against :func:`predict_library` if needed."""
    lib = predict_library()
    cc = os.environ.get("CC", "cc")
    out = BUILD_DIR / ("predict_client-%s" % _tag((_CLIENT,), cc,
                                                   lib.name))
    with _lock:
        if not out.exists():
            _compile([cc, "-O2", "-Wall", str(CSRC / _CLIENT), str(lib),
                      "-Wl,-rpath," + str(lib.parent)], out)
    return out


def client_env(env=None):
    """``env`` (default ``os.environ``) with ``PYTHONPATH`` holding the
    repository and this interpreter's ``sys.path``, so the interpreter
    that the library embeds imports this ``mxnet_tpu_torch`` and
    ``torch``."""
    env = dict(os.environ if env is None else env)
    paths = [str(_PKG.parent)] + [p for p in sys.path if p]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env
