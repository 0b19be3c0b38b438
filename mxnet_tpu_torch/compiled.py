"""CompiledProgram: the compiled-program layer of the port.

Counterpart of `mxnet_tpu/compiled.py`. A :class:`CompiledProgram` wraps
a function of tensors and owns its **signature cache**: a call's
arguments are abstracted to a key (tensors by shape, dtype and device;
Python scalars by type only on the CPU, so per-call values never cause a
recompile, and by value on CUDA, where a graph keeps the value it was
captured with; static arguments by value; and the TF32 switches of cuDNN
and cuBLAS, which a capture bakes in; and whether ``autograd`` is
recording, so that a recorded call and an inference call never share a
program). A cache miss is a
*compile*; a miss beyond the first of the program's lineage is a
*retrace*, logged with an explanation of what changed
(:func:`explain_signature_change`) and kept in :func:`last_retrace`.
:func:`compile_counts` gives the process's ``compiles``, ``cache_hits``
and ``retraces`` (the keys of `mxnet_tpu/xla_stats.py::compile_counts`);
:func:`reset` clears them and every program's cache.

On a CUDA device a compile captures the function into a
``torch.cuda.CUDAGraph``, in the place of the JAX package's XLA
executable:

1. the function runs once or twice on the program's side stream with the
   auxiliary-state write-back suppressed (`ops/invoke.py`), so that
   cuDNN's algorithm choice, workspace allocation and any lazy kernel
   build happen outside the capture and BatchNorm's moving statistics do
   not step;
2. it is captured over static input buffers (a copy of every input
   tensor), into one memory pool that all the program's signatures share;
3. the static outputs are kept, and the hand kernels that the capture
   recorded, which each replay adds to their wrappers' launch counts
   (`ops/launch_count.py`).

A call then copies its inputs into the static buffers, replays the graph
and returns clones of the outputs (a replay overwrites the static ones),
all under the program's lock, since the buffers are shared by every
caller. The arguments named by ``inplace_argnums`` (a Gluon block's
parameters) are not copied: the graph reads them where they are, so
their key also holds each tensor's ``data_ptr()``. An in-place update of
such a tensor (an optimizer step, BatchNorm's moving statistics written
by the graph itself) is seen by the next replay; storage that moved (a
cast, a re-initialisation) is a new key, so one recapture, reported as a
retrace that names the tensor. A new value of a Python scalar argument
is a new signature on CUDA, so one recapture, reported as a retrace
naming the argument; the arguments named by ``key_argnums`` (a Gluon
call's random seed) stay keyed by type, since no graph reads them: a
program whose function calls an op that draws random numbers runs
uncaptured (below), as a replay would repeat its bits. An argument leaf
that is neither a tensor nor a Python scalar raises at capture. A
capture that fails for any other reason raises :class:`MXNetError`
naming the site and the error; it does not fall back to running
eagerly.

On the CPU there is no graph: the same cache, keys and counters, and a
call runs the function eagerly.

A call under ``autograd.record()`` has a signature of its own, counted
like any other (one compile, then hits), which runs eagerly on the card
too, with the tape on: a graph's replay returns clones that carry no
``grad_fn``, so it cannot be differentiated. Capturing the forward and
backward of a training step is not ported yet. The programs of the
process are the compiled Gluon blocks (site ``gluon.hybrid_forward``)
and the executors' inference forwards (site ``executor.forward``,
`executor.py`), which serve the `Predictor` and the serving engine.

A program whose function calls an op that runs Python on the host
(``Custom``, ``CTCLoss``, which call :func:`note_host_op`) cannot be
captured: a CUDA graph cannot hold the host round trip. Nor can one
whose function draws random numbers (`ops/invoke.py` notes every op
that draws): a replay would repeat the captured draws. Its signature is
not captured and runs eagerly on every call, counted once under
``compile_counts()["uncaptured"]`` and logged with the ops' names; the
warm-up runs before a capture find it. On the CPU the first run of a
signature counts it the same way.

:meth:`CompiledProgram.warmup` compiles a signature without running it
and without changing any auxiliary state (the counterpart of the JAX
package's AOT ``warmup``).

A program's function that calls another program (a hybridized child
block inside its parent) runs that one's function inline: there is one
capture at a time on a thread (:func:`running`).

Observability, as in the JAX package: each program counts into
``jit_compiles_total{site=}`` / ``jit_cache_hits_total{site=}`` /
``jit_retraces_total{site=}`` (and the unlabeled totals), times each
compile into ``jit_compile_seconds{site=}`` (on the card the capture's
wall time, its warm-up runs included) with an ``xla.compile`` event, and
books it as runprof's ``compile`` state. The cost of a signature, the
counterpart of XLA's cost and memory analysis, is taken once at its
compile: the model FLOPs of its first warm-up run (on the CPU, of its
first run) by `xla_stats.count_flops`, kept as the program's
``last_flops`` at every call of the signature, and on the card the bytes
its graph pool grew by during the capture and those of its static
outputs, booked in the memory ledger as ``xla_temp`` and ``xla_output``.
Each call outside a capture is memprof's dispatch sample (and its
``memory.oom`` chaos poll); a CUDA out-of-memory error at a call or a
compile is raised as ``memprof.DeviceOOMError``; with the profiler's
aggregate mode on, each call is one entry of its table, named by the
site (unless the program is made with ``timed=False``: the executor
times its forward as ``_executor_forward``, as the JAX package does).
Not ported: ``shardprof``, the sharding-policy slot and buffer donation.
"""
from __future__ import annotations

import contextlib
import gc
import logging
import threading
import time
import weakref

import torch

from . import autograd, telemetry, threadsan
from .base import MXNetError
from .ops import launch_count
from .ops.invoke import suppress_aux_writeback

__all__ = ["CompiledProgram", "compile_counts", "explain_signature_change",
           "last_retrace", "note_host_op", "reset", "running"]

logger = logging.getLogger(__name__)

#: eager runs on the side stream before a capture
WARMUP_RUNS = 2

_lock = threading.Lock()
_sites = {}     # lineage -> {"compiles": int, "sig": dict}
_state = {"last_retrace": None}
_counts = {"compiles": 0, "cache_hits": 0, "retraces": 0, "uncaptured": 0}
_programs = weakref.WeakSet()
_TLS = threading.local()


def compile_counts():
    """``{"compiles", "cache_hits", "retraces", "uncaptured"}`` over every
    program of the process since the last :func:`reset`; ``uncaptured``
    counts the signatures that run eagerly because their function calls
    a host op."""
    with _lock:
        return dict(_counts)


def last_retrace():
    """The most recent retrace: ``{"site", "reason", "compiles",
    "time"}``, or None."""
    with _lock:
        return dict(_state["last_retrace"]) if _state["last_retrace"] \
            else None


def reset():
    """Clear the counters, the retrace record and every live program's
    cache."""
    with _lock:
        _sites.clear()
        _state["last_retrace"] = None
        for k in _counts:
            _counts[k] = 0
        programs = list(_programs)
    for program in programs:
        with program._lock:
            program._cache.clear()


_METRICS = {
    "compiles": ("jit_compiles_total",
                 "signature compiles of CompiledProgram (on the card a CUDA "
                 "graph capture)"),
    "cache_hits": ("jit_cache_hits_total",
                   "CompiledProgram calls served by a cached signature"),
    "retraces": ("jit_retraces_total",
                 "compiles beyond the first of a program"),
}


def _count(name, site=None):
    with _lock:
        _counts[name] += 1
    metric = _METRICS.get(name)
    if metric is not None:
        telemetry.counter(metric[0], help=metric[1]).inc()
        telemetry.counter(metric[0], help=metric[1], site=site).inc()


# ---------------------------------------------------------------------------
# which program's function runs on this thread
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def inline(site):
    """Mark ``site``'s eager pass (a program's function, or a Gluon
    block's deferred-initialisation pass): hybridized blocks called inside
    it run their functions inline instead of compiling a program of their
    own."""
    prev = getattr(_TLS, "site", None)
    _TLS.site = site
    try:
        yield
    finally:
        _TLS.site = prev


def running():
    """The site of the program whose function runs on this thread (or of
    a Gluon block's deferred-initialisation pass), else None."""
    return getattr(_TLS, "site", None)


def note_host_op(name):
    """Called by an op that a CUDA graph cannot hold: one whose body runs
    on the host (``Custom``, ``CTCLoss``'s lengths), or one that draws
    random numbers. The program whose function is running is then not
    captured."""
    seen = getattr(_TLS, "host_ops", None)
    if seen is not None:
        seen.add(name)


@contextlib.contextmanager
def _host_ops():
    """Collect the names :func:`note_host_op` reports inside the scope
    (an enclosing scope sees them too)."""
    prev = getattr(_TLS, "host_ops", None)
    seen = set()
    _TLS.host_ops = seen
    try:
        yield seen
    finally:
        _TLS.host_ops = prev
        if prev is not None:
            prev |= seen


# ---------------------------------------------------------------------------
# Abstract signatures: fast hashable keys + printable descriptions
# ---------------------------------------------------------------------------
_SCALARS = (bool, int, float, complex, str, bytes)


def _describe_leaf(x, inplace=False, by_value=False):
    """One argument leaf as a hashable tuple, the part of both the cache
    key and the retrace explanation: tensors by shape, dtype, device and
    (for in-place arguments) storage address; Python scalars by type, and
    with ``by_value`` (on CUDA) by value too; anything else by type."""
    if x is None:
        return ("none",)
    if isinstance(x, torch.Tensor):
        return ("array", tuple(x.shape), x.dtype, x.device,
                x.data_ptr() if inplace else None)
    if isinstance(x, _SCALARS):
        return ("scalar", type(x).__name__, repr(x) if by_value else None)
    return ("opaque", type(x).__name__)


def _key_of(obj, inplace, by_value):
    if isinstance(obj, dict):
        return ("d",) + tuple((k, _key_of(obj[k], inplace, by_value))
                              for k in sorted(obj, key=str))
    if isinstance(obj, (list, tuple)):
        return ("t",) + tuple(_key_of(v, inplace, by_value) for v in obj)
    return _describe_leaf(obj, inplace, by_value)


def _describe_args(args, static, inplace=(), names=None, by_value=()):
    """{path: leaf description} over the positional args, built only on a
    cache miss for the retrace explainer; ``names`` maps an argument
    index to the names of its leaves (a block's parameter names), and
    ``by_value`` holds the indices whose scalars are keyed by value."""
    names = names or {}
    entries = {}

    def walk(prefix, obj, flags, labels):
        if isinstance(obj, dict):
            for k in sorted(obj, key=str):
                walk("%s[%r]" % (prefix, k), obj[k], flags, None)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                label = labels[i] if labels is not None and \
                    i < len(labels) else i
                walk("%s[%s]" % (prefix, label), v, flags, None)
        else:
            entries[prefix] = _describe_leaf(obj, *flags)

    for i, a in enumerate(args):
        if i in static:
            entries["arg%d(static)" % i] = ("static", repr(a))
        else:
            walk("arg%d" % i, a, (i in inplace, i in by_value),
                 names.get(i))
    return entries


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _fmt_desc(d):
    if d[0] == "array":
        out = "shape %s dtype %s" % (tuple(d[1]), _dtype_name(d[2]))
        if d[4] is not None:
            out += " at %s" % hex(d[4])
        return out
    if d[0] == "static":
        return "static %s" % d[1]
    if d[0] == "scalar":
        return "python %s" % d[1] + ("" if d[2] is None else " " + d[2])
    if d[0] == "opaque":
        return "opaque %s" % d[1]
    return d[0]


def _diff_desc(a, b):
    if a[0] == "array" and b[0] == "array":
        parts = []
        if a[1] != b[1]:
            msg = "shape %s -> %s" % (tuple(a[1]), tuple(b[1]))
            if len(a[1]) == len(b[1]):
                dims = ", ".join("dim %d: %s -> %s" % (i, x, y)
                                 for i, (x, y) in enumerate(zip(a[1], b[1]))
                                 if x != y)
                msg += " (%s)" % dims
            parts.append(msg)
        if a[2] != b[2]:
            parts.append("dtype %s -> %s" % (_dtype_name(a[2]),
                                             _dtype_name(b[2])))
        if a[3] != b[3]:
            parts.append("device %s -> %s" % (a[3], b[3]))
        if a[4] != b[4]:
            parts.append("storage moved %s -> %s" % (
                a[4] if a[4] is None else hex(a[4]),
                b[4] if b[4] is None else hex(b[4])))
        return ", ".join(parts) or "changed"
    if a[0] == "static" and b[0] == "static":
        return "static value %s -> %s" % (a[1], b[1])
    return "%s -> %s" % (_fmt_desc(a), _fmt_desc(b))


def explain_signature_change(old, new):
    """Human-readable diff of two ``_describe_args`` signatures: names
    every path whose description changed, down to the dimension for
    rank-preserving shape changes."""
    parts = []
    for k in sorted(set(old) | set(new)):
        a, b = old.get(k), new.get(k)
        if a == b:
            continue
        if a is None:
            parts.append("%s: new input (%s)" % (k, _fmt_desc(b)))
        elif b is None:
            parts.append("%s: input removed (was %s)" % (k, _fmt_desc(a)))
        else:
            parts.append("%s: %s" % (k, _diff_desc(a, b)))
    return "; ".join(parts) or \
        "no signature change detected (new function or closure)"


# ---------------------------------------------------------------------------
# The compiled-program layer
# ---------------------------------------------------------------------------
def _math_mode():
    """cuDNN's and cuBLAS's TF32 switches: a capture bakes the kernels
    they select into the graph, so they are part of every signature and
    a change recaptures (an eager call reads them afresh each time)."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _mode():
    """The process state every key holds: the TF32 switches and whether
    autograd is recording."""
    return _math_mode(), autograd.is_recording()


def _map(obj, fn):
    """``obj`` with every tensor leaf of its lists, tuples and dicts
    replaced by ``fn(leaf)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(v, fn) for v in obj)
    return obj


def _first_tensor(obj):
    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, dict):
        obj = obj.values()
    elif not isinstance(obj, (list, tuple)):
        return None
    for v in obj:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _leaves(obj, out):
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _leaves(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _leaves(v, out)
    return out


class _Eager:
    """A signature that runs eagerly on every call: on the CPU, a recorded
    call, or a function that calls a host op. With ``probe`` (a CPU
    signature that does not record) its first run counts it as
    uncaptured if the function calls a host op, as a capture would, and
    counts its FLOPs (``flops``) when ``xla_stats`` is on."""

    def __init__(self, probe=False, flops=None):
        self.probe = probe
        self.flops = flops

    def run(self, program, args):
        with inline(program.site), suppress_aux_writeback(False):
            if not self.probe:
                return program._fun(*args)
            self.probe = False
            from . import xla_stats
            counting = xla_stats.enabled()
            with _host_ops() as seen, (xla_stats.count_flops() if counting
                                       else contextlib.nullcontext()) as fc:
                out = program._fun(*args)
        if counting:
            self.flops = program.last_flops = fc.total or None
        if seen:
            program._uncaptured(seen)
        return out


class _Graph:
    """A CUDA signature: the captured graph, its static input buffers
    and its static outputs."""

    def __init__(self, graph, buffers, outputs, launches, flops=None):
        self.flops = flops
        self.graph = graph
        self.buffers = buffers
        self.outputs = outputs
        self.launches = launches    # the hand kernels it holds, counted
                                    # at each replay (ops/launch_count.py)

    def run(self, program, args):
        for buf, x in zip(self.buffers, program._copied(args)):
            if x is not buf:
                buf.copy_(x)
        self.graph.replay()
        launch_count.replayed(self.launches)
        return _map(self.outputs, torch.clone)


class CompiledProgram:
    """A function of tensors with its signature cache; on CUDA each
    signature is one captured ``CUDAGraph`` (see the module docstring).

    ``static_argnums`` are keyed by value; ``inplace_argnums`` are read by
    the graph where they lie (keyed by storage address, never copied);
    ``key_argnums`` only seed random ops (a Gluon call's ``key``), so
    their scalars are keyed by type on CUDA too;
    ``arg_names`` maps an argument index to the names of its leaves, for
    the retrace explanation; ``timed=False`` leaves the program's calls
    out of the profiler's aggregate table (its caller times them).
    ``lineage`` scopes retrace detection as in the JAX package: programs
    sharing ``(site, lineage)`` (the rebuilt programs of one Gluon block)
    diff against each other; by default this program only.
    """

    def __init__(self, fun, site, static_argnums=(), inplace_argnums=(),
                 key_argnums=(), lineage=None, arg_names=None, timed=True):
        self.site = site
        self._timed = timed
        self._fun = fun
        self._lineage = (site, lineage if lineage is not None else id(self))
        self._static = frozenset(static_argnums)
        self._inplace = frozenset(inplace_argnums)
        self._keys = frozenset(key_argnums)
        self._names = dict(arg_names or {})
        self._cache = {}
        self._lock = threading.Lock()
        self._stream = None     # side stream of the warm-ups and captures
        self._pool = None       # one graph memory pool for all signatures
        #: the model FLOPs of the last call's signature (None: unknown)
        self.last_flops = None
        _programs.add(self)

    def _device(self, args):
        """The device of the first tensor of the non-static arguments."""
        t = _first_tensor([a for i, a in enumerate(args)
                           if i not in self._static])
        return None if t is None else t.device

    def _by_value(self, args, device):
        """The argument indices whose scalars a capture would bake in:
        on CUDA, every one but the static and the key arguments."""
        if device is None or device.type != "cuda":
            return frozenset()
        return frozenset(range(len(args))) - self._static - self._keys

    def _key(self, args):
        by_value = self._by_value(args, self._device(args))
        return tuple(("s", a) if i in self._static
                     else _key_of(a, i in self._inplace, i in by_value)
                     for i, a in enumerate(args)) + (_mode(),)

    def _copied(self, args):
        """The tensors of ``args`` that a replay copies into its buffers,
        in order."""
        out = []
        for i, a in enumerate(args):
            if i not in self._static and i not in self._inplace:
                _leaves(a, out)
        return out

    def __call__(self, *args):
        if running() is not None:
            # inside another program's function: run inline, as the JAX
            # package falls through to plain dispatch inside a trace
            return self._fun(*args)
        from . import memprof, profiler
        if threadsan.ARMED:
            threadsan.note_dispatch("compiled.%s" % self.site)
        t0 = time.perf_counter()
        key = self._key(args)
        try:
            memprof.on_dispatch(self.site)
            with self._lock:
                entry = self._cache.get(key)
                if entry is None:
                    entry = self._compile(key, args)
                else:
                    _count("cache_hits", self.site)
                self.last_flops = entry.flops
                out = entry.run(self, args)
        except Exception as exc:
            oom = memprof.maybe_oom_error(exc, site=self.site)
            if oom is not None:
                raise oom from exc
            raise
        if self._timed and profiler.aggregate_enabled():
            profiler.finish_timed(self.site, t0, out)
        return out

    def warmup(self, *args):
        """Compile the signature of ``args`` without running the program
        (no result, no change of any auxiliary state). Returns self."""
        key = self._key(args)
        with self._lock:
            if key not in self._cache:
                self._compile(key, args)
        return self

    def _compile(self, key, args):
        t0 = time.perf_counter()
        device = self._device(args)
        by_value = self._by_value(args, device)
        sig = _describe_args(args, self._static, self._inplace, self._names,
                             by_value)
        recording = autograd.is_recording()
        if by_value and not recording:
            opaque = sorted(k for k, d in sig.items() if d[0] == "opaque")
            if opaque:
                raise MXNetError(
                    "%s: a CUDA graph takes tensors and Python scalars only; "
                    "%s" % (self.site, ", ".join(
                        "%s is %s" % (k, _fmt_desc(sig[k])) for k in opaque)))
            entry = self._capture(args, device)
            if entry is None:
                entry = _Eager()
        else:
            entry = _Eager(probe=not recording)
        self._cache[key] = entry
        sig["tf32 (cudnn, matmul)"] = ("static", repr(_math_mode()))
        sig["autograd recording"] = ("static", repr(recording))
        with _lock:
            st = _sites.setdefault(self._lineage, {"compiles": 0, "sig": None})
            st["compiles"] += 1
            n, prev = st["compiles"], st["sig"]
            st["sig"] = sig
        reason = None
        if prev is not None:
            _count("retraces", self.site)
            reason = explain_signature_change(prev, sig)
            with _lock:
                _state["last_retrace"] = {"site": self.site, "reason": reason,
                                          "compiles": n, "time": time.time()}
            logger.warning("retrace [%s] (compile #%d): %s", self.site, n,
                           reason)
        _count("compiles", self.site)
        self._note_compile(time.perf_counter() - t0, n, reason, entry)
        return entry

    def _note_compile(self, dur, n, reason, entry):
        """The compile's accounting: its histogram, event and runprof
        state, and the flight recorder's last compile."""
        from . import runprof, xla_stats
        runprof.note_state("compile", dur, site=self.site)
        telemetry.histogram(
            "jit_compile_seconds",
            help="wall time of a signature's compile, by site: on the card "
                 "the CUDA graph capture and the warm-up runs before it",
            site=self.site).observe(dur)
        telemetry.event("xla.compile", site=self.site, seconds=dur,
                        compile_no=n, flops=entry.flops, retrace=reason)
        xla_stats.flight_recorder.last["compile"] = {
            "site": self.site, "seconds": dur, "compile_no": n,
            "flops": entry.flops, "time": time.time(), "retrace": reason}

    def _uncaptured(self, ops):
        _count("uncaptured")
        logger.warning("%s: not captured, runs eagerly on every call: its "
                       "function calls ops a graph cannot hold (%s)",
                       self.site, ", ".join(sorted(ops)))

    def _capture(self, args, device):
        """The captured graph of ``args``' signature, or None (counted as
        uncaptured) when the warm-up runs called a host op."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        static_args = [a if i in self._static or i in self._inplace
                       else _map(a, torch.clone) for i, a in enumerate(args)]
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        from . import xla_stats
        flops = None
        # Python's collector stays off during the capture: collecting a
        # dropped program there would free its graph's memory, which a
        # capture forbids (the capture then fails in the next library call)
        collecting = gc.isenabled()
        try:
            with inline(self.site), torch.cuda.device(device):
                with torch.cuda.stream(self._stream), \
                        suppress_aux_writeback(True), _host_ops() as seen:
                    for i in range(WARMUP_RUNS):
                        if i == 0 and xla_stats.enabled():
                            with xla_stats.count_flops() as fc:
                                self._fun(*static_args)
                            flops = fc.total or None
                        else:
                            self._fun(*static_args)
                if seen:
                    self._uncaptured(seen)
                    return None
                before = torch.cuda.memory_allocated(device)
                gc.disable()
                with suppress_aux_writeback(False), \
                        launch_count.recording() as launches, \
                        torch.cuda.graph(graph, pool=self._pool,
                                         stream=self._stream,
                                         capture_error_mode="thread_local"):
                    outputs = self._fun(*static_args)
        except Exception as exc:
            raise MXNetError("%s: CUDA graph capture failed: %s: %s"
                             % (self.site, type(exc).__name__, exc)) from exc
        finally:
            if collecting:
                gc.enable()
            current.wait_stream(self._stream)
        if xla_stats.enabled():
            xla_stats.ledger_set(self.site, "xla_temp",
                                 torch.cuda.memory_allocated(device) - before)
            xla_stats.ledger_set(self.site, "xla_output",
                                 xla_stats.tree_bytes(outputs))
        return _Graph(graph, self._copied(static_args), outputs, launches,
                      flops)
