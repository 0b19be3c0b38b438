"""Device and compile observability: compile accounting, the memory
ledger, FLOP counts and MFU, the crash flight recorder.

Counterpart of `mxnet_tpu/xla_stats.py`, with its metric names and
keys; the module keeps its name so that a reader finds the counterpart.
The port has no XLA: what this module reads is what the port runs.

1. **Compile accounting**: every `compiled.CompiledProgram` (a
   hybridized block) counts its signatures into
   ``jit_compiles_total{site=}`` / ``jit_cache_hits_total{site=}`` /
   ``jit_retraces_total{site=}`` (and the unlabeled totals), and the
   wall time of a compile into ``jit_compile_seconds{site=}``: on the
   card a compile is a CUDA graph capture, and its time includes the
   warm-up runs before the capture. The retrace explanation is logged
   and kept in :func:`last_retrace`. :func:`compile_counts` is
   `compiled.compile_counts`.
2. **Memory ledger**: :func:`ledger_set` byte accounting per (scope,
   section): ``Module.bind`` books params/grads/aux, the first update the
   optimizer states, each CUDA graph capture the bytes its pool grew by
   (``xla_temp``) and its static outputs (``xla_output``, the JAX
   package's section names). Exposed as ``memory_ledger_bytes{scope=,section=}``
   gauges and the :func:`memory_report` table. Byte counts are read
   from the tensors; :func:`device_memory` reads the CUDA caching
   allocator (``torch.cuda.memory_stats``) into the
   ``hbm_bytes_in_use`` / ``hbm_peak_bytes_in_use`` gauges (the names
   are the JAX package's; on the card they are device memory).
3. **FLOPs and MFU**: :func:`count_flops` counts the model FLOPs of a
   region once: ``torch.utils.flop_counter.FlopCounterMode`` counts the
   matrix products and convolutions that torch runs, and each hand
   kernel's wrapper adds its own analytic count at its launch
   (`ops/launch_count.py`), since a ``ctypes`` launch is invisible to
   the counter. A program counts its first call of each signature into
   ``last_flops``; ``Module`` counts its first train step of each
   signature. :func:`note_train_step` keeps the per-batch figure;
   :func:`goodput` turns a window into ``model_flops_per_second`` and
   ``mfu`` (``mfu = model_flops/s / peak_flops_total``, the peak from
   :data:`PEAK_FLOPS_BY_KIND` by device name and compute dtype, or
   ``MXNET_PEAK_FLOPS``).
4. **Flight recorder**: a bounded ring of recent telemetry events (fed
   by a `telemetry` tap) plus last-compile/last-step metadata, dumped as
   ``MXNET_TELEMETRY_DIR/flightrecorder-host<h>.json`` by ``Module.fit``
   on an exception, by the health sentinels and by OOM forensics. Each
   dump is also kept as ``flightrecorder-host<h>-<reason>.json``, so a
   later dump of another reason (a leak-sentinel trip after a serving
   worker's death) does not overwrite the earlier post-mortem.

``MXNET_XLA_STATS=0`` turns the compile-time FLOP counting and the
ledger bookings off (the compile counters of `compiled.py` stay).

Lock order: a ``CompiledProgram``'s ``_lock`` may be held when this
module's ``_lock`` is taken, never the reverse. Telemetry's registry
lock is innermost of all.

Import cost: stdlib + telemetry only; torch is imported inside the
functions that read the device.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque

from . import telemetry, threadsan

__all__ = ["compile_counts", "last_retrace", "explain_signature_change",
           "enabled", "ledger_set", "ledger", "tree_bytes",
           "tree_shard_bytes", "device_memory", "live_buffers",
           "memory_report", "count_flops", "PEAK_FLOPS_BY_KIND",
           "peak_flops_per_device", "peak_flops_total", "note_train_step",
           "flops_per_batch", "goodput", "publish_goodput", "mfu_of",
           "FlightRecorder", "flight_recorder", "dump_flight_recorder",
           "reset"]

logger = logging.getLogger("mxnet_tpu_torch.xla_stats")

_lock = threadsan.register("xla_stats._lock", threading.RLock())
_ledger = {}   # (scope, section) -> bytes
_step = {"flops_per_batch": 0.0, "site": None, "batches": 0,
         "updated": 0.0, "dtype": None}


def enabled():
    """False under ``MXNET_XLA_STATS=0``: no FLOP counting at compile
    time and no ledger bookings."""
    return os.environ.get("MXNET_XLA_STATS", "1") != "0"


def reset():
    """Drop the compile state of `compiled.py`, the ledger, the goodput
    state and the flight-recorder ring (tests). Registry metrics are not
    touched: pair with ``telemetry.reset()``."""
    from . import compiled
    compiled.reset()
    with _lock:
        _ledger.clear()
        _step.update(flops_per_batch=0.0, site=None, batches=0,
                     updated=0.0, dtype=None)
    flight_recorder.clear()


# ---------------------------------------------------------------------------
# Compile accounting: the machinery is `compiled.py`; these are the names
# the JAX package's callers read here.
# ---------------------------------------------------------------------------

def compile_counts():
    """``{"compiles", "cache_hits", "retraces", "uncaptured"}`` since the
    last reset (`compiled.compile_counts`)."""
    from . import compiled
    return compiled.compile_counts()


def last_retrace():
    """Metadata of the most recent retrace: ``{"site", "reason",
    "compiles", "time"}`` or None."""
    from . import compiled
    return compiled.last_retrace()


def explain_signature_change(old, new):
    """Alias of :func:`compiled.explain_signature_change`."""
    from . import compiled
    return compiled.explain_signature_change(old, new)


# ---------------------------------------------------------------------------
# Memory ledger
# ---------------------------------------------------------------------------

def ledger_set(scope, section, nbytes):
    """Record that ``scope`` (a module or site name) holds ``nbytes`` in
    ``section`` (params/grads/aux/optimizer/xla_temp/...). Gauged as
    ``memory_ledger_bytes{scope=,section=}``."""
    nbytes = int(nbytes)
    with _lock:
        _ledger[(str(scope), str(section))] = nbytes
    telemetry.gauge("memory_ledger_bytes",
                    help="framework-accounted bytes by owner and section",
                    scope=scope, section=section).set(nbytes)


def ledger():
    """Copy of the ledger: ``{(scope, section): bytes}``."""
    with _lock:
        return dict(_ledger)


def _tensor_leaves(tree, out):
    """The tensors of ``tree`` (lists, tuples, dicts, NDArrays, a sparse
    array's payload dict)."""
    if tree is None:
        return out
    if isinstance(tree, dict):
        for v in tree.values():
            _tensor_leaves(v, out)
        return out
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _tensor_leaves(v, out)
        return out
    if hasattr(tree, "_compact"):           # a sparse array: its payload,
        aux = tree._aux                     # never a dense copy made here
        return _tensor_leaves(tree._dense if aux is None else aux, out)
    data = getattr(tree, "_data", tree)     # NDArray -> tensor
    if data is not tree:
        return _tensor_leaves(data, out)
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        out.append(tree)
    return out


def tree_bytes(tree):
    """Total payload bytes of the tensors of ``tree`` (NDArrays are
    unwrapped; other leaves count 0)."""
    return sum(int(t.numel()) * int(t.element_size())
               for t in _tensor_leaves(tree, []))


def tree_shard_bytes(tree):
    """Bytes one device holds of ``tree``: the port keeps every tensor on
    one device, so this is :func:`tree_bytes`."""
    return tree_bytes(tree)


def _cuda():
    """The torch module when CUDA is initialized in this process, else
    None: reading the allocator must never initialize a device."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or \
            not torch.cuda.is_initialized():
        return None
    return torch


def cuda_device_stats(limit=64):
    """Per-CUDA-device allocator records without publishing gauges:
    ``{"device", "kind", "bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"}`` from ``torch.cuda.memory_stats`` (allocated bytes,
    current and peak, which ``torch.cuda.max_memory_allocated`` reads
    too) and the card's total memory. Empty when CUDA is not initialized.
    Telemetry-free: memprof's scrape-time samplers call it."""
    torch = _cuda()
    if torch is None:
        return []
    out = []
    for i in range(min(limit, torch.cuda.device_count())):
        st = torch.cuda.memory_stats(i)
        out.append({
            "device": "cuda:%d" % i,
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory)})
    return out


def device_memory(limit=64):
    """Per-device allocator records (see :func:`cuda_device_stats`),
    gauged as ``hbm_bytes_in_use{device=}`` /
    ``hbm_peak_bytes_in_use{device=}``. Without CUDA, one ``cpu`` record
    of zeros (there is no allocator to read), so the series stay
    continuous on CPU runs."""
    out = cuda_device_stats(limit)
    if not out:
        out = [{"device": "cpu", "kind": "cpu", "bytes_in_use": 0,
                "peak_bytes_in_use": 0, "bytes_limit": 0}]
    for rec in out:
        telemetry.gauge("hbm_bytes_in_use",
                        help="device allocator bytes in use (0 without "
                             "CUDA)",
                        device=rec["device"]).set(rec["bytes_in_use"])
        telemetry.gauge("hbm_peak_bytes_in_use",
                        help="device allocator peak bytes in use",
                        device=rec["device"]).set(rec["peak_bytes_in_use"])
    return out


def live_buffers():
    """(count, bytes) of the live tensors of the process (a census of
    their storages); gauged as ``live_buffer_count`` /
    ``live_buffer_bytes``."""
    from . import memprof
    _, b, n = memprof.live_census()
    telemetry.gauge("live_buffer_count",
                    help="live tensor storages in the process").set(n)
    telemetry.gauge("live_buffer_bytes",
                    help="payload bytes of live tensor storages").set(b)
    return n, b


def memory_report():
    """Rendered table: ledger sections, live tensors, per-device
    allocator stats (`profiler.dumps` embeds the device lines)."""
    rows = sorted(ledger().items())
    out = ["Memory ledger (framework-accounted bytes)."]
    hdr = "%-28s %-12s %16s" % ("Scope", "Section", "Bytes")
    out += [hdr, "-" * len(hdr)]
    for (scope, section), nbytes in rows:
        out.append("%-28s %-12s %16d" % (scope[:28], section[:12], nbytes))
    if not rows:
        out.append("(empty)")
    n, b = live_buffers()
    out += ["", "Live tensor storages: %d, %d bytes" % (n, b)]
    devs = device_memory()
    if devs:
        out.append("")
        for rec in devs:
            out.append("Device %s: bytes_in_use=%d peak_bytes_in_use=%d"
                       % (rec["device"], rec["bytes_in_use"],
                          rec["peak_bytes_in_use"]))
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# FLOP counts
# ---------------------------------------------------------------------------

class count_flops:
    """Context manager counting the model FLOPs of the region:
    ``torch.utils.flop_counter.FlopCounterMode`` over the torch ops, plus
    the analytic counts of the hand kernels launched on this thread.
    ``total`` holds the sum after the block; ``torch_flops`` and
    ``kernel_flops`` its two parts."""

    def __init__(self):
        self.total = self.torch_flops = self.kernel_flops = 0
        self._mode = self._acc = self._kernels = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        from .ops import launch_count
        self._kernels = launch_count.counting_flops()
        self._acc = self._kernels.__enter__()
        self._mode = FlopCounterMode(display=False)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            self._kernels.__exit__(*exc)
        self.torch_flops = int(self._mode.get_total_flops())
        self.kernel_flops = int(self._acc[0])
        self.total = self.torch_flops + self.kernel_flops
        return None


# ---------------------------------------------------------------------------
# Goodput / MFU
# ---------------------------------------------------------------------------

#: Dense peak FLOP/s of one card by device-name substring (matched
#: case-insensitively, longest name first) and compute dtype: the
#: published tensor-core rates for bf16/fp16 and TF32, and the CUDA-core
#: rate for f32 with TF32 off. They assume the card's full power limit.
#: Override with MXNET_PEAK_FLOPS (per device).
PEAK_FLOPS_BY_KIND = {
    "h100 pcie": {"bfloat16": 756e12, "float16": 756e12, "tf32": 378e12,
                  "float32": 51e12},
    "h100": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
             "float32": 67e12},
}


def _dtype_key(dtype):
    """The table's column for a compute dtype: ``bfloat16``/``float16``
    as named, ``tf32`` for f32 while cuDNN or cuBLAS may use TF32,
    ``float32`` otherwise."""
    name = str(dtype or "float32").replace("torch.", "")
    if name in ("bfloat16", "float16"):
        return name
    torch = sys.modules.get("torch")
    if torch is not None and (torch.backends.cudnn.allow_tf32 or
                              torch.backends.cuda.matmul.allow_tf32):
        return "tf32"
    return "float32"


def peak_flops_per_device(dtype=None):
    """Peak FLOP/s of one card for ``dtype`` (default: the dtype of the
    last noted train step, else f32): ``MXNET_PEAK_FLOPS`` if set, else
    :data:`PEAK_FLOPS_BY_KIND`; 0.0 when the device is unknown (the CPU),
    so MFU reads 0 rather than inventing a roofline."""
    env = os.environ.get("MXNET_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            logger.warning("bad MXNET_PEAK_FLOPS=%r ignored", env)
    torch = _cuda()
    if torch is None:
        return 0.0
    kind = torch.cuda.get_device_name(torch.cuda.current_device()).lower()
    if dtype is None:
        with _lock:
            dtype = _step["dtype"]
    for name in sorted(PEAK_FLOPS_BY_KIND, key=len, reverse=True):
        if name in kind:
            return PEAK_FLOPS_BY_KIND[name][_dtype_key(dtype)]
    return 0.0


def peak_flops_total(dtype=None):
    """The peak over every card of the run: one card a process, times the
    ``torch.distributed`` world size when a process group is up."""
    per = peak_flops_per_device(dtype)
    if not per:
        return 0.0
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return per * dist.get_world_size()
    return per


def note_train_step(source, batches=1, dtype=None):
    """Record the FLOPs of the live train step. ``source`` is a
    `compiled.CompiledProgram` (its ``last_flops`` covers the call) or a
    FLOP count; ``batches`` is how many optimizer steps it carries;
    ``dtype`` the step's compute dtype (it picks the peak). Feeds
    ``model_flops_total`` and the per-batch figure :func:`goodput`
    rates."""
    flops = source if isinstance(source, (int, float)) \
        else getattr(source, "last_flops", None)
    if not flops or flops <= 0:
        return
    site = getattr(source, "site", None)
    batches = max(1, int(batches))
    with _lock:
        _step.update(flops_per_batch=float(flops) / batches, site=site,
                     batches=batches, updated=time.monotonic(),
                     dtype=None if dtype is None
                     else str(dtype).replace("torch.", ""))
    telemetry.counter("model_flops_total",
                      help="model FLOPs executed by counted train "
                           "steps").inc(float(flops))
    flight_recorder.last["step"] = {
        "site": site, "flops_per_batch": float(flops) / batches,
        "batches": batches, "time": time.time(),
        "fit_batches_total": telemetry.counter("fit_batches_total").value}


def flops_per_batch():
    """Model FLOPs of one train batch per the last noted step (0.0 until
    a counted train step ran)."""
    with _lock:
        return _step["flops_per_batch"]


def mfu_of(model_flops_per_second):
    """Model-FLOPs utilization of a FLOP/s rate: rate / total peak (0.0
    when the device has no known peak)."""
    peak = peak_flops_total()
    return model_flops_per_second / peak if peak else 0.0


def publish_goodput(model_flops_per_second):
    """Set the ``model_flops_per_second`` / ``mfu`` gauges for a measured
    FLOP/s rate (Speedometer and :func:`goodput` land here). Returns the
    result dict."""
    mfu = mfu_of(model_flops_per_second)
    telemetry.gauge("model_flops_per_second",
                    help="model FLOPs per wall second over the last "
                         "measured window").set(model_flops_per_second)
    telemetry.gauge("mfu",
                    help="model FLOPs utilization vs the device peak "
                         "(0 when the peak is unknown)").set(mfu)
    return {"model_flops_per_second": model_flops_per_second, "mfu": mfu}


def goodput(batches, elapsed):
    """Rates for a window of ``batches`` train batches over ``elapsed``
    seconds: ``{"model_flops_per_second", "mfu"}`` (also sets the two
    gauges), or None when no FLOP figure is known yet or the window is
    empty."""
    fpb = flops_per_batch()
    if not fpb or elapsed <= 0 or batches <= 0:
        return None
    return publish_goodput(fpb * batches / elapsed)


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of recent telemetry events + last compile/step
    metadata, dumpable as one JSON file from crash paths.

    Fed by a `telemetry` tap, so it records even when no telemetry dir
    is configured. Size: ``MXNET_FLIGHT_RECORDER_EVENTS`` (default
    256)."""

    def __init__(self, maxlen=None):
        if maxlen is None:
            maxlen = telemetry.env_int("MXNET_FLIGHT_RECORDER_EVENTS", 256)
        self._ring = deque(maxlen=max(8, maxlen))
        self._lock = threadsan.register(
            "xla_stats.FlightRecorder._lock", threading.Lock())
        self.last = {"compile": None, "step": None}
        self.dumps_written = 0

    def record(self, rec):
        with self._lock:
            self._ring.append(rec)

    def events(self):
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()
        self.last = {"compile": None, "step": None}

    def dump(self, reason="", path=None, error=None):
        """Write the post-mortem JSON; returns the path, or None when no
        destination exists (no telemetry dir and no explicit path) or the
        write failed: a crash path must never crash harder. Without
        ``path`` it goes to the telemetry dir, as the newest post-mortem
        and under a name of its reason's own."""
        try:
            paths = [path]
            if path is None:
                d = telemetry.configured_dir() or \
                    os.environ.get("MXNET_TELEMETRY_DIR")
                if not d:
                    return None
                path = os.path.join(
                    d, "flightrecorder-host%d.json" % telemetry.host_id())
                paths = [path]
                if reason:
                    paths.append(reason_dump_path(d, reason))
            doc = {
                "host": telemetry.host_id(),
                "pid": os.getpid(),
                "reason": reason,
                "error": error,
                "dumped_at": time.time(),
                "dumped_mono": time.monotonic(),
                "last_compile": self.last["compile"],
                "last_step": self.last["step"],
                "events": self.events(),
                "metrics": telemetry.snapshot(),
            }
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            text = json.dumps(doc, default=str)
            for p in paths:
                tmp = "%s.tmp%d" % (p, os.getpid())
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.write(text)
                os.replace(tmp, p)
            self.dumps_written += 1
            telemetry.counter("flightrecorder_dumps_total",
                              help="flight-recorder post-mortem dumps "
                                   "written").inc()
            return path
        except Exception as exc:   # pragma: no cover - bad disk
            telemetry.swallowed("xla_stats.flight_recorder", exc)
            return None


def reason_dump_path(directory, reason):
    """``<directory>/flightrecorder-host<h>-<reason>.json``: the newest
    post-mortem of one reason (characters outside ``[A-Za-z0-9_.-]``
    become ``_``)."""
    safe = "".join(c if c.isalnum() or c in "_.-" else "_" for c in reason)
    return os.path.join(directory, "flightrecorder-host%d-%s.json"
                        % (telemetry.host_id(), safe))


flight_recorder = FlightRecorder()
telemetry.add_tap(flight_recorder.record)


def dump_flight_recorder(reason, error=None):
    """Convenience for exit paths: dump, raising nothing."""
    return flight_recorder.dump(reason=reason, error=error)


# The compile-accounting series are registered at import, so every process
# exposes them (as zeros) in Prometheus snapshots.
for _name, _help in (
        ("jit_compiles_total",
         "signature compiles of CompiledProgram (on the card a CUDA graph "
         "capture)"),
        ("jit_cache_hits_total",
         "CompiledProgram calls served by a cached signature"),
        ("jit_retraces_total", "compiles beyond the first of a program")):
    telemetry.counter(_name, help=_help)
del _name, _help
