"""Memory anatomy: the device-memory timeline, the leak sentinel, OOM
forensics and admission control.

Counterpart of `mxnet_tpu/memprof.py`, with its metric names, verdict
labels and report keys, over the CUDA caching allocator:

- **Timeline**: per-device allocated and peak bytes
  (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
  ``.peak``, the figure ``torch.cuda.max_memory_allocated`` reads),
  sampled (throttled by ``MXNET_MEMPROF_SAMPLE_EVERY`` hook polls) at
  each ``CompiledProgram`` dispatch, each ``Module`` train step and each
  stepprof step record, never while a stream is capturing a CUDA graph;
  attributed by scope against the `xla_stats` memory ledger (params,
  grads, aux and optimizer states booked at bind and first update; the
  residual is activations and workspace); kept in a bounded ring;
  published as ``memory_bytes{device=,scope=}`` series and ``mem.sample``
  spans. Without CUDA the samples read zero bytes (there is no
  allocator to read), as the JAX package's do on a backend without
  memory statistics.
- **Leak sentinel**: monotonic growth of allocated bytes across a
  ``MXNET_MEMPROF_WINDOW``-sample window with no matching ledger growth
  books ``run_anomalies_total{kind="memory_leak"}`` through
  :func:`runprof.note_anomaly`, naming the largest live tensor shapes of
  a census of the process's tensors taken at the trip.
- **OOM forensics**: :func:`maybe_oom_error` recognizes
  ``torch.cuda.OutOfMemoryError`` (its "Tried to allocate ..." message)
  at the dispatch choke points, writes an ``oomdump_host<h>_pid<p>.json``
  postmortem (requested bytes parsed from the message, per-device
  in_use/peak/limit, the ledger's attribution, the largest live tensors,
  the timeline's tail) and returns a :class:`DeviceOOMError` carrying a
  one-line verdict and hint to raise in the original's place. The
  ``memory.oom`` chaos site drives the same path on the CPU.
- **Headroom and admission**: ``memory_headroom_bytes{device=}``
  scrape-time gauges and :func:`admit` (``limit x MXNET_MEM_FRACTION``
  against allocated bytes; ``MemoryAdmissionError`` and
  ``admission_rejections_total``). The serving engine calls :func:`admit`
  before any replica binds, samples the timeline after each batch
  (``serving.batch``) and carries :func:`health` in ``/healthz``.
- **Reports**: per-host ``memprof_host<h>_pid<p>.json`` snapshots on
  :func:`telemetry.write_host_json`, merged by
  ``python -m mxnet_tpu_torch.memprof report [path|dir]``.

The census of live tensors walks the garbage collector's objects, so it
is taken only at a leak trip, an OOM and :func:`xla_stats.memory_report`,
never at a sample. The layer is host-side bookkeeping and adds no
capture. Kill switch: ``MXNET_MEMPROF=0``.

Lock order: this module has one lock, ``MemTracker._lock``, a leaf: no
telemetry call happens under it.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import sys
import threading
import time
from collections import deque

from . import telemetry
from . import threadsan
from . import xla_stats

_env_int = telemetry.env_int
_env_float = telemetry.env_float

#: ledger sections that describe buffers which stay resident between
#: dispatches — the attribution waterfall charges live bytes to these
#: first and calls whatever remains "residual" (activations/workspace)
RESIDENT_SECTIONS = ("params", "grads", "aux", "optimizer")
#: per-capture ledger sections (the JAX package's names): a CUDA graph
#: capture's pool growth (``xla_temp``) and static outputs
#: (``xla_output``); transient, reported alongside, never subtracted
#: from live bytes
TRANSIENT_SECTIONS = ("xla_temp", "xla_output")
ATTRIBUTION_SCOPES = RESIDENT_SECTIONS + ("residual",) + TRANSIENT_SECTIONS

VERDICTS = ("healthy", "activation-heavy", "opt-heavy", "leaking",
            "fragmented", "unknown")

#: hints per verdict (the report/postmortem voice)
HINTS = {
    "healthy": "peak fits the budget — keep a peak_hbm_bytes ceiling "
               "and watch memory_headroom_bytes",
    "activation-heavy":
        "activation/workspace residual dominates live bytes: shrink "
        "the batch bucket, recompute activations, or train in bf16",
    "opt-heavy":
        "optimizer state dominates live bytes: pick an optimizer with "
        "less state or shard it across cards",
    "leaking":
        "live bytes grow with no matching ledger growth: read the "
        "top-growing shapes in the anomaly detail / flight-recorder "
        "dump; usual suspects are host-side caches of device tensors "
        "and executors never closed",
    "fragmented":
        "allocator in_use far exceeds live tensor bytes: fragmentation "
        "or an external allocator hog — bucket input shapes (serving "
        "already does) so allocation sizes stabilize",
    "unknown":
        "no memory samples recorded: run with MXNET_MEMPROF=1 "
        "(default) through Module or CompiledProgram dispatch, or call "
        "memprof.sample(force=True)",
}

#: per-scope hints for the OOM verdict line
OOM_HINTS = {
    "params": "shard parameters across cards or load fewer serving "
              "replicas",
    "grads": "drop gradient buffers nothing reads (grad_req='null' for "
             "frozen parameters)",
    "aux": "audit aux state (batch-norm moments etc.) for stale "
           "copies",
    "optimizer": "pick an optimizer with less state or shard it across "
                 "cards",
    "residual": "activation working set: pick a smaller batch bucket, "
                "recompute activations, or train in bf16",
}


class DeviceOOMError(RuntimeError):
    """A CUDA out-of-memory error re-raised with the memprof verdict line.

    Carries ``verdict``, ``hint``, ``requested_bytes``, ``dump_path``
    and ``site`` so callers (and tests) can read the forensics without
    parsing the message."""

    def __init__(self, message, verdict=None, hint=None,
                 requested_bytes=None, dump_path=None, site=None):
        super().__init__(message)
        self.verdict = verdict
        self.hint = hint
        self.requested_bytes = requested_bytes
        self.dump_path = dump_path
        self.site = site


class MemoryAdmissionError(RuntimeError):
    """Raised by :func:`admit` when a projected allocation exceeds the
    device budget (``limit × MXNET_MEM_FRACTION``)."""

    def __init__(self, message, decision=None):
        super().__init__(message)
        self.decision = decision or {}


def enabled():
    """Master kill switch: ``MXNET_MEMPROF=0`` disables the layer."""
    return os.environ.get("MXNET_MEMPROF", "1") != "0"


def sample_every():
    """Take one timeline sample per this many hook polls (default 8;
    0 disables sampling while leaving OOM/admission paths live)."""
    return _env_int("MXNET_MEMPROF_SAMPLE_EVERY", 8)


def window():
    """Leak-sentinel window length in SAMPLES (default 16)."""
    return max(2, _env_int("MXNET_MEMPROF_WINDOW", 16))


def mem_fraction():
    """Admission budget as a fraction of the device limit."""
    return _env_float("MXNET_MEM_FRACTION", 0.9)


def mem_limit_override():
    """Per-device byte limit override for backends whose allocator
    reports no ``bytes_limit`` (CPU) — 0 means 'use the allocator'."""
    return _env_int("MXNET_MEM_LIMIT_BYTES", 0)


# ---------------------------------------------------------------------------
# raw device/live-tensor reads (telemetry-free: safe at scrape time)

def _raw_device_stats(limit=64):
    """Per-CUDA-device allocator records WITHOUT publishing gauges
    (`xla_stats.cuda_device_stats`); empty when CUDA is not initialized.
    Telemetry-free by construction: this runs inside the metric
    registry's read path via the headroom samplers."""
    return xla_stats.cuda_device_stats(limit)


def live_census(top=64, device_type=None):
    """One pass over the process's live tensors: ``(census,
    total_bytes, count)`` where census maps ``"<dtype>[shape]"`` to bytes
    (top-N entries); each storage counts once, views and all. With
    ``device_type`` ("cuda", "cpu") only tensors on such devices count.
    It walks the garbage collector's objects, so callers take it only at
    a leak trip, an OOM or a report."""
    import gc
    torch = sys.modules.get("torch")
    if torch is None:
        return {}, 0, 0
    census = {}
    seen = set()
    total = n = 0
    tensor = torch.Tensor
    for obj in gc.get_objects():
        if not issubclass(type(obj), tensor):
            continue
        try:
            dev = obj.device
            if device_type is not None and dev.type != device_type:
                continue
            st = obj.untyped_storage()
            key = (str(dev), st.data_ptr())
            if key in seen or st.data_ptr() == 0:
                continue
            seen.add(key)
            nb = int(st.nbytes())
            label = "%s%s" % (str(obj.dtype).replace("torch.", ""),
                              list(obj.shape))
        except Exception:
            continue    # a tensor without storage (meta, sparse)
        n += 1
        total += nb
        census[label] = census.get(label, 0) + nb
    if len(census) > top:
        census = dict(sorted(census.items(),
                             key=lambda kv: -kv[1])[:top])
    return census, total, n


def _allocated(stats):
    return sum(int(r["bytes_in_use"]) for r in stats)


def _headroom_of(devname):
    """Scrape-time headroom for one device:
    ``limit × MXNET_MEM_FRACTION − in_use`` (0 when the limit is
    unknown). Telemetry-free: runs inside the registry's read path."""
    for rec in _raw_device_stats():
        if rec["device"] == devname:
            lim = rec["bytes_limit"] or mem_limit_override()
            if lim <= 0:
                return 0.0
            return float(lim) * mem_fraction() - rec["bytes_in_use"]
    return 0.0


def attribution(live_bytes=None):
    """Scope attribution of live device bytes against the xla_stats
    memory ledger. The resident sections (params/grads/aux/optimizer,
    booked at bind/first-update) plus ``residual`` sum EXACTLY to live
    bytes — residual is what no ledger entry claims: activations and
    workspace. The transient sections (xla_temp/xla_output, booked per
    compile) ride along informationally."""
    if live_bytes is None:
        live_bytes = _allocated(_raw_device_stats())
    led = xla_stats.ledger()
    by_sec = {}
    for (_scope, section), nbytes in led.items():
        by_sec[section] = by_sec.get(section, 0) + int(nbytes)
    out = {}
    remaining = max(0, int(live_bytes))
    for sec in RESIDENT_SECTIONS:
        take = min(by_sec.get(sec, 0), remaining)
        out[sec] = take
        remaining -= take
    out["residual"] = remaining
    for sec in TRANSIENT_SECTIONS:
        out[sec] = by_sec.get(sec, 0)
    return out


# ---------------------------------------------------------------------------
# the tracker

class MemTracker:
    """Bounded HBM timeline + leak sentinel + peak bookkeeping.

    One leaf lock; samples are assembled outside it, booked under it,
    published to telemetry after release. Only the process-level
    :data:`tracker` publishes gauges/spans or exports snapshots —
    private instances (tests) just record."""

    #: a leak trip needs at least this much monotonic growth — below
    #: it, allocator noise and tiny scalars would false-positive
    LEAK_MIN_BYTES = 1 << 16
    #: timeline entries embedded in snapshots and OOM dumps
    TIMELINE_KEEP = 32
    RING_MAX = 256

    def __init__(self):
        self._lock = threadsan.register("memprof.MemTracker._lock",
                                        threading.Lock())
        self._ring = deque(maxlen=self.RING_MAX)
        self._polls = 0
        self._samples = 0
        self._peaks = {}          # device -> running peak in_use
        self._limits = {}         # device -> last seen bytes_limit
        self._live_peak = 0
        self._leak_trips = 0
        self._last_leak = None
        self._oom_dumps = 0
        self._export_thread = None

    # -- timeline -----------------------------------------------------

    def sample(self, site=None, force=False):
        """Throttled timeline sample; the single entry point every
        hook (dispatch / step record / serving batch) calls. Returns
        the sample record when one was taken, else None."""
        if not enabled() or _capturing():
            return None
        n = sample_every()
        with self._lock:
            self._polls += 1
            due = force or (n > 0 and (n == 1 or self._polls % n == 1))
        if not due:
            return None
        try:
            return self._sample_now(site)
        except Exception as exc:
            telemetry.swallowed("memprof.sample", exc)
            return None

    def _sample_now(self, site):
        t0 = time.perf_counter()
        stats = _raw_device_stats()
        live_total, live_count, census = _allocated(stats), 0, {}
        ledger_total = sum(xla_stats.ledger().values())
        now = time.time()
        rec = {"time": now, "site": site,
               "live_bytes": int(live_total),
               "live_count": int(live_count),
               "ledger_bytes": int(ledger_total),
               "devices": [{"device": r["device"],
                            "in_use": r["bytes_in_use"],
                            "peak": r["peak_bytes_in_use"],
                            "limit": r["bytes_limit"]} for r in stats],
               "census": census}
        trip = None
        with self._lock:
            for r in stats:
                dev = r["device"]
                peak = max(self._peaks.get(dev, 0),
                           r["peak_bytes_in_use"], r["bytes_in_use"])
                self._peaks[dev] = peak
                self._limits[dev] = r["bytes_limit"]
            self._live_peak = max(self._live_peak, rec["live_bytes"])
            self._ring.append(rec)
            self._samples += 1
            trip = self._check_leak_locked()
        self._publish(rec, stats)
        dur = time.perf_counter() - t0
        if self is tracker:
            telemetry.record_span("mem.sample", now, dur, site=site,
                                  live_bytes=rec["live_bytes"],
                                  devices=len(stats))
        if trip is not None:
            self._note_leak(trip, rec)
        return rec

    def _check_leak_locked(self):
        """Sentinel check, called with the lock held: a full window of
        monotonically non-decreasing live bytes whose growth the
        ledger does not explain. Returns the trip tuple or None."""
        win = window()
        if len(self._ring) < win:
            return None
        seq = list(self._ring)[-win:]
        growth = seq[-1]["live_bytes"] - seq[0]["live_bytes"]
        if growth < self.LEAK_MIN_BYTES:
            return None
        if any(b["live_bytes"] < a["live_bytes"]
               for a, b in zip(seq, seq[1:])):
            return None
        ledger_growth = seq[-1]["ledger_bytes"] - seq[0]["ledger_bytes"]
        if ledger_growth >= growth // 2:
            return None   # the framework accounted for it — not a leak
        self._leak_trips += 1
        baseline = seq[0]
        self._ring.clear()   # fresh window: one trip per growth episode
        return (growth, ledger_growth, win, baseline)

    def _note_leak(self, trip, rec):
        growth, ledger_growth, win, baseline = trip
        census, _, _ = live_census(
            top=3, device_type="cuda" if rec["devices"] else None)
        top = ", ".join("%s (%d B)" % (label, nbytes)
                        for label, nbytes in census.items()) or "no census"
        detail = ("live bytes grew %d B over %d samples (ledger explains "
                  "%d B); largest live tensors: %s"
                  % (growth, win, max(0, ledger_growth), top))
        with self._lock:
            self._last_leak = {"time": rec["time"], "growth": int(growth),
                               "window": win, "detail": detail}
        if self is not tracker:
            return
        runprof = None
        try:
            from . import runprof
            runprof.note_anomaly("memory_leak", detail=detail,
                                 value=float(growth))
        except Exception as exc:
            if runprof is not None and \
                    isinstance(exc, runprof.RunHealthError):
                raise   # MXNET_RUNPROF_HALT=1 fails fast, by request
            telemetry.swallowed("memprof.leak", exc)

    def _publish(self, rec, stats):
        """Gauges for the last sample — process tracker only, lock NOT
        held."""
        if self is not tracker:
            return
        att = attribution(rec["live_bytes"])
        for scope, nbytes in att.items():
            telemetry.gauge(
                "memory_bytes",
                help="live device bytes attributed by scope against "
                     "the memory ledger (device=all), and per-device "
                     "allocator in_use (scope=in_use)",
                device="all", scope=scope).set(nbytes)
        for r in stats:
            dev = r["device"]
            telemetry.gauge("memory_bytes", device=dev,
                            scope="in_use").set(r["bytes_in_use"])
            g = telemetry.gauge(
                "memory_headroom_bytes",
                help="limit x MXNET_MEM_FRACTION minus bytes_in_use, "
                     "re-read at scrape time (0 when the device limit "
                     "is unknown; negative = over budget)",
                device=dev)
            # re-bound every sample: telemetry.reset() (tests) drops
            # the gauge object and with it the scrape function
            g.set_function(lambda d=dev: _headroom_of(d))
        self._maybe_export()

    # -- peaks / headroom / admission --------------------------------

    def peak_hbm_bytes(self):
        """Worst-device peak bytes: allocator peak unioned with the
        tracker's running sampled peak (which covers CPU, where the
        allocator reports zeros until the fallback kicks in)."""
        stats = _raw_device_stats()
        with self._lock:
            peaks = dict(self._peaks)
        worst = 0
        for r in stats:
            worst = max(worst, r["peak_bytes_in_use"], r["bytes_in_use"],
                        peaks.get(r["device"], 0))
        for v in peaks.values():
            worst = max(worst, v)
        return int(worst)

    def health(self):
        """The /healthz headroom triple."""
        stats = _raw_device_stats()
        frac = mem_fraction()
        override = mem_limit_override()
        with self._lock:
            peaks = dict(self._peaks)
        headrooms = []
        peak_fracs = []
        for r in stats:
            lim = r["bytes_limit"] or override
            if lim <= 0:
                continue
            headrooms.append(float(lim) * frac - r["bytes_in_use"])
            peak = max(r["peak_bytes_in_use"], r["bytes_in_use"],
                       peaks.get(r["device"], 0))
            peak_fracs.append(peak / float(lim))
        rej = telemetry.get_metric("admission_rejections_total")
        return {"headroom_bytes":
                    int(min(headrooms)) if headrooms else None,
                "peak_fraction":
                    round(max(peak_fracs), 4) if peak_fracs else 0.0,
                "admission_rejections_total":
                    int(rej.value) if rej is not None else 0}

    def admit(self, projected_bytes, what="allocation"):
        """Admission control: raise :class:`MemoryAdmissionError` when
        ``projected_bytes`` exceeds the tightest device's remaining
        budget (``limit × MXNET_MEM_FRACTION − in_use``); otherwise
        return the decision dict. Unknown limits admit — refusing on
        no information would brick CPU smoke runs."""
        projected = int(projected_bytes)
        decision = {"admitted": True, "projected_bytes": projected,
                    "what": what, "limit_bytes": 0, "budget_bytes": 0,
                    "in_use_bytes": 0}
        if not enabled():
            return decision
        try:
            stats = _raw_device_stats()
        except Exception as exc:
            telemetry.swallowed("memprof.admit", exc)
            return decision
        override = mem_limit_override()
        frac = mem_fraction()
        worst = None   # (remaining budget, rec, limit)
        for r in stats:
            lim = r["bytes_limit"] or override
            if lim <= 0:
                continue
            remaining = float(lim) * frac - r["bytes_in_use"]
            if worst is None or remaining < worst[0]:
                worst = (remaining, r, lim)
        if worst is None:
            return decision
        remaining, r, lim = worst
        decision.update(limit_bytes=int(lim),
                        budget_bytes=int(lim * frac),
                        in_use_bytes=int(r["bytes_in_use"]),
                        device=r["device"])
        if projected <= remaining:
            return decision
        decision["admitted"] = False
        telemetry.counter(
            "admission_rejections_total",
            help="allocations refused by memprof.admit because the "
                 "projected peak exceeded limit x MXNET_MEM_FRACTION"
        ).inc()
        telemetry.event("memory.admission_rejected", what=what,
                        projected_bytes=projected,
                        budget_bytes=decision["budget_bytes"],
                        in_use_bytes=decision["in_use_bytes"],
                        device=decision.get("device"))
        raise MemoryAdmissionError(
            "memory admission refused: %s projects %d bytes but device "
            "%s has %d of a %d-byte budget left (limit %d x "
            "MXNET_MEM_FRACTION=%.2f, %d in use) — shard the model "
            "(fsdp), donate buffers, or raise MXNET_MEM_FRACTION"
            % (what, projected, decision.get("device"),
               max(0, int(remaining)), decision["budget_bytes"], lim,
               frac, decision["in_use_bytes"]), decision=decision)

    # -- OOM forensics ------------------------------------------------

    def note_oom(self, exc, site=None):
        """Write the ``oomdump_host<h>_pid<p>.json`` postmortem and
        return ``(verdict, hint, requested_bytes, dump_path)``."""
        message = str(exc)
        requested = parse_requested_bytes(message)
        stats = _raw_device_stats()
        census, live_total, live_count = live_census(
            device_type="cuda" if stats else None)
        att = attribution(_allocated(stats) if stats else live_total)
        scope = _dominant_scope(att)
        hint = OOM_HINTS.get(scope, OOM_HINTS["residual"])
        verdict = "oom-%s-heavy" % ("activation" if scope == "residual"
                                    else scope)
        with self._lock:
            self._oom_dumps += 1
            tail = [dict(r, census=None) for r in
                    list(self._ring)[-self.TIMELINE_KEEP:]]
        led = xla_stats.ledger()
        waterfall = [{"scope": s, "section": sec, "bytes": int(b)}
                     for (s, sec), b in sorted(led.items(),
                                               key=lambda kv: -kv[1])]
        doc = {"time": time.time(), "host": telemetry.host_id(),
               "pid": os.getpid(), "site": site,
               "error": message[:4000],
               "requested_bytes": requested,
               "devices": stats,
               "live_bytes": int(live_total),
               "live_count": int(live_count),
               "attribution": att,
               "dominant_scope": scope,
               "ledger": waterfall,
               "top_buffers": _top_buffers(census),
               "timeline_tail": tail,
               "verdict": verdict, "hint": hint}
        dump_dir = telemetry.configured_dir() or \
            os.environ.get("MXNET_TELEMETRY_DIR")
        path = None
        try:
            path = telemetry.write_host_json("oomdump", doc, dir=dump_dir)
        except Exception as exc2:
            telemetry.swallowed("memprof.oomdump", exc2)
        telemetry.counter(
            "oom_events_total",
            help="device out-of-memory errors memprof wrote a "
                 "postmortem for").inc()
        telemetry.event("memory.oom", site=site, verdict=verdict,
                        requested_bytes=requested, dump=path)
        if self is tracker:
            try:
                xla_stats.dump_flight_recorder("memprof.oom",
                                               error=message[:500])
            except Exception as exc2:
                telemetry.swallowed("memprof.oom_flight", exc2)
        return verdict, hint, requested, path

    # -- snapshots / export -------------------------------------------

    def snapshot(self):
        with self._lock:
            ring = list(self._ring)
            doc = {"host": telemetry.host_id(), "pid": os.getpid(),
                   "updated": time.time(),
                   "samples": self._samples,
                   "window": window(),
                   "sample_every": sample_every(),
                   "peak_by_device": dict(self._peaks),
                   "limit_by_device": dict(self._limits),
                   "live_peak_bytes": int(self._live_peak),
                   "leak_trips": self._leak_trips,
                   "last_leak": self._last_leak,
                   "oom_dumps": self._oom_dumps}
        last = ring[-1] if ring else None
        doc["live_bytes"] = last["live_bytes"] if last else 0
        doc["attribution"] = attribution(doc["live_bytes"])
        doc["peak_hbm_bytes"] = max([0] +
                                    list(doc["peak_by_device"].values()))
        doc["timeline"] = [dict(r, census=None)
                           for r in ring[-self.TIMELINE_KEEP:]]
        rej = telemetry.get_metric("admission_rejections_total")
        doc["admission_rejections"] = \
            int(rej.value) if rej is not None else 0
        return doc

    def write_host_snapshot(self, dir=None, force=False):
        """``memprof_host<h>_pid<p>.json`` via the shared transport;
        skipped while nothing has been sampled unless ``force``."""
        with self._lock:
            empty = self._samples == 0 and self._oom_dumps == 0
        if empty and not force:
            return None
        return telemetry.write_host_json("memprof", self.snapshot(),
                                         dir=dir)

    def _maybe_export(self):
        if self is not tracker or telemetry.configured_dir() is None:
            return
        with self._lock:
            if self._export_thread is not None:
                return
            t = threading.Thread(target=self._export_loop, daemon=True,
                                 name="mxnet_tpu_torch-memprof-export")
            self._export_thread = t
        t.start()

    def _export_loop(self):
        while True:
            time.sleep(2.0)
            if telemetry.configured_dir() is None:
                continue
            try:
                self.write_host_snapshot()
            except Exception as exc:
                telemetry.swallowed("memprof.export", exc)

    def reset(self):
        """Clear recorded state (NOT the metric registry — pair with
        ``telemetry.reset()`` in tests)."""
        with self._lock:
            self._ring.clear()
            self._polls = 0
            self._samples = 0
            self._peaks.clear()
            self._limits.clear()
            self._live_peak = 0
            self._leak_trips = 0
            self._last_leak = None
            self._oom_dumps = 0


# ---------------------------------------------------------------------------
# OOM detection helpers

_OOM_TOKENS = ("CUDA out of memory", "RESOURCE_EXHAUSTED",
               "Out of memory", "out of memory")

_SIZE_RE = re.compile(
    r"allocat\w*\s+(?:of\s+)?([\d][\d,]*(?:\.\d+)?)\s*"
    r"([KMGTP]i?B?|bytes?|B)?", re.IGNORECASE)

_UNIT = {"": 1, "b": 1, "byte": 1, "bytes": 1,
         "k": 1 << 10, "kb": 1 << 10, "kib": 1 << 10,
         "m": 1 << 20, "mb": 1 << 20, "mib": 1 << 20,
         "g": 1 << 30, "gb": 1 << 30, "gib": 1 << 30,
         "t": 1 << 40, "tb": 1 << 40, "tib": 1 << 40,
         "p": 1 << 50, "pb": 1 << 50, "pib": 1 << 50}


def _capturing():
    """True while this thread's CUDA stream is capturing a graph: a
    sample there would read the allocator mid-capture."""
    torch = xla_stats._cuda()
    return torch is not None and torch.cuda.is_current_stream_capturing()


def _oom_of(exc):
    """``exc`` or the first error of its cause/context chain that reads
    like a device allocator failure (``torch.cuda.OutOfMemoryError``, or
    its message), else None."""
    torch = sys.modules.get("torch")
    oom_type = getattr(getattr(torch, "cuda", None), "OutOfMemoryError",
                       None)
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if (oom_type is not None and isinstance(exc, oom_type)) or \
                any(tok in str(exc) for tok in _OOM_TOKENS):
            return exc
        exc = exc.__cause__ or exc.__context__
    return None


def looks_like_oom(exc):
    """True when ``exc`` (or its cause) reads like a device allocator
    failure: ``torch.cuda.OutOfMemoryError`` or its "CUDA out of memory"
    text."""
    return _oom_of(exc) is not None


def parse_requested_bytes(message):
    """Requested byte count parsed from an allocator message ("CUDA out
    of memory. Tried to allocate 20.00 GiB", "…trying to allocate
    40000000000 bytes…"), or None."""
    m = _SIZE_RE.search(message or "")
    if not m:
        return None
    try:
        value = float(m.group(1).replace(",", ""))
    except ValueError:
        return None
    unit = (m.group(2) or "").lower()
    return int(value * _UNIT.get(unit, 1))


def _dominant_scope(att):
    """The resident scope (or residual) holding the most live bytes."""
    best = "residual"
    best_bytes = -1
    for scope in RESIDENT_SECTIONS + ("residual",):
        if att.get(scope, 0) > best_bytes:
            best, best_bytes = scope, att.get(scope, 0)
    return best


def _top_buffers(census, k=10):
    """Top-K live tensor shapes by bytes from a census: the OOM
    postmortem's "who is holding what" table."""
    rows = [{"tensor": label, "nbytes": int(nbytes)}
            for label, nbytes in census.items()]
    rows.sort(key=lambda r: -r["nbytes"])
    return rows[:k]


def maybe_oom_error(exc, site=None):
    """The choke-point OOM handler: None when ``exc`` is not a device
    allocator failure; otherwise write the postmortem and return a
    :class:`DeviceOOMError` (verdict line + hint appended to the
    original message) for the caller to ``raise ... from exc``."""
    if not enabled() or isinstance(exc, DeviceOOMError):
        return None
    oom = _oom_of(exc)
    if oom is None:
        return None
    exc = oom
    verdict, hint, requested, path = tracker.note_oom(exc, site=site)
    line = "memprof: %s — %s" % (verdict, hint)
    if path:
        line += " (postmortem: %s)" % path
    err = DeviceOOMError("%s\n%s" % (str(exc)[:2000], line),
                         verdict=verdict, hint=hint,
                         requested_bytes=requested, dump_path=path,
                         site=site)
    return err


def _maybe_chaos_oom(site):
    """The ``memory.oom`` chaos site: when armed, raise a synthetic CUDA
    out-of-memory error so the forensics path is testable on the CPU.
    The armed value, when an int, plays the requested byte count."""
    from . import chaos
    val = chaos.fire("memory.oom")
    if val is None:
        return
    try:
        nbytes = int(val)
    except (TypeError, ValueError):
        nbytes = 1 << 30
    raise RuntimeError(
        "CUDA out of memory. Tried to allocate %d bytes. (chaos: injected "
        "at %s)" % (nbytes, site))


def on_dispatch(site):
    """The dispatch hook of ``CompiledProgram.__call__`` and
    ``Module._step``: poll the ``memory.oom`` chaos site (the injected
    error propagates into the dispatch OOM handler), then take a
    throttled timeline sample. Host-side only: it adds no capture."""
    if not enabled():
        return
    _maybe_chaos_oom(site)
    tracker.sample(site)


# ---------------------------------------------------------------------------
# module-level facade over the process tracker

def sample(site=None, force=False):
    return tracker.sample(site, force=force)


def admit(projected_bytes, what="allocation"):
    return tracker.admit(projected_bytes, what=what)


def health():
    return tracker.health()


def peak_hbm_bytes():
    return tracker.peak_hbm_bytes()


def snapshot():
    return tracker.snapshot()


def write_host_snapshot(dir=None, force=False):
    return tracker.write_host_snapshot(dir=dir, force=force)


def reset():
    tracker.reset()


# ---------------------------------------------------------------------------
# merge / classify / report

def merge_host_snapshots(dir=None):
    """Freshest ``memprof_host*`` snapshot per host (shared
    telemetry transport)."""
    return telemetry.merge_host_json("memprof", dir=dir)


def aggregate(docs):
    """Cross-host roll-up: summed attribution, worst peak, per-host
    peaks with skew ((max-min)/max across hosts)."""
    docs = [d for d in docs if isinstance(d, dict)]
    if not docs:
        return None
    att = {}
    for d in docs:
        for scope, nbytes in (d.get("attribution") or {}).items():
            att[scope] = att.get(scope, 0) + int(nbytes)
    peaks = {}
    for d in docs:
        host = d.get("host", 0)
        peaks[host] = max(peaks.get(host, 0),
                          int(d.get("peak_hbm_bytes") or 0))
    vals = [v for v in peaks.values() if v > 0]
    skew = round((max(vals) - min(vals)) / max(vals), 4) \
        if len(vals) > 1 else 0.0
    worst_dev = {}
    for d in docs:
        for dev, peak in (d.get("peak_by_device") or {}).items():
            worst_dev[dev] = max(worst_dev.get(dev, 0), int(peak))
    in_use = 0
    for d in docs:
        tl = d.get("timeline") or []
        if tl:
            in_use += sum(x.get("in_use", 0)
                          for x in tl[-1].get("devices") or [])
    return {"hosts": len(docs),
            "attribution": att,
            "live_bytes": sum(int(d.get("live_bytes") or 0)
                              for d in docs),
            "in_use_bytes": in_use,
            "peak_hbm_bytes": max([0] + list(peaks.values())),
            "peak_by_host": peaks,
            "peak_skew": skew,
            "samples": sum(int(d.get("samples") or 0) for d in docs),
            "leak_trips": sum(int(d.get("leak_trips") or 0)
                              for d in docs),
            "oom_dumps": sum(int(d.get("oom_dumps") or 0)
                             for d in docs),
            "admission_rejections":
                sum(int(d.get("admission_rejections") or 0)
                    for d in docs)}


def classify(att, leak_trips=0, live_bytes=None, in_use=None):
    """(verdict, hint): healthy / activation-heavy / opt-heavy /
    leaking / fragmented / unknown, against the attribution dict."""
    att = att or {}
    if leak_trips:
        return "leaking", HINTS["leaking"]
    live = live_bytes if live_bytes is not None else \
        sum(att.get(s, 0) for s in RESIDENT_SECTIONS + ("residual",))
    if in_use and live and in_use > 1.25 * live and \
            (in_use - live) > MemTracker.LEAK_MIN_BYTES:
        return "fragmented", HINTS["fragmented"]
    total = sum(att.get(s, 0) for s in RESIDENT_SECTIONS + ("residual",))
    if total <= 0:
        return "unknown", HINTS["unknown"]
    if att.get("residual", 0) / total >= 0.5:
        return "activation-heavy", HINTS["activation-heavy"]
    if att.get("optimizer", 0) / total >= 0.4:
        return "opt-heavy", HINTS["opt-heavy"]
    return "healthy", HINTS["healthy"]


def _load_source(path):
    """Resolve the report's data source exactly like the other anatomy
    CLIs: explicit dir → merge; explicit file → that snapshot;
    None → configured-dir merge, else the live process tracker."""
    if path is None:
        merged = merge_host_snapshots()
        if merged:
            return {"agg": aggregate(list(merged.values())),
                    "source": "merged:%d hosts" % len(merged)}
        snap = snapshot()
        if snap.get("samples"):
            return {"agg": aggregate([snap]), "source": "process"}
        return {"agg": None, "source": "none"}
    if os.path.isdir(path):
        merged = merge_host_snapshots(path)
        if not merged:
            return {"agg": None, "source": "none"}
        return {"agg": aggregate(list(merged.values())),
                "source": "merged:%d hosts" % len(merged)}
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    return {"agg": aggregate([doc]), "source": path}


def _fmt_bytes(n):
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return "%.1f %s" % (n, unit)
        n /= 1024.0


def report(path=None, out=None, json_only=False):
    """Per-scope waterfall + cross-host skew + verdict, ending in ONE
    BENCH-style ``memprof_report`` JSON line. Returns the exit code."""
    out = out or sys.stdout
    src = _load_source(path)
    agg = src["agg"]
    if agg is None:
        rec = {"metric": "memprof_report", "verdict": "unknown",
               "hint": HINTS["unknown"], "source": src["source"]}
        if not json_only:
            out.write("memprof: no snapshots found (%s)\n"
                      % src["source"])
        out.write(json.dumps(rec) + "\n")
        return 1
    att = agg["attribution"]
    verdict, hint = classify(att, leak_trips=agg["leak_trips"],
                             live_bytes=agg["live_bytes"],
                             in_use=agg["in_use_bytes"] or None)
    if not json_only:
        out.write("Memory anatomy (%s): %d sample(s) across %d "
                  "host(s)\n" % (src["source"], agg["samples"],
                                 agg["hosts"]))
        total = max(1, sum(att.get(s, 0) for s in
                           RESIDENT_SECTIONS + ("residual",)))
        hdr = "%-12s %14s %7s" % ("Scope", "Bytes", "Share")
        out.write(hdr + "\n" + "-" * len(hdr) + "\n")
        for scope in ATTRIBUTION_SCOPES:
            nbytes = att.get(scope, 0)
            share = nbytes / total if scope not in TRANSIENT_SECTIONS \
                else None
            bar = "#" * int(round(20 * share)) if share else ""
            out.write("%-12s %14s %7s %s\n"
                      % (scope, _fmt_bytes(nbytes),
                         ("%.0f%%" % (100 * share))
                         if share is not None else "-", bar))
        out.write("peak HBM: %s (worst device); cross-host skew %.1f%%\n"
                  % (_fmt_bytes(agg["peak_hbm_bytes"]),
                     100 * agg["peak_skew"]))
        if agg["leak_trips"]:
            out.write("leak sentinel trips: %d\n" % agg["leak_trips"])
        if agg["oom_dumps"]:
            out.write("OOM postmortems: %d\n" % agg["oom_dumps"])
        if agg["admission_rejections"]:
            out.write("admission rejections: %d\n"
                      % agg["admission_rejections"])
        out.write("verdict: %s — %s\n" % (verdict, hint))
    rec = {"metric": "memprof_report", "verdict": verdict, "hint": hint,
           "peak_hbm_bytes": agg["peak_hbm_bytes"],
           "peak_skew": agg["peak_skew"],
           "live_bytes": agg["live_bytes"],
           "scopes": {s: att.get(s, 0) for s in ATTRIBUTION_SCOPES},
           "leak_trips": agg["leak_trips"],
           "oom_dumps": agg["oom_dumps"],
           "admission_rejections": agg["admission_rejections"],
           "hosts": agg["hosts"], "source": src["source"]}
    out.write(json.dumps(rec) + "\n")
    return 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.memprof",
        description="Memory anatomy report: per-scope waterfall, "
                    "cross-host skew, verdict")
    ap.add_argument("command", choices=["report"])
    ap.add_argument("path", nargs="?", default=None,
                    help="memprof_host*.json file or a dir of them "
                         "(default: MXNET_TELEMETRY_DIR merge, else "
                         "the live process)")
    ap.add_argument("--json", action="store_true",
                    help="emit only the memprof_report JSON line")
    args = ap.parse_args(argv)
    return report(args.path, json_only=args.json)


# ---------------------------------------------------------------------------
# process tracker + import-time registration (series exist as zeros
# before the first sample, so dashboards never see missing series)

for _scope in ATTRIBUTION_SCOPES:
    telemetry.gauge("memory_bytes",
                    help="live device bytes attributed by scope "
                         "against the memory ledger (device=all), and "
                         "per-device allocator in_use (scope=in_use)",
                    device="all", scope=_scope)
telemetry.counter("admission_rejections_total",
                  help="allocations refused by memprof.admit because "
                       "the projected peak exceeded limit x "
                       "MXNET_MEM_FRACTION")
telemetry.counter("oom_events_total",
                  help="device out-of-memory errors memprof wrote a "
                       "postmortem for")

tracker = MemTracker()


def _atexit_snapshot():
    try:
        tracker.write_host_snapshot()
    except Exception as exc:
        telemetry.swallowed("memprof.atexit", exc)


atexit.register(_atexit_snapshot)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
