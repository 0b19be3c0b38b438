"""Request anatomy: per-request tracing, tail-latency attribution, and
SLO tracking for the serving subsystem.

Counterpart of `mxnet_tpu/serving/reqtrace.py`, with its metric names,
labels, verdict labels and JSON keys, so one dashboard reads both
packages. The aggregate ``serving_*`` counters say THAT p99 spiked; this
module says WHICH requests were slow and WHY:

1. **Trace IDs** -- every request carries a ``rid`` (taken from the
   ``X-Request-Id`` HTTP header in `serving/server.py`, generated
   otherwise) that threads through the engine, the telemetry JSONL
   spans, error responses, and the slow-request exemplar ring.
2. **Fixed phase taxonomy** -- the engine marks monotonic boundaries as
   a request moves through the pipeline; :class:`Trace` folds them into

       queue_wait       submit -> batcher pickup
       batch_wait       pickup -> worker starts the batch (coalescing
                        window + waiting for a free replica)
       pad              feed assembly: concat + pad-to-bucket
       dispatch         ``Predictor.forward`` until it returns: on the
                        card the input copy and the CUDA graph's replay
                        are queued, not finished
       device_compute   blocking output readback (the card runs the
                        queued work; on the CPU the forward already ran)
       split            un-batching outputs back into per-request rows
       respond          resolving this request's Future (including
                        waiting for earlier siblings in the batch)

   Boundaries telescope: a completed request's phase durations sum
   EXACTLY to its measured wall latency. Completed requests emit one
   ``serving.request`` span into the telemetry JSONL (chrome-trace
   mergeable); the engine emits one ``serving.batch`` span per
   dispatched micro-batch carrying the member request IDs
   (``args.rids``) -- the batch<->request linkage.
3. **Padding / batch-efficiency ledger** -- `batching.PadLedger`
   accounts real vs padded rows per bucket; published as
   ``serving_pad_waste_ratio`` + ``serving_bucket_occupancy{bucket=}``
   gauges and ``serving_{real,pad}_rows_total{bucket=}`` counters,
   since pad-to-bucket work is invisible in per-request latency.
4. **SLO tracking** -- :class:`SLOTracker`: a request is *good* when it
   completed ok within ``target_ms``; the SLO demands ``availability``
   of requests be good. Multi-window burn rates (bad fraction / error
   budget; >1 = burning faster than the SLO allows) surface as
   ``serving_slo_burn_rate{window=}`` gauges in the Prometheus dump and
   in ``/healthz`` so load balancers can act on saturation.
5. **Tail-latency attribution report** -- ``python -m
   mxnet_tpu_torch.serving.reqtrace report [path]`` reads per-host
   snapshots (``reqtrace_host<h>_pid<p>.json``, the telemetry-dir
   transport of stepprof) or the live process, contrasts p50 vs p99
   phase shares, and emits a verdict -- queue-bound / padding-bound /
   compute-bound / shed-heavy -- with a remediation hint keyed to the
   engine knobs (``MXNET_SERVING_MAX_DELAY_MS``, the bucket ladder,
   ``MXNET_SERVING_REPLICAS``).

Recording is always on and bounded: a deque of the last
``MXNET_REQTRACE_WINDOW`` completed-request records plus a
``MXNET_REQTRACE_SLOW_KEEP``-sized slowest-request heap. Stdlib +
telemetry only.

Lock order: the tracer and the SLO tracker each have ONE lock; they may
call into telemetry (whose registry lock is innermost of all) but never
into the engine.
"""
from __future__ import annotations

import atexit
import heapq
import json
import logging
import os
import threading
import time
import uuid

from .. import telemetry
from .batching import PadLedger

__all__ = ["PHASES", "new_request_id", "clean_request_id", "Trace",
           "RequestTracer", "tracer", "SLOTracker", "classify",
           "VERDICT_HINTS", "SHED_HEAVY_FRACTION", "PAD_WASTE_BOUND",
           "snapshot", "reset", "write_host_snapshot",
           "merge_host_snapshots", "report", "main"]

#: The fixed taxonomy. Order is pipeline (and display) order.
PHASES = ("queue_wait", "batch_wait", "pad", "dispatch",
          "device_compute", "split", "respond")

#: Boundary marks, in timeline order: phase ``i`` spans
#: ``_MARKS[i] -> _MARKS[i+1]`` and the final phase (``respond``) is
#: closed by the resolve timestamp handed to :meth:`Trace.phases`.
_MARKS = ("enqueued", "picked", "pad_start", "pad_end", "forward_end",
          "outputs_end", "split_end")

#: phases whose tail share votes "the queue, not the device" — the rest
#: of the taxonomy votes compute (pad/split/respond are host work the
#: batch pays per dispatch).
QUEUE_PHASES = ("queue_wait", "batch_wait")

#: shed+expired fraction of submissions above which the verdict is
#: shed-heavy regardless of what the completed tail looks like (the
#: requests that never completed ARE the latency story).
SHED_HEAVY_FRACTION = 0.05

#: cumulative pad-waste ratio above which a compute-heavy tail is
#: blamed on padding, not the model.
PAD_WASTE_BOUND = 0.35


logger = logging.getLogger(__name__)


def _env_num(name, default, cast):
    """Shared across the serving package (engine.py aliases this): a
    bad observability/tuning knob must degrade to its default, never
    prevent the serving process from booting."""
    val = os.environ.get(name)
    if not val:
        return default
    try:
        return cast(val)
    except ValueError:
        logger.warning("bad %s=%r ignored (want %s)", name, val,
                       cast.__name__)
        return default


def new_request_id():
    """A fresh 16-hex-char request id (collision-safe per process run,
    short enough to read in a log line)."""
    return uuid.uuid4().hex[:16]


_RID_OK = frozenset("abcdefghijklmnopqrstuvwxyz"
                    "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._:-")
_RID_MAX = 128


def clean_request_id(rid):
    """Sanitize a caller-supplied request id: keep [A-Za-z0-9._:-] up to
    128 chars; anything empty/invalid gets a generated id instead (a
    hostile header must not be able to inject into log lines or JSONL)."""
    if rid is None:
        return new_request_id()
    rid = "".join(c for c in str(rid)[:_RID_MAX] if c in _RID_OK)
    return rid or new_request_id()


class Trace:
    """Per-request phase timeline: monotonic boundary marks set as the
    request moves through the engine, folded into per-phase durations at
    resolve time.

    Boundaries telescope: for a completed request (every mark present)
    the phase durations sum EXACTLY to ``end - enqueued`` — the
    acceptance property the mixed-size load test asserts. Partial
    traces (expired/error paths) attribute the remaining time to the
    phase that was in progress when the request died."""

    __slots__ = ("rid", "wall0", "bucket", "batch", "marks")

    def __init__(self, rid=None, wall0=None):
        self.rid = rid or new_request_id()
        self.wall0 = time.time() if wall0 is None else float(wall0)
        self.bucket = None
        self.batch = None
        self.marks = {}

    def mark(self, name, t=None):
        if name not in _MARKS:
            raise ValueError("unknown trace mark %r (marks: %s)"
                             % (name, ", ".join(_MARKS)))
        self.marks[name] = time.monotonic() if t is None else float(t)

    def phases(self, end):
        """{phase: seconds} from the boundary marks up to ``end``.

        Walks the marks in timeline order; the first missing mark stops
        the walk and the remainder (``end`` minus the last boundary) is
        attributed to the phase that was in progress — so an
        expired-in-queue request reads as pure ``queue_wait`` and a
        complete trace telescopes exactly."""
        out = {}
        last = self.marks.get("enqueued")
        if last is None:
            return out
        stalled = len(PHASES) - 1
        for i, mark in enumerate(_MARKS[1:]):
            t = self.marks.get(mark)
            if t is None:
                stalled = i
                break
            out[PHASES[i]] = max(0.0, t - last)
            last = t
        out[PHASES[stalled]] = out.get(PHASES[stalled], 0.0) \
            + max(0.0, float(end) - last)
        return out


class SLOTracker:
    """Latency + availability SLO with multi-window burn rates.

    A request is *good* when it completed ok within ``target_ms``
    (a slow success still burns the latency SLO; a shed/expired/errored
    request is always bad). The SLO demands at least ``availability``
    of requests be good, so the error budget is ``1 - availability``
    and the burn rate over a window is ``bad_fraction / error_budget``
    — 1.0 means spending budget exactly at the sustainable rate, >1
    means burning faster (the multi-window burn-rate alerting
    convention: page on the short window, ticket on the long one).

    Bounded: fixed-width time buckets covering only the longest window.
    ``clock`` is injectable for deterministic tests. Reads no state
    outside itself — the engine owns one and samples
    :meth:`burn_rate` into scrape-time gauges."""

    BUCKET_SECONDS = 10.0

    def __init__(self, target_ms=None, availability=None, windows=None,
                 clock=time.monotonic):
        if target_ms is None:
            target_ms = _env_num("MXNET_SLO_LATENCY_MS", 250.0, float)
        if availability is None:
            availability = _env_num("MXNET_SLO_AVAILABILITY", 0.999,
                                    float)
        if windows is None:
            spec = os.environ.get("MXNET_SLO_WINDOWS", "") or "300,3600"
            try:
                windows = [int(w) for w in spec.split(",") if w.strip()]
                if not windows or min(windows) <= 0:
                    raise ValueError(spec)
            except ValueError:
                logger.warning("bad MXNET_SLO_WINDOWS=%r ignored (want "
                               "comma-separated positive seconds)", spec)
                windows = [300, 3600]
        if not 0.0 < float(availability) < 1.0:
            raise ValueError("availability must be in (0, 1), got %r"
                             % (availability,))
        if float(target_ms) <= 0:
            raise ValueError("target_ms must be > 0, got %r"
                             % (target_ms,))
        self.target_ms = float(target_ms)
        self.availability = float(availability)
        self.windows = tuple(sorted(set(int(w) for w in windows)))
        if not self.windows or self.windows[0] <= 0:
            raise ValueError("windows must be positive seconds, got %r"
                             % (windows,))
        self._clock = clock
        self._lock = threading.Lock()
        from collections import deque
        self._buckets = deque()   # [bucket_start, total, bad]
        self._good_total = 0
        self._bad_total = 0

    @property
    def error_budget(self):
        return 1.0 - self.availability

    def record(self, ok, latency_s=None):
        """Fold one request outcome in. ``ok=False`` (shed / expired /
        error / closed) is always bad; ``ok=True`` is bad when
        ``latency_s`` exceeds the target."""
        bad = (not ok) or (latency_s is not None
                           and latency_s * 1000.0 > self.target_ms)
        now = self._clock()
        start = now - (now % self.BUCKET_SECONDS)
        with self._lock:
            if not self._buckets or self._buckets[-1][0] != start:
                self._buckets.append([start, 0, 0])
                horizon = now - max(self.windows) - self.BUCKET_SECONDS
                while self._buckets and self._buckets[0][0] < horizon:
                    self._buckets.popleft()
            ent = self._buckets[-1]
            ent[1] += 1
            if bad:
                ent[2] += 1
                self._bad_total += 1
            else:
                self._good_total += 1

    def window_counts(self, window):
        """(total, bad) over the trailing ``window`` seconds."""
        lo = self._clock() - float(window)
        total = bad = 0
        with self._lock:
            for start, t, b in self._buckets:
                if start + self.BUCKET_SECONDS > lo:
                    total += t
                    bad += b
        return total, bad

    def burn_rate(self, window):
        """Burn rate over the trailing window; 0.0 with no traffic
        (an idle service is not an alert)."""
        total, bad = self.window_counts(window)
        if total == 0:
            return 0.0
        return (bad / float(total)) / self.error_budget

    def snapshot(self):
        with self._lock:
            good, bad = self._good_total, self._bad_total
        return {"target_ms": self.target_ms,
                "availability": self.availability,
                "good_total": good, "bad_total": bad,
                "burn_rate": {str(w): round(self.burn_rate(w), 4)
                              for w in self.windows}}


class RequestTracer:
    """Process-wide accumulator of resolved request traces (the serving
    analog of ``stepprof.StepProfiler``; tests may instantiate their
    own). Bounded: a deque of the last ``window`` completed records, a
    ``slow_keep``-sized slowest-request heap (the exemplar ring), a
    status-count dict, and the cumulative :class:`batching.PadLedger`."""

    def __init__(self, window=None, slow_keep=None):
        if window is None:
            window = _env_num("MXNET_REQTRACE_WINDOW", 2048, int)
        if slow_keep is None:
            slow_keep = _env_num("MXNET_REQTRACE_SLOW_KEEP", 8, int)
        from collections import deque
        self._lock = threading.Lock()
        self._window = deque(maxlen=max(16, int(window)))
        self._slow_keep = max(1, int(slow_keep))
        self._slow = []            # min-heap of (total, seq, record)
        self._seq = 0
        self._counts = {}          # final status -> count (incl. rejects)
        self.pad = PadLedger()
        self._export_thread = None

    # -- recording --------------------------------------------------------

    def record(self, trace, end, status="ok"):
        """Fold one resolved request in (the engine calls this at
        resolve time, AFTER the future is handed its result). Feeds the
        per-phase histograms, the window, the slow ring, and — when an
        event log or tap is live — one ``serving.request`` JSONL span.
        Returns the record (tests)."""
        phases = trace.phases(end)
        total = max(0.0, float(end) - trace.marks.get("enqueued", end))
        rec = {"rid": trace.rid, "status": status, "total": total,
               "phases": phases, "bucket": trace.bucket,
               "batch": trace.batch, "ts": trace.wall0}
        for name, dur in phases.items():
            telemetry.histogram(
                "serving_req_phase_seconds",
                help="per-request phase durations (reqtrace taxonomy)",
                phase=name).observe(dur)
        with self._lock:
            self._seq += 1
            self._counts[status] = self._counts.get(status, 0) + 1
            if status == "ok":
                self._window.append(rec)
                item = (total, self._seq, rec)
                if len(self._slow) < self._slow_keep:
                    heapq.heappush(self._slow, item)
                elif total > self._slow[0][0]:
                    heapq.heapreplace(self._slow, item)
        telemetry.record_span(
            "serving.request", trace.wall0, total, rid=trace.rid,
            status=status, bucket=trace.bucket, batch=trace.batch,
            phases={k: round(v, 6) for k, v in phases.items()})
        self._maybe_export()
        return rec

    def note_reject(self, status):
        """Count a request the engine refused without computing (shed /
        expired-at-submit / closed) — the shed-heavy verdict's input."""
        with self._lock:
            self._seq += 1
            self._counts[status] = self._counts.get(status, 0) + 1

    def note_batch(self, rows, bucket):
        """Account one dispatched micro-batch's padding: ``rows`` real
        rows padded up to ``bucket``. Publishes the pad-waste gauges the
        padding-bound verdict and the Prometheus dump read."""
        self.pad.note(rows, bucket)
        pad_rows = int(bucket) - int(rows)
        telemetry.counter("serving_real_rows_total",
                          help="real request rows dispatched, by bucket",
                          bucket=str(bucket)).inc(rows)
        if pad_rows:
            telemetry.counter("serving_pad_rows_total",
                              help="padding rows dispatched, by bucket",
                              bucket=str(bucket)).inc(pad_rows)
        telemetry.gauge(
            "serving_pad_waste_ratio",
            help="padding rows / all dispatched rows, cumulative "
                 "(1 - weighted batch occupancy)").set(
                     self.pad.waste_ratio())
        telemetry.gauge(
            "serving_bucket_occupancy",
            help="real rows / dispatched rows per bucket, cumulative",
            bucket=str(bucket)).set(self.pad.occupancy(bucket))

    def reset(self):
        with self._lock:
            self._window.clear()
            self._slow = []
            self._seq = 0
            self._counts = {}
        self.pad.reset()

    # -- views ------------------------------------------------------------

    def records(self):
        """The window's completed-request records, oldest first."""
        with self._lock:
            return list(self._window)

    def counts(self):
        with self._lock:
            return dict(self._counts)

    def attribution(self):
        """The p50-vs-p99 anatomy over the window: latency percentiles,
        mean phase shares of the p50 cohort (total <= median) vs the
        tail cohort (total >= p99), shed fraction of all submissions,
        and the pad ledger snapshot."""
        with self._lock:
            recs = list(self._window)
            counts = dict(self._counts)
        submitted = sum(counts.values())
        shed = counts.get("shed", 0) + counts.get("expired", 0)
        out = {"requests": len(recs), "counts": counts,
               "shed_fraction": (shed / float(submitted))
               if submitted else 0.0,
               "pad": self.pad.snapshot(),
               "latency": {}, "p50_shares": {}, "p99_shares": {}}
        if not recs:
            return out
        totals = sorted(r["total"] for r in recs)
        lat = {"count": len(totals), "max": totals[-1]}
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            lat[key] = _percentile(totals, q)
        head = [r for r in recs if r["total"] <= lat["p50"]]
        tail = [r for r in recs if r["total"] >= lat["p99"]]
        if not tail:   # tiny window: the slowest request IS the tail
            tail = [max(recs, key=lambda r: r["total"])]
        out["latency"] = lat
        out["p50_shares"] = _mean_shares(head)
        out["p99_shares"] = _mean_shares(tail)
        return out

    def slowest(self):
        """The exemplar ring: the slowest completed requests (full
        phase detail), slowest first."""
        with self._lock:
            items = sorted(self._slow, key=lambda it: -it[0])
        return [rec for _total, _seq, rec in items]

    def snapshot(self):
        """One JSON-able view: identity, attribution, slow exemplars,
        verdict + hint."""
        att = self.attribution()
        v, hint = classify(att["p99_shares"],
                           shed_fraction=att["shed_fraction"],
                           pad_waste=att["pad"].get("waste_ratio"))
        doc = {"host": telemetry.host_id(), "pid": os.getpid(),
               "updated": time.time(), "slowest": self.slowest(),
               "verdict": v, "hint": hint}
        doc.update(att)
        return doc

    # -- cross-host export (stepprof's transport) -------------------------

    def _maybe_export(self):
        """Start the background exporter the first time a request is
        recorded while a telemetry dir is configured — snapshot writes
        are file I/O that must never add tail latency to the serving
        path being measured."""
        if telemetry.configured_dir() is None:
            return
        with self._lock:
            if self._export_thread is not None:
                return
            t = threading.Thread(target=self._export_loop, daemon=True,
                                 name="mxnet_tpu_torch-reqtrace-export")
            self._export_thread = t
        t.start()

    def _export_loop(self):
        while True:
            time.sleep(2.0)
            if telemetry.configured_dir() is None:
                continue   # dir unconfigured mid-run: idle, not dead
            try:
                if self._seq:
                    self.write_host_snapshot()
            except Exception as exc:
                telemetry.swallowed("reqtrace.export", exc)

    def write_host_snapshot(self, dir=None, force=False):
        """Write this process's ``reqtrace_host<h>_pid<p>.json`` into
        ``dir`` (default: the configured telemetry dir; None and no dir
        -> no-op) via `telemetry.write_host_json` — the one atomic
        per-host snapshot transport (shared with stepprof and
        shardprof)."""
        if not force and self._seq == 0:
            return None
        return telemetry.write_host_json("reqtrace", self.snapshot(),
                                         dir=dir)


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) \
        * (pos - lo)


def _mean_shares(recs):
    """Normalized mean phase shares over a cohort (sum exactly 1.0;
    {} for an empty cohort)."""
    tot = {}
    for r in recs:
        for k, v in r["phases"].items():
            tot[k] = tot.get(k, 0.0) + v
    denom = sum(tot.values())
    if not tot or denom <= 0:
        return {}
    return {p: tot.get(p, 0.0) / denom for p in PHASES}


#: the process-wide tracer behind the engine and the module facade
tracer = RequestTracer()


def _atexit_snapshot():
    try:
        tracer.write_host_snapshot()
    except Exception as exc:
        telemetry.swallowed("reqtrace.atexit", exc)


atexit.register(_atexit_snapshot)


def snapshot():
    return tracer.snapshot()


def reset():
    tracer.reset()


def write_host_snapshot(dir=None, force=False):
    return tracer.write_host_snapshot(dir=dir, force=force)


# ---------------------------------------------------------------------------
# Verdict
# ---------------------------------------------------------------------------

VERDICT_HINTS = {
    "queue-bound":
        "the tail forms in front of the device, not on it: add replicas "
        "(MXNET_SERVING_REPLICAS / EngineConfig.replicas, or an explicit "
        "ctx list across devices), lower MXNET_SERVING_MAX_DELAY_MS so "
        "micro-batches close sooner, and check serving_queue_depth "
        "against MXNET_SERVING_QUEUE_DEPTH — a queue that is always "
        "full should shed earlier, not stretch p99",
    "padding-bound":
        "dispatched batches are mostly padding: raise "
        "MXNET_SERVING_MAX_DELAY_MS so batches fill before dispatch, "
        "densify the bucket ladder near the observed request sizes "
        "(batching.bucket_sizes; see serving_bucket_occupancy{bucket=}), "
        "or lower MXNET_SERVING_MAX_BATCH so the top bucket matches "
        "real traffic",
    "compute-bound":
        "the device itself is the tail: add replicas on more devices "
        "(MXNET_SERVING_REPLICAS or InferenceEngine(ctx=[...])), shrink "
        "or quantize the model (ROADMAP item 3's int8 serving path), "
        "and verify cold_compiles() == 0 so no tail request is paying "
        "a compile",
    "shed-heavy":
        "load shedding is the latency story — completed-request "
        "percentiles hide the requests that never ran: raise "
        "MXNET_SERVING_QUEUE_DEPTH to absorb bursts, add replicas "
        "(MXNET_SERVING_REPLICAS) for sustained arrival, or set client "
        "deadlines (MXNET_SERVING_DEADLINE_MS) so doomed work leaves "
        "the queue before computing",
    "unknown":
        "no completed request traces recorded: serve traffic through "
        "InferenceEngine (reqtrace records automatically) or point the "
        "report at a reqtrace snapshot / telemetry dir",
}


def classify(tail_shares, shed_fraction=0.0, pad_waste=None):
    """(verdict, hint) from the tail's phase shares plus the two
    signals per-request latency cannot carry: the shed fraction (work
    that never completed) and the cumulative pad-waste ratio (compute
    spent on rows nobody asked for).

    Precedence: shed-heavy (the tail percentiles are lies when 5%+ of
    submissions never ran) > queue-bound (tail waits, the fix is
    capacity/coalescing regardless of padding) > padding-bound (tail
    computes but >=35% of dispatched rows are padding) >
    compute-bound."""
    if shed_fraction and shed_fraction >= SHED_HEAVY_FRACTION:
        return "shed-heavy", ("%.0f%% of submissions were rejected "
                              "(shed/expired); " % (shed_fraction * 100)
                              + VERDICT_HINTS["shed-heavy"])
    if not tail_shares or sum(tail_shares.values()) <= 0:
        return "unknown", VERDICT_HINTS["unknown"]
    queue = sum(tail_shares.get(p, 0.0) for p in QUEUE_PHASES)
    compute = sum(v for p, v in tail_shares.items()
                  if p not in QUEUE_PHASES)
    if queue >= compute:
        return "queue-bound", VERDICT_HINTS["queue-bound"]
    if pad_waste is not None and pad_waste >= PAD_WASTE_BOUND:
        return "padding-bound", ("%.0f%% of dispatched rows are "
                                 "padding; " % (pad_waste * 100)
                                 + VERDICT_HINTS["padding-bound"])
    return "compute-bound", VERDICT_HINTS["compute-bound"]


# ---------------------------------------------------------------------------
# Report CLI: python -m mxnet_tpu_torch.serving.reqtrace report [path]
# ---------------------------------------------------------------------------

def merge_host_snapshots(dir=None):
    """Read every ``reqtrace_host*.json`` under ``dir`` (default: the
    configured telemetry dir), keeping the freshest snapshot per host
    (`telemetry.merge_host_json`). Returns {host_id: snapshot_dict}."""
    return telemetry.merge_host_json("reqtrace", dir)


def _combine(hosts):
    """Aggregate per-host snapshots into one report source: counts sum,
    phase shares are request-weighted means, pad buckets sum, and the
    reported percentiles come from the worst-p99 host (percentiles do
    not merge; the worst host is the one to fix)."""
    docs = list(hosts.values())
    if len(docs) == 1:
        return dict(docs[0])
    counts = {}
    for d in docs:
        for k, v in (d.get("counts") or {}).items():
            counts[k] = counts.get(k, 0) + int(v)
    submitted = sum(counts.values())
    shed = counts.get("shed", 0) + counts.get("expired", 0)

    def wmean(key):
        tot, w = {}, 0
        for d in docs:
            n = int(d.get("requests") or 0)
            for p, v in (d.get(key) or {}).items():
                tot[p] = tot.get(p, 0.0) + float(v) * n
            w += n if d.get(key) else 0
        return {p: v / w for p, v in tot.items()} if w else {}

    pad_buckets = {}
    for d in docs:
        for b, ent in ((d.get("pad") or {}).get("buckets") or {}).items():
            agg = pad_buckets.setdefault(b, {"batches": 0, "real_rows": 0})
            agg["batches"] += int(ent.get("batches", 0))
            agg["real_rows"] += int(ent.get("real_rows", 0))
    total_rows = sum(int(b) * e["batches"] for b, e in pad_buckets.items())
    real_rows = sum(e["real_rows"] for e in pad_buckets.values())
    for b, e in pad_buckets.items():
        disp = int(b) * e["batches"]
        e["occupancy"] = round(e["real_rows"] / disp, 4) if disp else None
    worst = max(docs, key=lambda d: (d.get("latency") or {}).get("p99", 0))
    return {"requests": sum(int(d.get("requests") or 0) for d in docs),
            "counts": counts,
            "shed_fraction": (shed / float(submitted)) if submitted
            else 0.0,
            "latency": dict(worst.get("latency") or {},
                            _host=worst.get("host")),
            "p50_shares": wmean("p50_shares"),
            "p99_shares": wmean("p99_shares"),
            "pad": {"waste_ratio": (1.0 - real_rows / float(total_rows))
                    if total_rows else 0.0, "buckets": pad_buckets},
            "slowest": sorted(
                (r for d in docs for r in d.get("slowest") or []),
                key=lambda r: -r.get("total", 0))[:8],
            "hosts": len(docs)}


def _load_source(path):
    """Resolve a report data source into ``(doc, source_label)``.

    ``path`` may be: a reqtrace snapshot JSON file, a directory of
    per-host snapshots, or None (the telemetry dir when configured,
    else the live in-process tracer)."""
    if path is None:
        d = telemetry.configured_dir() \
            or os.environ.get("MXNET_TELEMETRY_DIR")
        if d and merge_host_snapshots(d):
            return _load_source(d)
        return tracer.snapshot(), "live process"
    if os.path.isdir(path):
        hosts = merge_host_snapshots(path)
        if not hosts:
            return {}, "no reqtrace_host*.json under %s" % path
        return _combine(hosts), ("%d host snapshot(s) in %s"
                                 % (len(hosts), path))
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh), path


def report(path=None, out=None, json_only=False):
    """Render the tail-latency attribution report; returns the process
    exit code (0 = a verdict was produced, 1 = no data)."""
    import sys
    out = out or sys.stdout
    doc, source = _load_source(path)
    p50 = doc.get("p50_shares") or {}
    p99 = doc.get("p99_shares") or {}
    lat = doc.get("latency") or {}
    pad = doc.get("pad") or {}
    shed = float(doc.get("shed_fraction") or 0.0)
    v, hint = classify(p99, shed_fraction=shed,
                       pad_waste=pad.get("waste_ratio"))
    dominant = max(p99, key=lambda p: p99[p]) if p99 else None
    if not json_only:
        out.write("Request anatomy (%s)\n" % source)
        if lat:
            out.write("  latency: p50 %.2fms  p95 %.2fms  p99 %.2fms "
                      "over %d requests\n"
                      % (1e3 * lat.get("p50", 0.0),
                         1e3 * lat.get("p95", 0.0),
                         1e3 * lat.get("p99", 0.0),
                         int(doc.get("requests") or 0)))
        if p50 or p99:
            width = max(len(p) for p in PHASES)
            out.write("  %-*s %8s %8s %8s\n"
                      % (width, "phase", "p50", "p99", "delta"))
            for name in PHASES:
                a = p50.get(name, 0.0)
                b = p99.get(name, 0.0)
                bar = "#" * int(round(b * 30))
                out.write("  %-*s %7.1f%% %7.1f%% %+7.1f%% %s\n"
                          % (width, name, a * 100, b * 100,
                             (b - a) * 100, bar))
        if dominant is not None:
            out.write("  dominant p99 phase: %s (%.0f%% of tail)\n"
                      % (dominant, p99[dominant] * 100))
        if pad.get("waste_ratio") is not None:
            out.write("  pad waste: %.1f%% of dispatched rows\n"
                      % (100 * float(pad["waste_ratio"] or 0.0)))
        if shed:
            out.write("  shed/expired: %.1f%% of submissions\n"
                      % (shed * 100))
        for rec in (doc.get("slowest") or [])[:3]:
            out.write("  slow exemplar %s: %.2fms %s\n"
                      % (rec.get("rid"), 1e3 * rec.get("total", 0.0),
                         " ".join("%s=%.1fms" % (p, 1e3 * d) for p, d
                                  in sorted((rec.get("phases") or {})
                                            .items(),
                                            key=lambda kv: -kv[1])[:3])))
        out.write("  verdict: %s\n  hint: %s\n" % (v, hint))
    rec = {"metric": "reqtrace_report", "verdict": v,
           "dominant_p99_phase": dominant,
           "p50_shares": {k: round(val, 4) for k, val in p50.items()},
           "p99_shares": {k: round(val, 4) for k, val in p99.items()},
           "shed_fraction": round(shed, 4),
           "pad_waste_ratio": pad.get("waste_ratio"),
           "source": source}
    out.write(json.dumps(rec) + "\n")
    return 0 if v != "unknown" else 1


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving.reqtrace",
        description="Request anatomy report: p50 vs p99 phase shares, "
                    "pad waste, shed fraction, tail verdict")
    ap.add_argument("command", choices=["report"],
                    help="'report': attribute the serving tail")
    ap.add_argument("path", nargs="?", default=None,
                    help="reqtrace snapshot JSON or a telemetry dir of "
                         "reqtrace_host*.json (default: the configured "
                         "telemetry dir, then the live process)")
    ap.add_argument("--json", action="store_true",
                    help="machine line only, no table")
    args = ap.parse_args(argv)
    return report(args.path, json_only=args.json)


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
