"""Dynamic micro-batching inference engine.

Counterpart of `mxnet_tpu/serving/engine.py`. It turns the synchronous,
single-shape `predict.Predictor` into a serving stack:

- **Replica pool** -- one worker thread per replica, each owning one
  bucket-bound `Predictor` sibling per batch-size bucket over ONE device
  copy of the weights (`Predictor.sibling`).
- **Dynamic micro-batching** -- requests land in a bounded queue; a
  batcher thread coalesces them until ``max_batch_size`` rows or
  ``max_batch_delay_ms`` elapse, then pads the batch to the next bucket
  (`serving/batching.py`).
- **One graph per bucket** -- each bucket's forward is one captured CUDA
  graph of its executor (`executor.py` over `compiled.py`), all of a
  replica's buckets in one graph pool; :meth:`~InferenceEngine.warm`
  captures every (replica, bucket) at startup and counts the captures
  (``warmup_compiles``), and :meth:`~InferenceEngine.cold_compiles`
  reads the compiles since then from `compiled.compile_counts` (0 in
  steady state: no capture under load).
- **Robustness** -- per-request deadlines, load shedding with a distinct
  :class:`RequestRejected` when the queue is full or a deadline passed,
  graceful :meth:`~InferenceEngine.drain` / :meth:`~InferenceEngine.shutdown`;
  a batch that fails resolves its requests with the error and the worker
  goes on; a dead replica worker fails ONLY its in-flight batch, dumps
  the flight recorder, and is respawned -- the chaos sites
  ``serving.slow_request`` and ``serving.worker_death`` drive both paths.
- **Admission** -- before any replica binds, `memprof.admit` refuses a
  model whose parameters, times the replicas, exceed the device's memory
  budget (``MemoryAdmissionError``).
- **Request anatomy** (`serving/reqtrace.py`) -- every request carries a
  trace id (``rid``) and a monotonic boundary-mark trace; the engine
  marks enqueue, batcher pickup, pad/dispatch/readback/split boundaries
  and resolve, so each completed request decomposes into the fixed
  ``queue_wait/batch_wait/pad/dispatch/device_compute/split/respond``
  taxonomy (the phases telescope to the request's wall latency). An
  :class:`reqtrace.SLOTracker` per engine turns outcomes into
  multi-window burn-rate gauges.

Telemetry (all in the process-wide registry, scraped by
``serving/server.py`` ``/metrics``):

- ``serving_requests_total{status=ok|shed|expired|error|closed}``
- ``serving_batches_total{bucket=}`` and ``serving_batch_occupancy``
  (real rows / bucket rows -- padding waste is 1 minus this)
- ``serving_queue_wait_seconds`` / ``serving_compute_seconds`` /
  ``serving_total_seconds`` latency histograms, plus the per-phase
  ``serving_req_phase_seconds{phase=}`` anatomy histograms
- ``serving_queue_depth`` / ``serving_workers_alive`` /
  ``serving_inflight_requests`` gauges (scrape-time sampled)
- ``serving_worker_deaths_total`` / ``serving_worker_respawns_total``
- ``serving_pad_waste_ratio`` / ``serving_bucket_occupancy{bucket=}``
  and ``serving_{real,pad}_rows_total{bucket=}`` (the pad ledger)
- ``serving_slo_burn_rate{window=}`` / ``serving_slo_target_ms``

:meth:`~InferenceEngine.stats` carries the saturation signals, the
compile counts and `memprof.health`'s headroom, and besides those (as
the port's engine did before its hooks) this engine's request counts by
status, its own padding ledger and the warm-up's seconds.

Defaults come from ``MXNET_SERVING_*`` env vars via :class:`EngineConfig`.
The device defaults to ``gpu(0)`` (the Predictor's default).

Lock order: the engine has ONE lock, ``self._cond`` (registered with
`threadsan`); every read-modify-write of ``_pending`` / ``_draining`` /
``_closed`` / ``_counts`` happens under it, and nothing else is acquired
while it is held (queue operations use the queues' internal locks only).
Telemetry calls may take the registry lock; never call into the engine
from a telemetry tap. A replica's program lock (`compiled.py`) is taken
inside ``Predictor.forward`` by a ``with`` block, so a worker that dies
never holds it.
"""
from __future__ import annotations

import itertools
import logging
import queue as _queue
import threading
import time
import weakref
from concurrent.futures import Future

import numpy as np

from .. import chaos
from .. import compiled
from .. import memprof
from .. import telemetry
from .. import threadsan
from .. import xla_stats
from ..base import MXNetError
from ..predict import Predictor
from . import reqtrace
from .batching import (PadLedger, bucket_sizes, pad_rows, pick_bucket,
                       split_rows)

__all__ = ["EngineConfig", "InferenceEngine", "RequestRejected"]

logger = logging.getLogger("mxnet_tpu_torch.serving")

_STOP = object()


class RequestRejected(MXNetError):
    """The engine refused (or abandoned) a request WITHOUT computing it:
    ``status`` is ``"shed"`` (queue full), ``"expired"`` (deadline
    passed before compute), or ``"closed"`` (engine draining or shut
    down). Distinct from a compute error so clients can retry/back off
    on rejection but not on a genuine failure."""

    def __init__(self, status, message, rid=None):
        super().__init__(message)
        self.status = status
        self.rid = rid   # trace id, when the rejection got far enough


_env_num = reqtrace._env_num


class EngineConfig:
    """Engine tunables; every default is overridable via env:

    ==========================  =============================  =======
    parameter                   env var                        default
    ==========================  =============================  =======
    ``max_batch_size``          ``MXNET_SERVING_MAX_BATCH``    8
    ``max_batch_delay_ms``      ``MXNET_SERVING_MAX_DELAY_MS`` 2.0
    ``max_queue``               ``MXNET_SERVING_QUEUE_DEPTH``  64
    ``replicas``                ``MXNET_SERVING_REPLICAS``     1
    ``default_deadline_ms``     ``MXNET_SERVING_DEADLINE_MS``  0 (none)
    ==========================  =============================  =======
    """

    def __init__(self, max_batch_size=None, max_batch_delay_ms=None,
                 max_queue=None, replicas=None, default_deadline_ms=None):
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else _env_num("MXNET_SERVING_MAX_BATCH", 8, int))
        self.max_batch_delay_ms = float(
            max_batch_delay_ms if max_batch_delay_ms is not None
            else _env_num("MXNET_SERVING_MAX_DELAY_MS", 2.0, float))
        self.max_queue = int(
            max_queue if max_queue is not None
            else _env_num("MXNET_SERVING_QUEUE_DEPTH", 64, int))
        self.replicas = int(
            replicas if replicas is not None
            else _env_num("MXNET_SERVING_REPLICAS", 1, int))
        self.default_deadline_ms = float(
            default_deadline_ms if default_deadline_ms is not None
            else _env_num("MXNET_SERVING_DEADLINE_MS", 0.0, float))
        if self.max_batch_size < 1:
            raise MXNetError("max_batch_size must be >= 1")
        if self.max_queue < 1:
            raise MXNetError("max_queue must be >= 1")
        if self.replicas < 1:
            raise MXNetError("replicas must be >= 1")

    def __repr__(self):
        return ("EngineConfig(max_batch_size=%d, max_batch_delay_ms=%g, "
                "max_queue=%d, replicas=%d, default_deadline_ms=%g)"
                % (self.max_batch_size, self.max_batch_delay_ms,
                   self.max_queue, self.replicas, self.default_deadline_ms))


class _Request:
    __slots__ = ("inputs", "n", "future", "enqueued", "deadline", "rid",
                 "trace")

    def __init__(self, inputs, n, deadline, rid=None):
        self.inputs = inputs
        self.n = n
        self.future = Future()
        self.enqueued = time.monotonic()
        self.deadline = deadline
        self.rid = reqtrace.clean_request_id(rid)
        self.trace = reqtrace.Trace(self.rid)
        self.trace.mark("enqueued", self.enqueued)


class _Batch:
    __slots__ = ("reqs", "rows", "bucket")

    def __init__(self, reqs, rows, bucket):
        self.reqs = reqs
        self.rows = rows
        self.bucket = bucket


class _WorkerDeath(BaseException):
    """Raised (only) by the ``serving.worker_death`` chaos site; derives
    from BaseException so the per-batch ``except Exception`` handler
    cannot swallow it -- it must kill the worker thread for real."""


class _Replica:
    __slots__ = ("index", "ctx", "preds", "thread", "deaths")

    def __init__(self, index, ctx):
        self.index = index
        self.ctx = ctx
        self.preds = {}       # bucket -> Predictor
        self.thread = None
        self.deaths = 0


_ENGINE_SEQ = itertools.count()   # engine=<n> gauge label per process


class InferenceEngine:
    """Concurrent inference over (symbol JSON, params) with dynamic
    micro-batching -- see the module docstring.

    Parameters
    ----------
    symbol_json : str
        Symbol JSON (as `Predictor`).
    param_bytes : bytes or str or dict
        ``.params`` blob / path / preloaded dict (as `Predictor`).
    input_shapes : dict[str, tuple]
        PER-EXAMPLE shapes, WITHOUT the batch axis -- the engine owns
        batching, so ``{"data": (35,)}`` serves requests of shape
        ``(n, 35)``.
    ctx : Context or list[Context], optional
        One context (replicated ``config.replicas`` times) or an
        explicit per-replica list; ``gpu(0)`` when omitted.
    output_names : list[str], optional
        Partial-out binding, as `Predictor`.
    config : EngineConfig, optional
    warmup : bool
        Capture every (replica, bucket) forward at startup (default).
    """

    def __init__(self, symbol_json, param_bytes, input_shapes, ctx=None,
                 output_names=None, config=None, warmup=True):
        self.config = config or EngineConfig()
        if not input_shapes:
            raise MXNetError("input_shapes is required (per-example "
                             "shapes, without the batch axis)")
        self._example_shapes = {str(k): tuple(int(d) for d in v)
                                for k, v in input_shapes.items()}
        self._buckets = bucket_sizes(self.config.max_batch_size)
        if isinstance(ctx, (list, tuple)):
            ctxs = list(ctx)   # explicit list wins over config.replicas
        else:
            ctxs = [ctx] * self.config.replicas

        # load the params container ONCE; every replica binds from the
        # same host-side dict (device copies happen at bind)
        params = param_bytes if isinstance(param_bytes, dict) \
            else Predictor._load_params(param_bytes)

        # device-memory admission: refuse a model the devices cannot hold
        # BEFORE any replica binds a device copy or captures a graph. The
        # projection is the params' bytes times the replica count;
        # MemoryAdmissionError propagates, any other failure of the
        # projection must not block a load
        try:
            projected = xla_stats.tree_shard_bytes(params) * len(ctxs)
        except Exception as exc:
            telemetry.swallowed("serving.admit_projection", exc)
            projected = 0
        if projected:
            memprof.admit(projected, what="serving model load "
                          "(%d replica(s))" % len(ctxs))

        self._replicas = []
        for i, rctx in enumerate(ctxs):
            rep = _Replica(i, rctx)
            base = Predictor(symbol_json, params, ctx=rctx,
                             input_shapes=self._bucket_shapes(
                                 self._buckets[0]),
                             output_names=output_names)
            rep.preds[self._buckets[0]] = base
            for b in self._buckets[1:]:
                rep.preds[b] = base.sibling(self._bucket_shapes(b))
            self._replicas.append(rep)
        first = self._replicas[0].preds[self._buckets[0]]
        self._dtypes = {name: first._exec.arg_dict[name].dtype
                        for name in self._example_shapes}
        self.num_outputs = first.num_outputs

        self._queue = _queue.Queue(maxsize=self.config.max_queue)
        self._work = _queue.Queue(maxsize=len(self._replicas))
        self._batch_seq = itertools.count(1)   # batch ids for span linkage
        self._slo = reqtrace.SLOTracker()
        self._cond = threadsan.register(
            "engine.InferenceEngine._cond", threading.Condition())
        self._pending = 0          # submitted, not yet resolved
        self._counts = {}          # final status -> requests
        self._draining = False
        self._closed = False
        self._shutdown_started = False
        self._shutdown_done = threading.Event()
        self._shutdown_owner = None
        self._pad = PadLedger()
        self._batcher = None
        self.warmup_seconds = None
        self.warmup_compiles = 0
        self._post_warmup_compiles = None

        self._register_metrics()
        if warmup:
            self.warm()
        self._start_threads()

    # -- setup ------------------------------------------------------------
    def _bucket_shapes(self, bucket):
        return {name: (bucket,) + shape
                for name, shape in self._example_shapes.items()}

    def _register_metrics(self):
        # the engine label keeps scrape-time gauges per engine: a second
        # engine in the process must not clobber the first one's
        # samplers. Samplers hold the engine WEAKLY -- the process-wide
        # registry must not pin replicas (and their device weights) of
        # an engine the caller dropped without shutdown()
        self._engine_label = str(next(_ENGINE_SEQ))
        wr = weakref.ref(self)

        def sampler(fn):
            def read():
                eng = wr()
                return None if eng is None else fn(eng)
            return read

        telemetry.counter("serving_requests_total",
                          help="serving requests by final status")
        telemetry.gauge(
            "serving_queue_depth",
            help="requests waiting in the engine queue",
            engine=self._engine_label).set_function(
                sampler(lambda e: e._queue.qsize()))
        telemetry.gauge(
            "serving_workers_alive",
            help="live serving replica worker threads",
            engine=self._engine_label).set_function(
                sampler(lambda e: e._workers_alive()))
        telemetry.gauge(
            "serving_inflight_requests",
            help="requests submitted but not yet resolved",
            engine=self._engine_label).set_function(
                sampler(lambda e: e._pending))
        telemetry.gauge("serving_buckets",
                        help="configured batch-size buckets",
                        engine=self._engine_label).set(
                            len(self._buckets))
        telemetry.gauge("serving_slo_target_ms",
                        help="per-request latency SLO target",
                        engine=self._engine_label).set(
                            self._slo.target_ms)
        for w in self._slo.windows:
            telemetry.gauge(
                "serving_slo_burn_rate",
                help="SLO error-budget burn rate per trailing window "
                     "(bad fraction / error budget; >1 = burning "
                     "faster than the SLO allows)",
                engine=self._engine_label, window=str(w)).set_function(
                    sampler(lambda e, w=w: e._slo.burn_rate(w)))

    def warm(self):
        """Run one zero-input forward per (replica, bucket): every graph
        the engine can ever replay is captured NOW (on the CPU, every
        signature is compiled into the cache), so steady-state serving
        never captures. Records the compiles it cost in
        ``warmup_compiles`` and its wall time in ``warmup_seconds``;
        :meth:`cold_compiles` reads 0 from then on unless something
        retraced."""
        before = compiled.compile_counts()["compiles"]
        t0 = time.perf_counter()
        for rep in self._replicas:
            for b, pred in sorted(rep.preds.items()):
                zeros = {name: np.zeros((b,) + shape,
                                        dtype=self._dtypes[name])
                         for name, shape in self._example_shapes.items()}
                pred.forward(**zeros)
                pred.get_output(0)   # wait until the device finished
        after = compiled.compile_counts()["compiles"]
        self.warmup_seconds = time.perf_counter() - t0
        self.warmup_compiles = int(after - before)
        self._post_warmup_compiles = after
        telemetry.event("serving.warmup",
                        buckets=list(self._buckets),
                        replicas=len(self._replicas),
                        compiles=self.warmup_compiles,
                        seconds=self.warmup_seconds)

    def cold_compiles(self):
        """Compiles (on the card, CUDA graph captures) since THIS
        engine's warm-up finished: 0 in steady state. None before
        :meth:`warm` ran.

        The counter is process-wide: a compile of anything else in the
        process (another engine warming up, a hybridized block) shows
        here too. A serving process should have no other compile
        activity in steady state, so a nonzero reading is worth an alert
        whichever path caused it; see `compiled.last_retrace` for what
        changed."""
        if self._post_warmup_compiles is None:
            return None
        return int(compiled.compile_counts()["compiles"]
                   - self._post_warmup_compiles)

    def _start_threads(self):
        self._batcher = threading.Thread(
            target=self._batch_loop, daemon=True,
            name="mxnet_tpu_torch-serving-batcher")
        self._batcher.start()
        for rep in self._replicas:
            self._spawn_worker(rep)

    def _spawn_worker(self, rep):
        rep.thread = threading.Thread(
            target=self._worker_loop, args=(rep,), daemon=True,
            name="mxnet_tpu_torch-serving-worker-%d" % rep.index)
        rep.thread.start()

    def _workers_alive(self):
        return sum(1 for r in self._replicas
                   if r.thread is not None and r.thread.is_alive())

    # -- client surface ---------------------------------------------------
    def submit(self, inputs, deadline_ms=None, rid=None):
        """Enqueue one request of ``n`` examples; returns a
        ``concurrent.futures.Future`` resolving to a list of numpy
        arrays (one per output, each ``(n, ...)``).

        ``inputs``: {name: array of shape ``(n,) + example_shape``}.
        ``deadline_ms``: budget from NOW (default
        ``config.default_deadline_ms``; 0 = none); a request that cannot
        start computing before its deadline resolves to
        :class:`RequestRejected`. ``rid``: the caller's trace id (the
        HTTP front end passes ``X-Request-Id``), generated when absent;
        it threads through the reqtrace spans, the slow-request ring and
        rejection errors.

        Raises :class:`RequestRejected` immediately when the engine is
        draining/closed, the deadline is already non-positive, or the
        queue is full (load shedding)."""
        arrays, n = self._validate(inputs)
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = None
        if deadline_ms:
            if deadline_ms <= 0:
                rid = reqtrace.clean_request_id(rid)
                self._reject("expired", rid=rid)
                raise RequestRejected(
                    "expired", "deadline_ms=%g already expired at submit"
                    % deadline_ms, rid=rid)
            deadline = time.monotonic() + deadline_ms / 1000.0
        req = _Request(arrays, n, deadline, rid=rid)
        # intake is gated under the condition lock so shutdown() can
        # flip _draining/_closed and flush the queue with the guarantee
        # that no request lands AFTER the flush
        status = None
        with self._cond:
            if self._draining or self._closed:
                status = "closed"
            else:
                try:
                    self._queue.put(req, block=False)
                    self._pending += 1
                except _queue.Full:
                    status = "shed"
        if status == "closed":
            self._reject("closed", rid=req.rid)
            raise RequestRejected("closed", "engine is shut down or "
                                            "draining", rid=req.rid)
        if status == "shed":
            self._reject("shed", rid=req.rid)
            raise RequestRejected(
                "shed", "queue full (%d requests waiting); retry with "
                "backoff" % self.config.max_queue, rid=req.rid)
        return req.future

    def predict(self, inputs, deadline_ms=None, timeout=None, rid=None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(inputs, deadline_ms=deadline_ms,
                           rid=rid).result(timeout)

    def drain(self, timeout=None):
        """Stop accepting new requests (they get ``status="closed"``)
        and wait until every queued/in-flight request has resolved.
        Returns True when fully drained within ``timeout``."""
        with self._cond:
            self._draining = True
            return self._cond.wait_for(lambda: self._pending == 0,
                                       timeout)

    def shutdown(self, drain=True, timeout=None):
        """Stop the engine. ``drain=True`` (default) serves out whatever
        is queued first; ``drain=False`` fails queued requests with
        ``status="closed"``. Idempotent; joins every engine thread.

        A second graceful call waits for the first to finish; a forced
        call (``drain=False``) racing a graceful one runs the bounded
        force sequence, the escape hatch for a wedged drain."""
        with self._cond:
            already = self._shutdown_started
            self._shutdown_started = True
            self._draining = True
            if not already:
                self._shutdown_owner = threading.current_thread()
        if already:
            if threading.current_thread() is self._shutdown_owner:
                # re-entrant call from a Future callback run inline by
                # this very shutdown: waiting would deadlock
                return
            if drain:
                self._shutdown_done.wait(timeout)
                return
            if self._shutdown_done.is_set():
                return
        try:
            if drain:
                self.drain(timeout)
            with self._cond:
                self._closed = True
            # submit() checks the flags under the same lock, so nothing
            # can enqueue after this point -- the flush below is complete
            if not drain:
                self._flush_queue()
            while True:
                try:
                    self._queue.put(_STOP, timeout=1)
                    break
                except _queue.Full:
                    # a drain that timed out leaves the queue full: those
                    # requests can never be served now
                    self._flush_queue()
            self._batcher.join(timeout=30)
            try:
                self._work.put(_STOP, timeout=30)
            except _queue.Full:
                logger.warning("serving: work queue still full at "
                               "shutdown; replica workers appear wedged")
            for rep in self._replicas:
                if rep.thread is not None:
                    rep.thread.join(timeout=30)
            # freeze the per-engine samplers at their last reading
            frozen = [telemetry.get_metric(name, engine=self._engine_label)
                      for name in ("serving_queue_depth",
                                   "serving_workers_alive",
                                   "serving_inflight_requests")]
            frozen += [telemetry.get_metric("serving_slo_burn_rate",
                                            engine=self._engine_label,
                                            window=str(w))
                       for w in self._slo.windows]
            for g in frozen:
                if g is not None:
                    g.set(g.read())
                    g.set_function(None)
        finally:
            self._shutdown_done.set()   # never leave a waiter wedged

    def _flush_queue(self):
        while True:
            try:
                req = self._queue.get_nowait()
            except _queue.Empty:
                return
            if req is _STOP:
                self._queue.put(_STOP)
                return
            self._resolve(req, exc=RequestRejected(
                "closed", "engine shut down before this request ran"),
                status="closed")

    def close(self):
        self.shutdown(drain=False)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.shutdown()

    def stats(self):
        """Live snapshot for health endpoints. ``queue_depth`` /
        ``pending`` / ``slo.burn_rate`` are the saturation signals a
        load balancer can act on before the drain flags flip; the
        memory-headroom triple (``headroom_bytes`` / ``peak_fraction``
        / ``admission_rejections_total``) is the capacity signal for
        placing the NEXT model. ``requests`` (this engine's counts by
        final status), ``padding`` (its pad ledger) and
        ``warmup_seconds`` complete it."""
        with self._cond:
            counts = dict(self._counts)
            pending = self._pending
        st = {
            "queue_depth": self._queue.qsize(),
            "pending": pending,
            "slo": self._slo.snapshot(),
            "workers_alive": self._workers_alive(),
            "replicas": len(self._replicas),
            "buckets": list(self._buckets),
            "warmup_compiles": self.warmup_compiles,
            "cold_compiles": self.cold_compiles(),
            "requests": counts,
            "padding": self._pad.snapshot(),
            "warmup_seconds": self.warmup_seconds,
            "draining": self._draining,
            "closed": self._closed,
        }
        try:
            st.update(memprof.health())
        except Exception as exc:
            telemetry.swallowed("serving.memprof_health", exc)
        return st

    @property
    def buckets(self):
        return list(self._buckets)

    # -- internals --------------------------------------------------------
    def _validate(self, inputs):
        names = set(self._example_shapes)
        got = set(inputs)
        if got != names:
            parts = []
            if names - got:
                parts.append("missing %s" % ", ".join(
                    map(repr, sorted(names - got))))
            if got - names:
                parts.append("unknown %s" % ", ".join(
                    map(repr, sorted(got - names))))
            raise MXNetError("bad request inputs (%s); declared inputs "
                             "are %s" % ("; ".join(parts), sorted(names)))
        arrays = {}
        n = None
        for name in sorted(names):
            arr = np.asarray(inputs[name], dtype=self._dtypes[name])
            want = self._example_shapes[name]
            if arr.ndim != len(want) + 1 or tuple(arr.shape[1:]) != want:
                raise MXNetError("input %r must be (n,) + %s, got %s"
                                 % (name, want, tuple(arr.shape)))
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise MXNetError(
                    "inconsistent row counts across inputs (%d vs %d)"
                    % (n, arr.shape[0]))
            arrays[name] = arr
        if n < 1:
            raise MXNetError("a request must carry at least one row")
        if n > self.config.max_batch_size:
            raise MXNetError(
                "request of %d rows exceeds max_batch_size=%d; split it "
                "client-side" % (n, self.config.max_batch_size))
        return arrays, n

    def _count(self, status):
        telemetry.counter("serving_requests_total",
                          help="serving requests by final status",
                          status=status).inc()

    def _reject(self, status, rid=None):
        """Account a request refused at submit: it never got a trace
        through the pipeline, but it still burns SLO budget and feeds
        the shed-heavy verdict."""
        with self._cond:
            self._counts[status] = self._counts.get(status, 0) + 1
        self._count(status)
        self._slo.record(False)
        reqtrace.tracer.note_reject(status)

    def _resolve(self, req, result=None, exc=None, status="ok"):
        # after this call the client can no longer cancel the Future
        if not req.future.set_running_or_notify_cancel():
            status = "cancelled"   # the client cancelled it while queued
        with self._cond:
            self._pending -= 1
            self._counts[status] = self._counts.get(status, 0) + 1
            self._cond.notify_all()
        # the request's clock stops HERE; latency, SLO and the trace's
        # respond phase share this boundary. Every account settles BEFORE
        # the client sees its result (whose done-callbacks run client
        # code inline), so a reading taken after a result includes it
        end = time.monotonic()
        if status == "ok":
            telemetry.histogram(
                "serving_total_seconds",
                help="submit-to-result latency of served requests"
            ).observe(end - req.enqueued)
        self._count(status)
        if status == "ok":
            self._slo.record(True, end - req.enqueued)
        elif status != "cancelled":   # a walked-away client is not an
            self._slo.record(False)   # availability failure of ours
        reqtrace.tracer.record(req.trace, end, status=status)
        if status == "cancelled":
            return
        if exc is not None:
            req.future.set_exception(exc)
        else:
            req.future.set_result(result)

    def _batch_loop(self):
        cfg = self.config
        carry = None
        stopping = False
        while not stopping or carry is not None:
            if carry is not None:
                req, carry = carry, None
            else:
                req = self._queue.get()
                if req is _STOP:
                    break
                req.trace.mark("picked")
            reqs, rows = [req], req.n
            t_close = time.monotonic() + cfg.max_batch_delay_ms / 1000.0
            while rows < cfg.max_batch_size and not stopping:
                left = t_close - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=left)
                except _queue.Empty:
                    break
                if nxt is _STOP:
                    stopping = True
                    break
                nxt.trace.mark("picked")
                if rows + nxt.n > cfg.max_batch_size:
                    carry = nxt   # head-of-line for the NEXT batch
                    break
                reqs.append(nxt)
                rows += nxt.n
            self._dispatch(reqs)

    def _expire(self, reqs, where, queue_wait=False):
        """Resolve the requests whose deadline passed; return the rest
        (observing each one's queue wait when ``queue_wait``)."""
        now = time.monotonic()
        live = []
        for req in reqs:
            if req.deadline is not None and now > req.deadline:
                self._resolve(req, exc=RequestRejected(
                    "expired", "deadline passed %s" % where, rid=req.rid),
                    status="expired")
            else:
                if queue_wait:
                    telemetry.histogram(
                        "serving_queue_wait_seconds",
                        help="submit-to-compute-start wait").observe(
                            now - req.enqueued)
                live.append(req)
        return live

    def _dispatch(self, reqs):
        live = self._expire(reqs, "while queued")
        if not live:
            return
        rows = sum(r.n for r in live)
        bucket = pick_bucket(rows, self._buckets)
        telemetry.histogram(
            "serving_batch_occupancy",
            help="real rows / bucket rows per dispatched batch "
                 "(1 - padding waste)").observe(rows / float(bucket))
        # bounded: blocks when every worker is busy, which keeps requests
        # in the request queue, which is what makes submit() shed -- the
        # backpressure chain ends at the client, not in hidden buffers
        self._work.put(_Batch(live, rows, bucket))

    def _worker_loop(self, rep):
        item = None
        try:
            while True:
                item = self._work.get()
                if item is _STOP:
                    self._work.put(_STOP)   # cascade to sibling workers
                    return
                self._run_batch(rep, item)
                item = None
        except BaseException as exc:   # noqa: BLE001 - crash isolation
            self._on_worker_death(rep, item, exc)

    def _run_batch(self, rep, batch):
        live = self._expire(batch.reqs, "before compute", queue_wait=True)
        if not live:
            return
        batch.reqs = live

        val = chaos.fire("serving.slow_request")
        if val is not None:
            time.sleep(0.5 if val is True else float(val))
        if chaos.fire("serving.worker_death") is not None:
            raise _WorkerDeath("chaos: injected serving worker death")

        # the anatomy boundaries: batch_wait ends (and pad begins) here,
        # so chaos stalls and the deadline sweep above land in
        # batch_wait, and the remaining marks telescope to resolve
        bid = next(self._batch_seq)
        rows = sum(r.n for r in live)
        reqtrace.tracer.note_batch(rows, batch.bucket)
        t_pad = time.monotonic()
        for req in live:
            req.trace.bucket = batch.bucket
            req.trace.batch = bid
            req.trace.mark("pad_start", t_pad)
        t0 = time.perf_counter()
        batch_span = telemetry.span(
            "serving.batch", batch=bid, bucket=batch.bucket, rows=rows,
            replica=rep.index, rids=[r.rid for r in live])
        try:
            with batch_span:
                pred = rep.preds[batch.bucket]
                feed = {}
                for name in self._example_shapes:
                    parts = [r.inputs[name] for r in live]
                    arr = parts[0] if len(parts) == 1 \
                        else np.concatenate(parts)
                    feed[name] = pad_rows(arr, batch.bucket)
                t_fwd = time.monotonic()       # pad done
                pred.forward(**feed)
                t_disp = time.monotonic()      # the forward returned
                outs = [pred.get_output(i) for i in range(self.num_outputs)]
                t_out = time.monotonic()       # outputs read back
        except Exception as exc:   # the batch fails; the worker goes on
            logger.exception("serving: batch of %d rows failed on "
                             "replica %d", rows, rep.index)
            for req in live:
                self._resolve(req, exc=exc, status="error")
            return
        telemetry.histogram(
            "serving_compute_seconds",
            help="device compute wall time per batch").observe(
                time.perf_counter() - t0)
        telemetry.counter("serving_batches_total",
                          help="dispatched micro-batches by bucket",
                          bucket=str(batch.bucket)).inc()
        # memory anatomy: batch completion is the serving-side timeline
        # sample point (throttled inside memprof; after the readback, so
        # the sample sees the batch's buffers at their live peak)
        try:
            memprof.sample("serving.batch")
        except Exception as exc:
            telemetry.swallowed("serving.memprof", exc)
        self._pad.note(rows, batch.bucket)
        splits = [split_rows(o, [r.n for r in live]) for o in outs]
        t_split = time.monotonic()
        for req in live:
            req.trace.mark("pad_end", t_fwd)
            req.trace.mark("forward_end", t_disp)
            req.trace.mark("outputs_end", t_out)
            req.trace.mark("split_end", t_split)
        for i, req in enumerate(live):
            self._resolve(req, result=[s[i] for s in splits])

    def _on_worker_death(self, rep, item, exc):
        """A replica worker thread died (chaos or a real bug): fail ONLY
        the in-flight batch, leave a post-mortem, respawn."""
        rep.deaths += 1
        logger.error("serving: replica %d worker died (%r); failing the "
                     "in-flight batch and respawning", rep.index, exc)
        telemetry.counter("serving_worker_deaths_total",
                          help="serving replica worker thread deaths",
                          replica=str(rep.index)).inc()
        if item is not None and item is not _STOP:
            err = MXNetError(
                "serving replica %d worker died mid-batch: %r"
                % (rep.index, exc))
            for req in item.reqs:
                if not req.future.done():
                    self._resolve(req, exc=err, status="error")
        telemetry.event("serving.worker_death", replica=rep.index,
                        error=repr(exc), deaths=rep.deaths)
        xla_stats.dump_flight_recorder("serving.worker_death",
                                       error=repr(exc))
        if not self._closed:
            # count BEFORE starting the thread: the replacement serves
            # the moment start() returns, and a scraper must never see a
            # respawned worker with a zero respawn counter
            telemetry.counter(
                "serving_worker_respawns_total",
                help="serving replica workers respawned after a "
                     "death").inc()
            self._spawn_worker(rep)
