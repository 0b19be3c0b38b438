"""Run anatomy: the goodput/badput ledger, training-health sentinels and
run-timeline reports.

Counterpart of `mxnet_tpu/runprof.py`, with the same states, metric
names and report keys. Three pieces:

1. **Goodput/badput ledger**: every second of run wall-clock lands in
   exactly one state of a fixed taxonomy:

       init                process start until the first train step
                           minus explicit states
       compile             signature compiles of `compiled.
                           CompiledProgram` (on the card a CUDA graph
                           capture, its warm-up runs included)
       train_productive    train-step wall that moved the model forward
                           (step wall minus its input stall and any
                           compile it paid)
       checkpoint_save     checkpoint writes
       checkpoint_restore  checkpoint reads
       recovery            failure handling
       input_stall         iterator-blocked time inside train steps
                           (stepprof's ``data_wait``)
       idle                residual wall after training started that no
                           state tiled (eval, logging, the gap between
                           fit calls)

   ``init`` and ``idle`` are derived, so the eight states tile the run
   wall exactly. Exported as ``run_state_seconds{state=}`` counters and
   a ``run_goodput_fraction`` gauge (productive / wall); noted states
   also emit ``run.<state>`` JSONL spans through `telemetry.record_span`.
   :func:`note_progress` and :func:`note_resume` price the work a
   resumed run repeats (``run_lost_steps_total`` /
   ``run_lost_work_seconds``).

2. **Training-health sentinels**:

   - sampled non-finite checks on loss and metric values
     (:func:`observe_metrics`, fed every ``MXNET_RUNPROF_CHECK_EVERY``-th
     batch by ``Module.fit``) and on the global gradient norm
     (`gluon.utils.clip_global_norm`);
   - a step-time spike detector (a step slower than
     ``MXNET_RUNPROF_SPIKE_FACTOR`` x the rolling median);
   - a loss plateau / divergence heuristic;
   - memprof's leak sentinel books its trips here as
     ``kind="memory_leak"`` and `monitor.Monitor` its non-finite stats
     as ``kind="nonfinite_tensor"``.

   Every trip bumps ``run_anomalies_total{kind=}``, appends to the
   bounded anomaly log, emits a ``run.anomaly`` event and dumps the
   flight recorder (throttled per kind). ``MXNET_RUNPROF_HALT=1`` also
   raises :class:`RunHealthError` at the check site.

3. **Run-timeline reports**: per-host
   ``runprof_i<r>_host<h>_pid<p>.json`` snapshots on the shared
   `telemetry.write_host_json` transport, merged by
   ``python -m mxnet_tpu_torch.runprof report [path|dir]`` into a
   goodput waterfall, the anomaly log, lost-work badput and per-host
   goodput skew. A telemetry dir is a one-run artifact directory.

Recording is always on (``MXNET_RUNPROF=0`` kills it) and host-side
only: it adds no capture (``compiled.compile_counts()`` is unchanged).
Stdlib + telemetry only at import; `xla_stats` (the flight recorder) is
imported at dump time.

Lock order: this module has one lock (the ledger ``_lock``); it never
calls telemetry while holding it. Telemetry's registry lock is
innermost of all.
"""
from __future__ import annotations

import atexit
import json
import math
import os
import threading
import time
from collections import deque

from . import telemetry

__all__ = ["RUN_STATES", "DERIVED_STATES", "RunLedger", "RunHealthError",
           "ledger", "enabled", "note_state", "note_step",
           "note_progress", "flush_progress", "note_resume",
           "note_anomaly",
           "observe_metric", "observe_metrics", "should_check",
           "check_every", "halt_enabled", "state_seconds",
           "goodput_fraction", "snapshot", "reset",
           "write_host_snapshot", "merge_host_snapshots",
           "aggregate", "goodput_by_host", "classify", "report", "main"]

#: The fixed run-state taxonomy. Order is display order (waterfall).
RUN_STATES = ("init", "compile", "train_productive", "checkpoint_save",
              "checkpoint_restore", "recovery", "input_stall", "idle")

#: States derived from the residual (never fed by :func:`note_state`).
DERIVED_STATES = ("init", "idle")

_EXPLICIT = tuple(s for s in RUN_STATES if s not in DERIVED_STATES)

#: goodput at or above this fraction reads "healthy" regardless of
#: which badput state dominates the (small) remainder
HEALTHY_GOODPUT = 0.9

#: verdict hints, one per badput state
HINTS = {
    "healthy":
        "goodput is at target; keep the bench_gate floor and watch "
        "run_anomalies_total",
    "init-heavy":
        "startup dominates: overlap data/setup with the first compile, "
        "persist preprocessed inputs, or amortize with longer runs",
    "compile-heavy":
        "captures dominate: bucket input shapes (see "
        "xla_stats.last_retrace()), warm signatures ahead of time "
        "(CompiledProgram.warmup), raise fit(batches_per_dispatch=K) so "
        "fewer programs exist",
    "checkpoint-heavy":
        "checkpoint I/O dominates: lengthen the save period, shrink "
        "keep_last, or move the checkpoint dir off slow storage — the "
        "save span histograms name the cost per save",
    "recovery-heavy":
        "restart badput dominates: checkpoint more often (lost work "
        "shrinks with the save period), fix the flapping peer "
        "(straggler_host / dist_dead_nodes), raise backoff caps only "
        "after the root cause",
    "input-bound":
        "the iterator starves training: deepen io.PrefetchingIter, "
        "shard the input pipeline per host; "
        "stepprof report attributes the stall inside the step",
    "idle-heavy":
        "wall time is leaking between train steps (eval loops, "
        "logging, host-side bookkeeping): overlap eval with training "
        "or shrink the non-train work between fit calls",
    "unknown":
        "no run-state data recorded: train through Module.fit / "
        "gluon Trainer, or feed the ledger with "
        "runprof.note_step()",
}

#: badput state -> verdict name (train_productive never appears here)
_STATE_VERDICT = {
    "init": "init-heavy",
    "compile": "compile-heavy",
    "checkpoint_save": "checkpoint-heavy",
    "checkpoint_restore": "checkpoint-heavy",
    "recovery": "recovery-heavy",
    "input_stall": "input-bound",
    "idle": "idle-heavy",
}


class RunHealthError(RuntimeError):
    """A training-health sentinel tripped while MXNET_RUNPROF_HALT=1."""


_env_int = telemetry.env_int
_env_float = telemetry.env_float


def enabled():
    """Whether run-state recording is armed (``MXNET_RUNPROF``, default
    on). Off, every ``note_*`` entry point is a cheap no-op."""
    return os.environ.get("MXNET_RUNPROF", "1") != "0"


def halt_enabled():
    """Whether a sentinel trip stops the run (``MXNET_RUNPROF_HALT``,
    default off: count + dump only)."""
    return os.environ.get("MXNET_RUNPROF_HALT", "0") not in ("0", "")


def check_every():
    """Sampling period of the fit-loop metric sentinel
    (``MXNET_RUNPROF_CHECK_EVERY`` batches, default 16; 0 disables)."""
    return _env_int("MXNET_RUNPROF_CHECK_EVERY", 16)


#: loss-like metric names the plateau/divergence heuristic tracks
_LOSS_NAMES = ("mse", "rmse", "ce", "nll", "perplexity", "mae")


def _loss_like(name):
    name = str(name).lower()
    return "loss" in name or name in _LOSS_NAMES


class RunLedger:
    """Process-wide run-state accumulator behind the module-level API
    (tests may instantiate their own — a private instance never touches
    the progress-marker files or the exporter thread)."""

    #: spike detector needs at least this many prior steps before it
    #: may accuse one
    SPIKE_MIN_STEPS = 8
    #: divergence: recent loss mean at or past this multiple of the
    #: window minimum
    DIVERGE_FACTOR = 2.0
    #: plateau: full-window loss spread under this fraction of |mean|
    PLATEAU_RTOL = 1e-3
    #: flight-recorder dumps per anomaly kind are throttled to one per
    #: this many seconds
    DUMP_COOLDOWN = 60.0

    def __init__(self, window=None):
        if window is None:
            window = _env_int("MXNET_RUNPROF_WINDOW", 256)
        window = max(16, int(window))
        self._lock = threading.Lock()
        self._start_mono = time.monotonic()
        self._start_wall = time.time()
        self._states = {s: 0.0 for s in _EXPLICIT}
        self._published = {}        # derived state -> counter-pushed secs
        self._first_train_mono = None
        self._pre_train_sum = 0.0   # explicit seconds before first train
        self._steps = 0
        self._window = window
        self._walls = deque(maxlen=window)   # per-dispatch step walls
        self._loss = {}   # metric name -> deque (bounded name count)
        self._anomalies = deque(maxlen=64)
        self._anomaly_counts = {}
        self._progress_step = None
        self._progress_scope = None
        self._avg_step_seconds = None
        self._resumed_from = None
        self._lost_steps = 0
        self._lost_seconds = 0.0
        self._compile_at_step = 0.0
        self._check_counter = 0
        self._last_dump = {}        # anomaly kind -> mono of last dump
        self._last_progress_write = 0.0
        self._export_thread = None

    # -- ledger feeding ---------------------------------------------------

    def note_state(self, state, seconds, span=True, **attrs):
        """Account ``seconds`` of run wall to ``state`` (explicit states
        only — ``init``/``idle`` are derived). When ``span`` is true the
        note also lands as a retrospective ``run.<state>`` JSONL span in
        the chrome-trace timeline."""
        if state not in self._states:
            raise ValueError("state %r is not an explicit run state "
                             "(taxonomy: %s; derived: %s)"
                             % (state, ", ".join(_EXPLICIT),
                                ", ".join(DERIVED_STATES)))
        if not enabled():
            return
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._states[state] += seconds
            if self._first_train_mono is None:
                self._pre_train_sum += seconds
        telemetry.counter(
            "run_state_seconds",
            help="run wall-clock seconds by run-state taxonomy",
            state=state).inc(seconds)
        if span and seconds > 0:
            telemetry.record_span("run." + state, time.time() - seconds,
                                  seconds, **attrs)
        self._maybe_export()

    def note_step(self, phases, wall, batches=1):
        """Fold one completed train step into the ledger: its
        ``data_wait`` becomes ``input_stall``, compile time it paid
        (tracked via the ``compile`` state's growth since the previous
        step) is carved out, and the remainder is
        ``train_productive``. Also feeds the step-time spike sentinel.
        `stepprof` calls this for every recorded step; loop-owned
        trainers call it directly."""
        if not enabled():
            return
        wall = max(0.0, float(wall))
        stall = max(0.0, float((phases or {}).get("data_wait", 0.0)))
        with self._lock:
            compile_delta = self._states["compile"] - self._compile_at_step
            self._compile_at_step = self._states["compile"]
            compile_in = min(max(compile_delta, 0.0),
                             max(wall - stall, 0.0))
            if self._first_train_mono is None:
                # training started when this step STARTED, so the
                # derived init residual stops at the step's front edge —
                # and the compile this step paid happened AFTER that
                # edge, so it must leave the pre-train sum (else a long
                # first-step compile deflates init and misfiles the
                # startup period as idle)
                self._first_train_mono = time.monotonic() - wall
                self._pre_train_sum = max(
                    0.0, self._pre_train_sum - compile_in)
            prior = list(self._walls)
            per_dispatch = wall / max(1, int(batches)) \
                if int(batches) > 1 else wall
            self._walls.append(per_dispatch)
            self._steps += 1
        if stall > 0:
            self.note_state("input_stall", stall, span=False)
        self.note_state("train_productive",
                        max(0.0, wall - stall - compile_in), span=False)
        if len(prior) >= self.SPIKE_MIN_STEPS:
            med = sorted(prior)[len(prior) // 2]
            factor = _env_float("MXNET_RUNPROF_SPIKE_FACTOR", 4.0)
            if med > 0 and factor > 0 and per_dispatch > factor * med:
                self.note_anomaly(
                    "step_time_spike", value=per_dispatch,
                    detail="step wall %.4fs > %.1fx rolling median %.4fs"
                           % (per_dispatch, factor, med))

    def state_seconds(self, state=None):
        """Cumulative seconds of one explicit state, or a copy of the
        whole explicit-state dict."""
        with self._lock:
            if state is None:
                return dict(self._states)
            return self._states.get(state, 0.0)

    # -- derived states / goodput -----------------------------------------

    def _derived(self):
        """(run_wall, init, idle) — the residual split around the first
        train step, clamped so every figure stays non-negative."""
        with self._lock:
            wall = time.monotonic() - self._start_mono
            explicit = sum(self._states.values())
            first = self._first_train_mono
            pre = self._pre_train_sum
        if first is None:
            return wall, max(0.0, wall - explicit), 0.0
        init = max(0.0, min((first - self._start_mono) - pre, wall))
        return wall, init, max(0.0, wall - explicit - init)

    def goodput_fraction(self):
        """``train_productive / run_wall`` (0.0 before any wall
        elapsed)."""
        wall, _init, _idle = self._derived()
        if wall <= 0:
            return 0.0
        return min(1.0, self.state_seconds("train_productive") / wall)

    def _publish_derived(self, init, idle):
        """Monotonically advance the derived-state counters (clamped:
        a shrinking residual never decrements a counter). Deltas are
        computed under the ledger lock, counter pushes outside it."""
        incs = []
        with self._lock:
            for state, val in (("init", init), ("idle", idle)):
                prev = self._published.get(state, 0.0)
                if val > prev:
                    incs.append((state, val - prev))
                    self._published[state] = val
        for state, delta in incs:
            telemetry.counter(
                "run_state_seconds",
                help="run wall-clock seconds by run-state taxonomy",
                state=state).inc(delta)

    # -- progress / lost work ---------------------------------------------

    def note_progress(self, step, step_seconds=None, scope=None):
        """Advance the high-water progress marker (monotonic: a resume
        below the previous high never lowers it) and, while a telemetry
        dir is configured, persist it per host (throttled) so the NEXT
        incarnation can price the work this one loses if it dies.

        ``step_seconds`` must be in the SAME unit as ``step`` (seconds
        per whatever one progress increment is — a raw step for
        `ElasticTrainer`, an epoch for ``fit(elastic=...)``); without it
        the marker's mean stays unknown and a later resume counts lost
        steps but prices them at zero, which beats pricing them in the
        wrong unit. ``scope`` names the logical run (the checkpoint
        root for the elastic callers): :func:`note_resume` only reads
        markers of ITS scope, so a later, unrelated run sharing the
        telemetry dir cannot read this run's marker as phantom loss."""
        if not enabled():
            return
        step = int(step)
        with self._lock:
            self._progress_step = max(step, self._progress_step or 0)
            if scope is not None:
                self._progress_scope = str(scope)
            if step_seconds is not None and step_seconds > 0:
                avg = self._avg_step_seconds
                self._avg_step_seconds = float(step_seconds) if avg is None \
                    else 0.8 * avg + 0.2 * float(step_seconds)
            now = time.monotonic()
            stale = now - self._last_progress_write >= 0.2
            if stale:
                self._last_progress_write = now
        if stale:
            # a deliberate synchronous write on the calling thread: the
            # marker IS crash evidence, so it must be durable before
            # the step that can die — the cost (one ~100-byte atomic
            # write per >=0.2s) is the same class as the per-event
            # JSONL flushes telemetry already pays on this thread when
            # the dir is armed; the 2s exporter thread would leave the
            # marker too stale to price a fast-stepping crash
            self.flush_progress()
        self._maybe_export()

    def flush_progress(self, dir=None):
        """Persist the current progress marker NOW, unthrottled (the
        atexit path: a clean exit must not leave a marker up to one
        throttle window stale — staleness only ever UNDER-prices lost
        work, but fresh is free here). Only the PROCESS ledger owns the
        on-disk marker — a test instance must not clobber the run's
        crash evidence."""
        with self._lock:
            if self._progress_step is None:
                return None
            doc = {"step": self._progress_step,
                   "avg_step_seconds": self._avg_step_seconds,
                   "scope": self._progress_scope,
                   "updated": time.time()}
        if self is not ledger:
            return None
        try:
            return telemetry.write_host_json("runprof_progress", doc,
                                             dir=dir)
        except Exception as exc:
            telemetry.swallowed("runprof.progress_write", exc)
            return None

    @staticmethod
    def _read_progress(dir=None, consume=False, scope=None):
        """Highest-step progress marker any incarnation of THIS host
        left under ``dir`` (default: the configured telemetry dir), or
        None. Markers of a DIFFERENT scope (another run's checkpoint
        root sharing the telemetry dir) are ignored and left alone; a
        scopeless marker matches any scope (pre-scope back-compat).
        ``consume=True`` deletes the matched markers after reading: a
        loss span must be booked ONCE, at the resume that detects it —
        a later resume re-reading the same marker would double-count
        work a previous resume already re-priced."""
        dir = dir or telemetry.configured_dir() \
            or os.environ.get("MXNET_TELEMETRY_DIR")
        if not dir or not os.path.isdir(dir):
            return None
        prefix = "runprof_progress_host%d_pid" % telemetry.host_id()
        best = None
        paths = []
        for fn in sorted(os.listdir(dir)):
            if not (fn.startswith(prefix) and fn.endswith(".json")):
                continue
            path = os.path.join(dir, fn)
            try:
                with open(path, encoding="utf-8") as fh:
                    doc = json.load(fh)
                step = int(doc.get("step"))
            except (OSError, ValueError, TypeError):
                paths.append(path)   # torn marker: still reapable
                continue
            mscope = doc.get("scope")
            if scope is not None and mscope is not None and \
                    str(scope) != str(mscope):
                continue   # another run's marker: not ours to read
            paths.append(path)
            if best is None or step > best.get("step", -1):
                best = doc
        if consume:
            for path in paths:
                try:
                    os.remove(path)
                except OSError as exc:   # already reaped by a peer scan
                    telemetry.swallowed("runprof.progress_consume", exc)
        return best

    def note_resume(self, step, dir=None, scope=None):
        """Record that the run resumed from checkpoint ``step`` and
        book the lost work: the steps between the marker the previous
        incarnation left and the checkpoint are re-executed, so they
        cost ``lost_steps x avg_step_seconds`` of badput. ``scope``
        restricts the marker scan to this run's own markers (see
        :func:`note_progress`). Returns the lost step count."""
        if not enabled():
            return 0
        step = int(step)
        doc = self._read_progress(dir, consume=self is ledger,
                                  scope=scope)
        lost, lost_seconds = 0, 0.0
        if doc is not None and doc.get("step", 0) > step:
            lost = int(doc["step"]) - step
            avg = doc.get("avg_step_seconds") or 0.0
            lost_seconds = lost * max(0.0, float(avg))
        with self._lock:
            self._resumed_from = step
            # progress restarts from the checkpoint: keeping the old
            # high-water in memory would re-persist the dead crash
            # point and double-book the same loss on the NEXT recovery
            self._progress_step = step
            if lost:
                self._lost_steps += lost
                self._lost_seconds += lost_seconds
        if lost:
            telemetry.counter(
                "run_lost_steps_total",
                help="train steps re-executed after restarts (work "
                     "between the restored checkpoint and the crash "
                     "point)").inc(lost)
            if lost_seconds > 0:
                telemetry.counter(
                    "run_lost_work_seconds",
                    help="estimated wall seconds of re-executed steps "
                         "after restarts").inc(lost_seconds)
            telemetry.event("run.lost_work", steps=lost,
                            seconds=lost_seconds, resumed_from=step,
                            crashed_at=doc.get("step"))
        return lost

    # -- sentinels ---------------------------------------------------------

    def note_anomaly(self, kind, detail=None, value=None, dump=True):
        """Trip a training-health sentinel: count it
        (``run_anomalies_total{kind=}``), log it into the bounded
        anomaly ring + a ``run.anomaly`` event, dump the flight
        recorder (throttled per kind), and — under
        ``MXNET_RUNPROF_HALT=1`` — raise :class:`RunHealthError`."""
        if not enabled():
            return
        kind = str(kind)
        telemetry.counter("run_anomalies_total",
                          help="training-health sentinel trips by kind",
                          kind=kind).inc()
        rec = {"kind": kind, "detail": detail, "time": time.time()}
        if value is not None:
            try:
                v = float(value)
                # a non-finite float would serialize as the invalid-
                # JSON `NaN` token and break strict trace/snapshot
                # consumers — exactly on the NaN runs being post-
                # mortemed — so it rides as a string
                rec["value"] = v if math.isfinite(v) else str(value)
            except (TypeError, ValueError):
                rec["value"] = str(value)
        with self._lock:
            self._anomalies.append(rec)
            self._anomaly_counts[kind] = \
                self._anomaly_counts.get(kind, 0) + 1
        telemetry.event("run.anomaly", kind=kind, detail=detail,
                        value=rec.get("value"))
        if dump and self._should_dump(kind):
            try:
                from . import xla_stats
                xla_stats.dump_flight_recorder(
                    "runprof." + kind,
                    error=detail or "sentinel %s tripped" % kind)
            except Exception as exc:  # a dump must never mask the trip
                telemetry.swallowed("runprof.dump", exc)
        if halt_enabled():
            raise RunHealthError(
                "training-health sentinel tripped: %s%s "
                "(MXNET_RUNPROF_HALT=1 stops the run; unset it to only "
                "count and dump)"
                % (kind, " — " + detail if detail else ""))

    def _should_dump(self, kind):
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(kind)
            if last is not None and now - last < self.DUMP_COOLDOWN:
                return False
            self._last_dump[kind] = now
        return True

    def should_check(self):
        """True on every ``MXNET_RUNPROF_CHECK_EVERY``-th call — the
        sampler the fit loop gates its metric sweep on."""
        if not enabled():
            return False
        n = check_every()
        if n <= 0:
            return False
        with self._lock:
            self._check_counter += 1
            return self._check_counter % n == 0

    def observe_metric(self, name, value):
        """Health-check one (metric name, value) sample: a non-finite
        value trips the non-finite sentinel; finite loss-like values
        feed the plateau/divergence window."""
        if not enabled():
            return
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if not math.isfinite(v):
            self.note_anomaly(
                "nonfinite_loss" if _loss_like(name) else
                "nonfinite_metric",
                detail="%s=%r" % (name, value), value=v)
            return
        if _loss_like(name):
            self._track_loss(str(name), v)

    def observe_metrics(self, pairs):
        """:func:`observe_metric` over ``[(name, value), ...]`` (the
        shape ``EvalMetric.get_name_value()`` returns)."""
        for name, value in pairs or ():
            self.observe_metric(name, value)

    def _track_loss(self, name, v):
        # one window PER metric name: pooling two loss-like metrics of
        # different scales (nll ~2 and perplexity ~10, say) would read
        # their interleaving as a divergence on a healthy run
        with self._lock:
            win = self._loss.get(name)
            if win is None:
                if len(self._loss) >= 8:   # bounded name count
                    return
                win = self._loss[name] = deque(maxlen=self._window)
            win.append(v)
            if len(win) < win.maxlen:
                return
            xs = list(win)
            win.clear()   # full window consumed; fresh cooldown
        n = len(xs)
        best = min(xs)
        recent = sum(xs[-(n // 4):]) / max(1, n // 4)
        spread = max(xs) - best
        mean = sum(xs) / n
        if best > 0 and recent >= self.DIVERGE_FACTOR * best and \
                xs.index(best) < n // 2:
            self.note_anomaly(
                "loss_divergence", value=recent,
                detail="%s: recent mean %.4g >= %.1fx window best %.4g"
                       % (name, recent, self.DIVERGE_FACTOR, best))
        elif spread <= self.PLATEAU_RTOL * max(abs(mean), 1e-12):
            self.note_anomaly(
                "loss_plateau", value=mean,
                detail="%s flat at %.4g over %d samples (spread %.2g)"
                       % (name, mean, n, spread))

    # -- views / export ----------------------------------------------------

    def snapshot(self):
        """One JSON-able view: identity, the full eight-state ledger
        (derived states published to their counters as a side effect),
        goodput, progress/lost-work, and the anomaly log."""
        wall, init, idle = self._derived()
        if self is ledger:
            self._publish_derived(init, idle)
        with self._lock:
            states = dict(self._states)
            doc = {
                "host": telemetry.host_id(), "pid": os.getpid(),
                "updated": time.time(),
                "incarnation": _env_int("MXNET_ELASTIC_RESTART", 0),
                "run_wall_seconds": wall,
                "steps": self._steps,
                "progress_step": self._progress_step,
                "resumed_from": self._resumed_from,
                "lost_steps": self._lost_steps,
                "lost_work_seconds": self._lost_seconds,
                "anomaly_counts": dict(self._anomaly_counts),
                "anomalies": list(self._anomalies)[-16:],
            }
        states["init"] = init
        states["idle"] = idle
        doc["states"] = {s: states[s] for s in RUN_STATES}
        doc["goodput_fraction"] = \
            min(1.0, states["train_productive"] / wall) if wall > 0 else 0.0
        if self is ledger:
            # only the PROCESS ledger publishes to the registry — a
            # private instance's snapshot must not add phantom derived
            # seconds or clobber the run's goodput gauge
            g = telemetry.gauge(
                "run_goodput_fraction",
                help="fraction of run wall-clock spent in productive "
                     "train steps")
            g.set(doc["goodput_fraction"])
            g.set_function(self.goodput_fraction)   # scrape-time fresh
        return doc

    def reset(self):
        """Re-zero the ledger and restart its wall clock (tests, and
        bench attribution windows). Registry counters are NOT touched —
        pair with ``telemetry.reset()``."""
        with self._lock:
            self._start_mono = time.monotonic()
            self._start_wall = time.time()
            for s in self._states:
                self._states[s] = 0.0
            self._published = {}
            self._first_train_mono = None
            self._pre_train_sum = 0.0
            self._steps = 0
            self._walls.clear()
            self._loss.clear()
            self._anomalies.clear()
            self._anomaly_counts.clear()
            self._progress_step = None
            self._progress_scope = None
            self._avg_step_seconds = None
            self._resumed_from = None
            self._lost_steps = 0
            self._lost_seconds = 0.0
            self._compile_at_step = 0.0
            self._check_counter = 0
            self._last_dump.clear()
            self._last_progress_write = 0.0

    def write_host_snapshot(self, dir=None, force=False):
        """Write this process's ``runprof_host<h>_pid<p>.json`` via the
        shared `telemetry.write_host_json` transport (no-op without a
        destination; ``force`` writes even before any state was
        recorded)."""
        if not force:
            with self._lock:
                empty = self._steps == 0 and \
                    not any(self._states.values())
            if empty:
                return None
        # the incarnation rides in the filename: a relaunched container
        # often reuses the crashed one's pid (k8s pid 1), and the
        # crashed incarnation's snapshot must survive the relaunch
        return telemetry.write_host_json(
            "runprof_i%d" % _env_int("MXNET_ELASTIC_RESTART", 0),
            self.snapshot(), dir=dir)

    def _maybe_export(self):
        """Start the background snapshot exporter on first use while a
        telemetry dir is configured (process ledger only) — file I/O
        belongs on its own thread, never inside the loop being
        measured."""
        if self is not ledger or telemetry.configured_dir() is None:
            return
        with self._lock:
            if self._export_thread is not None:
                return
            t = threading.Thread(target=self._export_loop, daemon=True,
                                 name="mxnet_tpu_torch-runprof-export")
            self._export_thread = t
        t.start()

    def _export_loop(self):
        while True:
            time.sleep(2.0)
            if telemetry.configured_dir() is None:
                continue   # dir unconfigured mid-run: idle, not dead
            try:
                self.write_host_snapshot()
            except Exception as exc:
                telemetry.swallowed("runprof.export", exc)


# Register the taxonomy's counter series at import so every process
# exposes them (as zeros) in Prometheus snapshots, whether or not a
# state was ever recorded (the xla_stats compile-counter pattern).
for _state in RUN_STATES:
    telemetry.counter("run_state_seconds",
                      help="run wall-clock seconds by run-state taxonomy",
                      state=_state)
del _state

#: the process ledger behind the module-level facade
ledger = RunLedger()


def _atexit_snapshot():
    try:
        ledger.flush_progress()
        ledger.write_host_snapshot()
    except Exception as exc:
        telemetry.swallowed("runprof.atexit", exc)


atexit.register(_atexit_snapshot)


# ---------------------------------------------------------------------------
# Module-level facade over the process ledger
# ---------------------------------------------------------------------------

def note_state(state, seconds, span=True, **attrs):
    ledger.note_state(state, seconds, span=span, **attrs)


def note_step(phases, wall, batches=1):
    ledger.note_step(phases, wall, batches=batches)


def note_progress(step, step_seconds=None, scope=None):
    ledger.note_progress(step, step_seconds=step_seconds, scope=scope)


def flush_progress(dir=None):
    return ledger.flush_progress(dir=dir)


def note_resume(step, dir=None, scope=None):
    return ledger.note_resume(step, dir=dir, scope=scope)


def note_anomaly(kind, detail=None, value=None, dump=True):
    ledger.note_anomaly(kind, detail=detail, value=value, dump=dump)


def observe_metric(name, value):
    ledger.observe_metric(name, value)


def observe_metrics(pairs):
    ledger.observe_metrics(pairs)


def should_check():
    return ledger.should_check()


def state_seconds(state=None):
    return ledger.state_seconds(state)


def goodput_fraction():
    return ledger.goodput_fraction()


def snapshot():
    return ledger.snapshot()


def reset():
    ledger.reset()


def write_host_snapshot(dir=None, force=False):
    return ledger.write_host_snapshot(dir=dir, force=force)


# ---------------------------------------------------------------------------
# Cross-host / cross-incarnation merge
# ---------------------------------------------------------------------------

def merge_host_snapshots(dir=None):
    """Every ``runprof*_host*.json`` snapshot under ``dir`` (default:
    the configured telemetry dir, then ``MXNET_TELEMETRY_DIR``) as
    ``{(host, pid, incarnation): doc}`` — EVERY incarnation is kept
    (unlike `telemetry.merge_host_json`'s freshest-per-host), because a
    restarted run's badput lives across incarnations; the incarnation
    in the key (and the ``runprof_i<r>`` filename) keeps a relaunched
    container that reuses the crashed one's pid from collapsing it."""
    dir = dir or telemetry.configured_dir() \
        or os.environ.get("MXNET_TELEMETRY_DIR")
    if not dir or not os.path.isdir(dir):
        return {}
    out = {}
    for fn in sorted(os.listdir(dir)):
        if not (fn.startswith("runprof") and fn.endswith(".json")
                and "_host" in fn
                and not fn.startswith("runprof_progress")):
            continue
        try:
            with open(os.path.join(dir, fn), encoding="utf-8") as fh:
                doc = json.load(fh)
            key = (int(doc.get("host", 0)), int(doc.get("pid", 0)),
                   int(doc.get("incarnation", 0) or 0))
        except (OSError, ValueError, TypeError):
            continue   # torn snapshot from a killed writer
        prev = out.get(key)
        if prev is None or doc.get("updated", 0) > prev.get("updated", 0):
            out[key] = doc
    return out


def _is_training_doc(doc):
    """Whether a snapshot came from a process that actually trained.
    Non-training processes (the launched-run supervisor, a report-only
    shell) contribute their EXPLICIT badput (recovery, checkpoint I/O)
    to a merged view but not their wall or derived init/idle — a
    launcher that sat in `supervise()` for the whole run would
    otherwise read as a giant init share and drag merged goodput into
    an `init-heavy` misdirection."""
    return int(doc.get("steps", 0) or 0) > 0


def aggregate(docs):
    """Fold per-(host, pid, incarnation) snapshots into one run view:
    states and lost work summed, anomaly counts merged, goodput
    recomputed over the summed TRAINING wall (see
    :func:`_is_training_doc` for how non-training snapshots fold in)."""
    docs = list(docs)
    states = {s: 0.0 for s in RUN_STATES}
    wall = 0.0
    lost_steps = 0
    lost_seconds = 0.0
    counts = {}
    anomalies = []
    for doc in docs:
        training = _is_training_doc(doc)
        for s, v in (doc.get("states") or {}).items():
            if s in states and isinstance(v, (int, float)) and \
                    (training or s not in DERIVED_STATES):
                states[s] += float(v)
        if training:
            wall += float(doc.get("run_wall_seconds", 0.0) or 0.0)
        lost_steps += int(doc.get("lost_steps", 0) or 0)
        lost_seconds += float(doc.get("lost_work_seconds", 0.0) or 0.0)
        for k, n in (doc.get("anomaly_counts") or {}).items():
            counts[k] = counts.get(k, 0) + int(n)
        anomalies.extend(doc.get("anomalies") or [])
    anomalies.sort(key=lambda a: a.get("time", 0.0))
    return {"states": states, "run_wall_seconds": wall,
            "goodput_fraction": (states["train_productive"] / wall)
            if wall > 0 else 0.0,
            "lost_steps": lost_steps, "lost_work_seconds": lost_seconds,
            "anomaly_counts": counts, "anomalies": anomalies[-16:],
            "snapshots": len(docs)}


def goodput_by_host(merged):
    """Per-host goodput over every incarnation of that host, plus the
    max-min skew (published as the ``run_goodput_skew`` gauge). Returns
    ``{"hosts": {host: fraction}, "skew": float, "slowest": host|-1}``."""
    by_host = {}
    for (host, _pid, _inc), doc in merged.items():
        if not _is_training_doc(doc):
            continue   # a launcher's wall is not a training host's
        prod, wall = by_host.get(host, (0.0, 0.0))
        prod += float((doc.get("states") or {})
                      .get("train_productive", 0.0) or 0.0)
        wall += float(doc.get("run_wall_seconds", 0.0) or 0.0)
        by_host[host] = (prod, wall)
    fracs = {h: (p / w if w > 0 else 0.0) for h, (p, w) in by_host.items()}
    skew, slowest = 0.0, -1
    if len(fracs) >= 2:
        slowest = min(fracs, key=lambda h: fracs[h])
        skew = max(fracs.values()) - fracs[slowest]
    telemetry.gauge("run_goodput_skew",
                    help="max-min goodput fraction across hosts "
                         "(0 until two hosts report)").set(skew)
    return {"hosts": fracs, "skew": skew, "slowest": slowest}


# ---------------------------------------------------------------------------
# Verdict + report CLI: python -m mxnet_tpu_torch.runprof report [path|dir]
# ---------------------------------------------------------------------------

def classify(states, goodput=None, anomaly_counts=None):
    """(verdict, hint) for a run-state seconds dict. ``healthy`` at or
    above :data:`HEALTHY_GOODPUT`; otherwise the verdict names the
    dominant badput state, and any sentinel trips are appended to the
    hint."""
    total = sum(v for v in (states or {}).values() if v > 0)
    if not states or total <= 0:
        return "unknown", HINTS["unknown"]
    if goodput is None:
        goodput = states.get("train_productive", 0.0) / total
    if goodput >= HEALTHY_GOODPUT:
        verdict = "healthy"
    else:
        badput = {s: states.get(s, 0.0) for s in RUN_STATES
                  if s != "train_productive"}
        dominant = max(badput, key=lambda s: badput[s])
        verdict = _STATE_VERDICT[dominant] if badput[dominant] > 0 \
            else "healthy"
    hint = HINTS[verdict]
    trips = sum((anomaly_counts or {}).values())
    if trips:
        kinds = ", ".join("%s x%d" % (k, n) for k, n
                          in sorted((anomaly_counts or {}).items()))
        hint = ("%d sentinel trip(s) on record (%s) — read the "
                "flight-recorder dump first; then %s"
                % (trips, kinds, hint))
    return verdict, hint


def _load_source(path):
    """Resolve a report data source into ``{"agg", "source",
    "skew"}``: a runprof snapshot JSON, a directory of host snapshots,
    or None (configured telemetry dir, then the live process)."""
    if path is None:
        d = telemetry.configured_dir() \
            or os.environ.get("MXNET_TELEMETRY_DIR")
        if d and os.path.isdir(d):
            merged = merge_host_snapshots(d)
            if merged:
                return {"agg": aggregate(merged.values()),
                        "source": "%d snapshot(s) in %s"
                                  % (len(merged), d),
                        "skew": goodput_by_host(merged)}
        snap = ledger.snapshot()
        if any(v > 0 for s, v in snap["states"].items() if s != "init"):
            return {"agg": aggregate([snap]), "source": "live process",
                    "skew": None}
        return {"agg": None, "source": "none", "skew": None}
    if os.path.isdir(path):
        merged = merge_host_snapshots(path)
        if not merged:
            return {"agg": None, "source": path, "skew": None}
        return {"agg": aggregate(merged.values()),
                "source": "%d snapshot(s) in %s" % (len(merged), path),
                "skew": goodput_by_host(merged)}
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    return {"agg": aggregate([doc]), "source": path, "skew": None}


def report(path=None, out=None, json_only=False):
    """Render the run-anatomy report (goodput waterfall, lost work,
    anomaly log, per-host skew, verdict); returns the process exit code
    (0 = a verdict was produced, 1 = no data)."""
    import sys
    out = out or sys.stdout
    src = _load_source(path)
    agg = src["agg"]
    if agg is None:
        if not json_only:
            out.write("Run anatomy: no run-state data (%s)\n"
                      % src["source"])
        out.write(json.dumps({"metric": "runprof_report",
                              "verdict": "unknown",
                              "source": src["source"]}) + "\n")
        return 1
    states = agg["states"]
    v, hint = classify(states, goodput=agg["goodput_fraction"],
                       anomaly_counts=agg["anomaly_counts"])
    if not json_only:
        out.write("Run anatomy (%s)\n" % src["source"])
        wall = agg["run_wall_seconds"]
        width = max(len(s) for s in RUN_STATES)
        for s in RUN_STATES:
            sec = states.get(s, 0.0)
            share = sec / wall if wall > 0 else 0.0
            bar = "#" * int(round(share * 40))
            out.write("  %-*s %9.3fs %6.1f%% %s\n"
                      % (width, s, sec, share * 100.0, bar))
        out.write("  goodput: %.1f%% of %.3fs run wall\n"
                  % (agg["goodput_fraction"] * 100.0, wall))
        if agg["lost_steps"]:
            out.write("  lost work: %d step(s) re-executed after "
                      "restart(s) (~%.3fs badput)\n"
                      % (agg["lost_steps"], agg["lost_work_seconds"]))
        if agg["anomaly_counts"]:
            out.write("  anomalies: %s\n" % ", ".join(
                "%s x%d" % (k, n) for k, n
                in sorted(agg["anomaly_counts"].items())))
            for a in agg["anomalies"][-5:]:
                out.write("    [%s] %s\n"
                          % (a.get("kind"), a.get("detail") or ""))
        skew = src.get("skew")
        if skew and len(skew["hosts"]) >= 2:
            out.write("  hosts: %d, goodput skew %.1f%% "
                      "(slowest host %s)\n"
                      % (len(skew["hosts"]), skew["skew"] * 100.0,
                         skew["slowest"]))
        out.write("  verdict: %s\n  hint: %s\n" % (v, hint))
    rec = {"metric": "runprof_report", "verdict": v,
           "goodput_fraction": round(agg["goodput_fraction"], 4),
           "states": {s: round(states.get(s, 0.0), 4)
                      for s in RUN_STATES},
           "lost_steps": agg["lost_steps"],
           "lost_work_seconds": round(agg["lost_work_seconds"], 4),
           "anomalies": agg["anomaly_counts"],
           "source": src["source"]}
    skew = src.get("skew")
    if skew and len(skew["hosts"]) >= 2:
        rec["goodput_skew"] = round(skew["skew"], 4)
        rec["slowest_host"] = skew["slowest"]
    out.write(json.dumps(rec) + "\n")
    return 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.runprof",
        description="Run anatomy report: goodput waterfall, lost-work "
                    "badput, anomaly log, per-host goodput skew")
    ap.add_argument("command", choices=["report"],
                    help="'report': account a run's wall clock")
    ap.add_argument("path", nargs="?", default=None,
                    help="runprof snapshot JSON or a telemetry dir of "
                         "host snapshots (default: MXNET_TELEMETRY_DIR, "
                         "then the live process)")
    ap.add_argument("--json", action="store_true",
                    help="machine line only, no table")
    args = ap.parse_args(argv)
    return report(args.path, json_only=args.json)


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
