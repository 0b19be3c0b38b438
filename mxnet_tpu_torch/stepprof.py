"""Step-time anatomy: a per-phase training profiler with a bottleneck
verdict and cross-host straggler detection.

Counterpart of `mxnet_tpu/stepprof.py`, with the same taxonomy, metric
names, verdict labels and report keys. Every training step is cut into
the fixed phases:

    data_wait       the iterator blocked (the input pipeline starved us)
    h2d             host-to-device transfer, batch staging
    dispatch        Python and launch overhead until the step's kernels
                    are queued (the port's step is eager, so this holds
                    the launch of every op of the forward and backward)
    device_compute  device busy, observed where the host waits on device
                    results (the metric's readback, or a sampled
                    ``torch.cuda.synchronize`` bracket, "sampled sync")
    sync            kvstore gradient aggregation
    opt_update      the optimizer's apply (one launch a group of the
                    multi-tensor update on the card)

plus a derived ``other`` bucket (step wall time no measured phase tiled:
callbacks, metric arithmetic, logging).

Three consumers sit on top:

1. **Phase histograms and shares**: every phase feeds a
   ``step_<phase>_seconds`` histogram (and, with an event log, a
   ``step.<phase>`` JSONL span that `telemetry.merge` turns into the
   chrome trace). :func:`shares` normalizes per-phase p50s (or totals)
   into fractions that sum to 1.
2. **Overlap estimator**: kernels run while the host loads data; the
   estimator compares the mean of sampled-sync device measurements
   (``D``) with the visible device wait a step (``V``):
   ``hidden = max(0, min(D - V, host))`` is device time hidden under
   host phases (``hidden_fraction``).
3. **Bottleneck verdict**: :func:`classify` maps the share vector to
   input-bound / dispatch-bound / sync-bound / compute-bound and picks a
   remediation hint. A collective inventory (``comm``) adds the
   ``comm-bound`` class; the port trains on one device and passes none.
   CLI: ``python -m mxnet_tpu_torch.stepprof report``.

Cross-host: with a telemetry dir configured each process writes a
``stepprof_host<h>_pid<p>.json`` snapshot; :func:`detect_stragglers`
merges them and publishes ``step_skew_seconds`` / ``straggler_host``.

Sampled sync: a ``torch.cuda.synchronize()`` bracket measures true
device time but drains the queue, so it is off by default.
``MXNET_STEPPROF_SYNC_EVERY=N`` (or ``enable(sync_every=N)``) brackets
every Nth step while ``MXNET_STEPPROF=1``; `Module._step` and
`_step_scan` honour it, never while a stream is capturing a CUDA graph,
and cross-check the measured rate against the step's FLOP count
(``step_device_flops_per_second``, comparable to ``mfu``). An eager step
outgrows the card's launch queue, so `Module._step` times it in
segments, each held back until the host has issued it (`module._Holds`),
and drops a sample the card may have waited in.

Recording is always on and costs a dict lookup and two clock reads a
phase; ``MXNET_STEPPROF=1`` also arms the `callback.Speedometer` phase
summary and the sampled sync. Stdlib + telemetry only at import.

Lock order: this module has one lock (the profiler ``_lock``); it may
call into telemetry (whose registry lock is innermost of all) while
holding it, never the reverse. The thread-local current-step record is
single-thread by construction and takes no lock.
"""
from __future__ import annotations

import atexit
import json
import math
import os
import threading
import time

from . import telemetry

__all__ = ["PHASES", "PHASE_OTHER", "StepProfiler", "profiler", "phase",
           "step", "record_step", "ImplicitStepper", "enabled",
           "enable", "disable",
           "should_sync", "note_device_sample", "totals", "shares",
           "overlap", "classify", "verdict", "snapshot", "reset",
           "write_host_snapshot", "merge_host_snapshots",
           "detect_stragglers", "report", "main"]

#: The fixed taxonomy. Order is display order.
PHASES = ("data_wait", "h2d", "dispatch", "device_compute", "sync",
          "opt_update")
#: Derived residual bucket (wall time no measured phase tiled).
PHASE_OTHER = "other"

#: verdict -> phases whose shares vote for it. ``other`` is host-side
#: python between phases (callbacks, metric bookkeeping), so it votes
#: with dispatch.
VERDICT_GROUPS = {
    "input-bound": ("data_wait", "h2d"),
    "dispatch-bound": ("dispatch", PHASE_OTHER),
    "sync-bound": ("sync",),
    "compute-bound": ("device_compute", "opt_update"),
}

#: Top remediation hint per verdict. :func:`classify` may refine these from extras (retrace counts,
#: fused/donation flags).
HINTS = {
    "input-bound":
        "the iterator cannot keep the device fed: deepen "
        "io.PrefetchingIter (depth=), pre-stage superbatches with "
        "Module.stack_batches, shard the input pipeline per host; "
        "watch prefetch_wait_seconds{side=consumer} "
        "and prefetch_queue_depth",
    "dispatch-bound":
        "host/python overhead dominates: the port launches every op "
        "of an eager step from Python, so stage batches with "
        "fit(batches_per_dispatch=K), keep the optimizer on the "
        "multi-tensor update (one launch a group, not one a parameter) "
        "and capture the step's programs as CUDA graphs",
    "sync-bound":
        "gradient aggregation dominates: reduce fewer or compressed "
        "gradients through the kvstore, overlap the reduction with the "
        "backward, and check straggler_host for a slow peer",
    "compute-bound":
        "the device is the bottleneck: read the profiler's device table "
        "(profiler.device_dumps) for the top kernels, then drive the "
        "mfu gauge toward target",
    "comm-bound":
        "the interconnect dominates the step: predicted collective "
        "time is a large share of the wall (shardprof report names the "
        "kinds/bytes) — overlap the collectives with compute or shrink "
        "the wire bytes",
    "unknown":
        "no step-phase data recorded: run the training loop through "
        "Module.fit or wrap steps in stepprof.step()",
}


def _env_flag(name, default="0"):
    return os.environ.get(name, default) not in ("0", "", "false")


_env_int = telemetry.env_int


class _Phase:
    """Times one phase. Always observes the ``step_<phase>_seconds``
    histogram (via a `telemetry.span` named ``step.<phase>``, so a
    configured event log also gets the chrome-trace slice) and, when a
    step record is open on this thread, folds the duration into it."""

    __slots__ = ("prof", "name", "seconds", "_span", "_t0")

    def __init__(self, prof, name, **attrs):
        if name not in PHASES:
            raise ValueError("unknown phase %r (taxonomy: %s)"
                             % (name, ", ".join(PHASES)))
        self.prof = prof
        self.name = name
        self.seconds = 0.0
        self._span = telemetry.span("step." + name, **attrs)

    def __setitem__(self, key, value):
        self._span[key] = value

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = time.perf_counter() - self._t0
        self._span.__exit__(exc_type, exc, tb)
        self.prof._note_phase(self.name, self.seconds)
        return None


class _Step:
    """Brackets one training step: wall time to ``step_seconds``, phase
    durations collected from the nested :class:`_Phase` blocks, record
    handed to the profiler on exit. Extra attrs land in the JSONL span
    (``sp["batches"] = K``)."""

    __slots__ = ("prof", "attrs", "phases", "synced", "batches",
                 "_span", "_t0", "_outer")

    def __init__(self, prof, batches=1, **attrs):
        self.prof = prof
        self.attrs = attrs
        self.phases = {}
        self.synced = False
        self.batches = int(batches)
        self._span = telemetry.span("step", **attrs)

    def __setitem__(self, key, value):
        if key == "batches":
            self.batches = int(value)
        self._span[key] = value

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        self._outer = getattr(self.prof._tl, "current", None)
        self.prof._tl.current = self
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self._t0
        self.prof._tl.current = self._outer
        self._span.__exit__(exc_type, exc, tb)
        if exc is None:
            self.prof._record(self.phases, wall, synced=self.synced,
                              batches=self.batches)
        return None


class StepProfiler:
    """Process-wide accumulator behind the module-level API (tests may
    instantiate their own). Bounded: a deque of the last ``window`` step
    records plus O(len(PHASES)) running totals."""

    def __init__(self, window=None):
        if window is None:
            window = _env_int("MXNET_STEPPROF_WINDOW", 512)
        from collections import deque
        self._lock = threading.Lock()
        self._tl = threading.local()
        self._window = deque(maxlen=max(8, int(window)))
        self._totals = {}          # phase -> cumulative seconds
        self._steps = 0
        self._wall_total = 0.0
        self._batches_total = 0
        self._device_samples = deque(maxlen=64)  # synced D measurements
        self._export_thread = None

    # -- recording --------------------------------------------------------

    def phase(self, name, **attrs):
        return _Phase(self, name, **attrs)

    def step(self, batches=1, **attrs):
        return _Step(self, batches=batches, **attrs)

    def _note_phase(self, name, seconds):
        rec = getattr(self._tl, "current", None)
        if rec is not None:
            rec.phases[name] = rec.phases.get(name, 0.0) + seconds

    def note_device_sample(self, seconds, batches=1, flops_per_batch=None):
        """Feed one *sampled-sync* device measurement (a forced
        ``block_until_ready`` bracket): marks the open step as synced,
        feeds the overlap estimator's true-device-time mean, and — when
        the executable's FLOPs are known — cross-checks the implied
        device rate against the roofline (``step_device_flops_per_second``
        gauge, same denominator as ``mfu``)."""
        rec = getattr(self._tl, "current", None)
        if rec is not None:
            rec.synced = True
        with self._lock:
            self._device_samples.append(float(seconds) / max(1, batches))
        if flops_per_batch and seconds > 0:
            rate = float(flops_per_batch) * max(1, batches) / seconds
            telemetry.gauge(
                "step_device_flops_per_second",
                help="model FLOP/s implied by sampled-sync device_compute "
                     "brackets (cross-check against mfu)").set(rate)

    def record_step(self, phases, wall, synced=False, batches=1):
        """Directly feed one step record (synthetic workloads, tests)."""
        for name, dur in phases.items():
            if name not in PHASES:
                raise ValueError("unknown phase %r" % (name,))
            telemetry.histogram("step_%s_seconds" % name).observe(dur)
        telemetry.histogram("step_seconds").observe(wall)
        if synced and "device_compute" in phases:
            with self._lock:
                self._device_samples.append(
                    float(phases["device_compute"]) / max(1, batches))
        self._record(dict(phases), float(wall), synced=synced,
                     batches=batches)

    def _record(self, phases, wall, synced=False, batches=1):
        other = max(0.0, wall - sum(phases.values()))
        rec = {"wall": wall, "phases": phases, "other": other,
               "synced": bool(synced), "batches": max(1, int(batches))}
        with self._lock:
            self._window.append(rec)
            self._steps += 1
            self._wall_total += wall
            self._batches_total += rec["batches"]
            for name, dur in phases.items():
                self._totals[name] = self._totals.get(name, 0.0) + dur
            self._totals[PHASE_OTHER] = \
                self._totals.get(PHASE_OTHER, 0.0) + other
        if self is profiler:
            # run anatomy: the PROCESS profiler's steps feed the
            # run-state ledger (data_wait -> input_stall, the rest ->
            # train_productive) and its spike sentinel; private test
            # instances stay out of the run's books
            runprof = None
            try:
                from . import runprof
                runprof.note_step(phases, wall, batches=rec["batches"])
            except Exception as exc:
                if runprof is not None and \
                        isinstance(exc, runprof.RunHealthError):
                    raise   # MXNET_RUNPROF_HALT: the spike stops the run
                telemetry.swallowed("stepprof.runprof", exc)
            # memory anatomy: step records are one of the three
            # timeline sample points (throttled inside memprof)
            try:
                from . import memprof
                memprof.sample("step")
            except Exception as exc:
                if runprof is not None and \
                        isinstance(exc, runprof.RunHealthError):
                    raise   # leak sentinel under MXNET_RUNPROF_HALT
                telemetry.swallowed("stepprof.memprof", exc)
        self._maybe_export()

    def reset(self):
        with self._lock:
            self._window.clear()
            self._totals.clear()
            self._steps = 0
            self._wall_total = 0.0
            self._batches_total = 0
            self._device_samples.clear()

    # -- views ------------------------------------------------------------

    def totals(self):
        """{phase: cumulative seconds} including ``other``."""
        with self._lock:
            return dict(self._totals)

    def _phase_p50s(self):
        """Per-phase median over the window (a step without the phase
        counts as 0, so medians stay comparable across phases)."""
        with self._lock:
            recs = list(self._window)
        if not recs:
            return {}
        out = {}
        for name in PHASES + (PHASE_OTHER,):
            xs = sorted(
                (r["other"] if name == PHASE_OTHER
                 else r["phases"].get(name, 0.0)) for r in recs)
            mid = (len(xs) - 1) / 2.0
            lo, hi = int(math.floor(mid)), int(math.ceil(mid))
            out[name] = (xs[lo] + xs[hi]) / 2.0
        return out

    def shares(self, basis="p50"):
        """Normalized phase shares (sum exactly 1.0), ``{}`` when no
        steps were recorded. ``basis="p50"`` uses per-phase window
        medians (robust to a straggling outlier step); ``"total"`` uses
        cumulative seconds."""
        if basis == "p50":
            vals = self._phase_p50s()
        elif basis == "total":
            vals = self.totals()
        else:
            raise ValueError("basis must be 'p50' or 'total'")
        denom = sum(vals.values())
        if not vals or denom <= 0:
            return {}
        return {name: vals.get(name, 0.0) / denom
                for name in PHASES + (PHASE_OTHER,)}

    def steps_recorded(self):
        """Cheap step count (no window copy/sort — hot-path callers
        like the elastic loop's per-step delta read this, not
        :meth:`step_stats`)."""
        with self._lock:
            return self._steps

    def step_stats(self):
        with self._lock:
            recs = list(self._window)
            steps, wall = self._steps, self._wall_total
            batches = self._batches_total
        walls = sorted(r["wall"] for r in recs)
        p50 = walls[len(walls) // 2] if walls else 0.0
        return {"steps": steps, "batches": batches,
                "wall_total_seconds": wall,
                "mean_step_seconds": wall / steps if steps else 0.0,
                "p50_step_seconds": p50}

    def overlap(self):
        """Host-busy vs device-busy decomposition over the window.

        ``device_busy_est`` is the rolling mean of sampled-sync device
        measurements (per batch, rescaled by each step's batch count);
        ``device_visible`` is the mean device wait the host observed
        (the ``device_compute`` phase); ``overlap_seconds`` is device
        time hidden under host phases and ``hidden_fraction`` its share
        of device busy — the "async dispatch hides data loading"
        number. Estimate fields are None until a sampled-sync
        measurement exists."""
        with self._lock:
            recs = [r for r in self._window if not r["synced"]]
            samples = list(self._device_samples)
        d_est_pb = sum(samples) / len(samples) if samples else None
        if not recs:
            return {"steps": 0, "device_busy_est": d_est_pb,
                    "device_visible": None, "overlap_seconds": None,
                    "hidden_fraction": None, "host_busy": None}
        host = vis = hidden = dev = 0.0
        for r in recs:
            v = r["phases"].get("device_compute", 0.0)
            h = sum(d for n, d in r["phases"].items()
                    if n != "device_compute") + r["other"]
            host += h
            vis += v
            if d_est_pb is not None:
                d = d_est_pb * r["batches"]
                dev += d
                hidden += max(0.0, min(d - v, h))
        n = len(recs)
        return {
            "steps": n,
            "host_busy": host / n,
            "device_visible": vis / n,
            "device_busy_est": dev / n if d_est_pb is not None else None,
            "overlap_seconds": hidden / n if d_est_pb is not None else None,
            "hidden_fraction": (hidden / dev) if dev > 0 else None,
        }

    def snapshot(self):
        """One JSON-able view: identity, step stats, totals, shares,
        overlap, verdict. The PROCESS profiler's verdict is
        the verdict of the share vector (the port runs on one device,
        so no collective inventory feeds ``comm``, which stays None)."""
        sh = self.shares()
        comm = None
        v, hint = classify(sh, comm=comm)
        doc = {"host": telemetry.host_id(), "pid": os.getpid(),
               "updated": time.time(),
               "phase_totals": self.totals(), "shares": sh,
               "overlap": self.overlap(), "comm": comm,
               "verdict": v, "hint": hint}
        doc.update(self.step_stats())
        return doc

    # -- cross-host export ------------------------------------------------

    def _maybe_export(self):
        """Start the background exporter the first time a step is
        recorded while a telemetry dir is configured. The exporter
        thread — not the training thread — writes the per-host snapshot
        and refreshes the straggler gauges every ~2 s: snapshot writes
        and the O(hosts) cross-host scan are file I/O (possibly NFS)
        that must never inject step-time outliers into the loop being
        measured."""
        if telemetry.configured_dir() is None:
            return
        with self._lock:
            if self._export_thread is not None:
                return
            t = threading.Thread(target=self._export_loop, daemon=True,
                                 name="mxnet_tpu_torch-stepprof-export")
            self._export_thread = t
        t.start()

    def _export_loop(self):
        while True:
            time.sleep(2.0)
            if telemetry.configured_dir() is None:
                continue   # dir unconfigured mid-run: idle, not dead
            try:
                if self._steps:
                    self.write_host_snapshot()
                    detect_stragglers()
            except Exception as exc:
                telemetry.swallowed("stepprof.export", exc)

    def write_host_snapshot(self, dir=None, force=False):
        """Write this process's ``stepprof_host<h>_pid<p>.json`` into
        ``dir`` (default: the configured telemetry dir; None and no dir
        -> no-op, returns None) via `telemetry.write_host_json` — the
        one atomic per-host snapshot transport."""
        if not force and self._steps == 0:
            return None
        return telemetry.write_host_json("stepprof", self.snapshot(),
                                         dir=dir)


profiler = StepProfiler()


def _atexit_snapshot():
    try:
        profiler.write_host_snapshot()
    except Exception as exc:
        telemetry.swallowed("stepprof.atexit", exc)


atexit.register(_atexit_snapshot)


# ---------------------------------------------------------------------------
# Module-level facade over the process profiler
# ---------------------------------------------------------------------------

#: sampled-sync cadence while the verbose layer is enabled and
#: MXNET_STEPPROF_SYNC_EVERY is unset: one forced device wait every
#: 32 steps — cheap enough not to distort steady state, frequent
#: enough to keep the overlap estimator's device-busy mean fresh
DEFAULT_SYNC_EVERY = 32

_cfg = {
    "enabled": _env_flag("MXNET_STEPPROF"),
    "sync_every": _env_int("MXNET_STEPPROF_SYNC_EVERY",
                           DEFAULT_SYNC_EVERY),
    "sync_counter": 0,
}
_cfg_lock = threading.Lock()


def enabled():
    """True when the verbose layer (Speedometer phase summary, sampled
    sync default) is armed — via ``MXNET_STEPPROF=1`` or
    :func:`enable`. Phase recording itself is always on."""
    return _cfg["enabled"]


def enable(sync_every=None):
    with _cfg_lock:
        _cfg["enabled"] = True
        if sync_every is not None:
            _cfg["sync_every"] = int(sync_every)


def disable():
    with _cfg_lock:
        _cfg["enabled"] = False


def should_sync():
    """True when the instrumented step should bracket this dispatch with
    a forced device sync (every ``sync_every``-th step while enabled)."""
    if not _cfg["enabled"]:
        return False
    with _cfg_lock:
        n = _cfg["sync_every"]
        if n <= 0:
            return False
        _cfg["sync_counter"] += 1
        return _cfg["sync_counter"] % n == 0


def phase(name, **attrs):
    return profiler.phase(name, **attrs)


def step(batches=1, **attrs):
    return profiler.step(batches=batches, **attrs)


def in_step():
    """True when a ``stepprof.step()`` record is open on this thread
    (phases fired now reach the step record, not just histograms)."""
    return getattr(profiler._tl, "current", None) is not None


def record_step(phases, wall, synced=False, batches=1):
    profiler.record_step(phases, wall, synced=synced, batches=batches)


class ImplicitStepper:
    """Per-call step bracketing for loop-owned train APIs (gluon
    ``Trainer.step``, the ``data_parallel`` front doors) whose
    surrounding loop belongs to user code: when the caller has NOT
    opened a ``stepprof.step()`` of their own, each :meth:`bracket`
    call records one step whose wall time reaches back to the END of
    the previous call — so the user's forward/backward between calls is
    part of the step (it lands in ``other``) and steps/shares/straggler
    snapshots work for gluon and data_parallel training, not just
    ``Module.fit``. Inside an explicit step (e.g. a fit loop) it is a
    no-op passthrough. One instance per Trainer/step object; not
    thread-shared."""

    __slots__ = ("_prof", "_last_end", "_pending")

    def __init__(self, prof=None):
        self._prof = prof or profiler
        self._last_end = None
        self._pending = {}

    def carry_phase(self, name, seconds):
        """Attribute work done OUTSIDE the bracket (e.g.
        ``place_batch`` staging before the step call) to the next
        bracketed step, so it reaches shares/verdict instead of being
        lost to the residual ``other`` bucket."""
        if name not in PHASES:
            raise ValueError("unknown phase %r" % (name,))
        self._pending[name] = self._pending.get(name, 0.0) + float(seconds)

    def bracket(self, **attrs):
        from contextlib import contextmanager

        @contextmanager
        def _cm():
            if getattr(self._prof._tl, "current", None) is not None:
                self._flush_pending()
                yield None   # the caller's loop owns the step
                return
            st = self._prof.step(**attrs)
            st.__enter__()
            if self._last_end is not None:
                # stretch the wall back over the user's fwd/bwd so the
                # step covers loop-iteration time, not just this call —
                # BOTH clocks: the record wall (_t0) and the telemetry
                # span (same perf_counter timeline + its wall-clock
                # start), so step_seconds histograms / chrome-trace
                # spans / mean_step_seconds all agree
                delta = st._t0 - self._last_end
                st._t0 = self._last_end
                st._span._t0 = self._last_end
                st._span._wall -= delta
            self._flush_pending()
            try:
                yield st
            except BaseException:
                # a failed step must not be recorded as a clean one:
                # _Step.__exit__ skips _record and annotates the span
                # when given the exception (matching an explicit step)
                import sys
                st.__exit__(*sys.exc_info())
                self._last_end = time.perf_counter()
                raise
            else:
                st.__exit__(None, None, None)
                self._last_end = time.perf_counter()
        return _cm()

    def _flush_pending(self):
        if self._pending:
            for name, seconds in self._pending.items():
                self._prof._note_phase(name, seconds)
            self._pending.clear()


def note_device_sample(seconds, batches=1, flops_per_batch=None):
    profiler.note_device_sample(seconds, batches=batches,
                                flops_per_batch=flops_per_batch)


def totals():
    return profiler.totals()


def shares(basis="p50"):
    return profiler.shares(basis=basis)


def overlap():
    return profiler.overlap()


def snapshot():
    return profiler.snapshot()


def reset():
    profiler.reset()


def write_host_snapshot(dir=None, force=False):
    return profiler.write_host_snapshot(dir=dir, force=force)


# ---------------------------------------------------------------------------
# Bottleneck verdict
# ---------------------------------------------------------------------------

#: comm wins the verdict outright when predicted wire time is at least
#: this share of the step wall (below it, comm still wins when it
#: out-scores the dominant share group)
COMM_BOUND_FRACTION = 0.4


def _comm_hint(comm):
    """ROADMAP-item-1/2-keyed remediation for a comm-bound step, picked
    from the collective inventory shape (`shardprof.comm_stats`)."""
    base = HINTS["comm-bound"]
    ratio = comm.get("param_gather_ratio")
    overlap = comm.get("overlap_fraction")
    if overlap is not None and overlap >= 0.5:
        # the wire is already mostly hidden yet still dominates: more
        # overlap cannot win — shrink the bytes themselves
        ratio = None
    if ratio is not None and 0.5 <= ratio <= 2.0:
        hint = ("all-gather/reduce-scatter bytes/step ~= param bytes: "
                "the fsdp weight gather is not overlapped — enable "
                "param donation (MXNET_SPMD_DONATE) and scan the steps "
                "(fit(batches_per_dispatch=K)) so the program prefetches the "
                "next layer's gather during compute; then %s" % base)
    elif comm.get("dominant_kind") == "all-reduce":
        hint = ("all-reduce dominates (dp gradient sync): raise the "
                "per-device batch, wire gradient_compression (2-bit), "
                "or go fsdp so the sync becomes a reduce-scatter of "
                "1/N bytes; then %s" % base)
    else:
        hint = base
    if comm.get("overlap_fraction") is not None:
        hint = ("only %.0f%% of predicted comm time is hidden under "
                "compute; %s" % (comm["overlap_fraction"] * 100.0, hint))
    return hint


def classify(shares, retraces=None, fused=None, donated=None, comm=None):
    """(verdict, hint) from a phase-share dict.

    The verdict is the share-dominant group of :data:`VERDICT_GROUPS`
    (deterministic: ties break in the table's order). The hint is the
    group's ROADMAP-item-2 remediation, refined by the optional extras:
    ``retraces`` (dispatch-bound + retraces -> unbucketed shapes),
    ``fused=False`` (dispatch-bound -> unfused optimizer), and
    ``donated=False`` (compute-bound -> donation missing).

    ``comm`` — a `shardprof.comm_stats` dict — adds the ``comm-bound``
    class: in-program collectives hide inside ``device_compute``, so a
    share vector alone can never see them; when the predicted wire time
    is a large share of the step wall (>= :data:`COMM_BOUND_FRACTION`,
    or bigger than the dominant share group) the verdict becomes
    ``comm-bound`` with a hint keyed to the inventory shape (fsdp
    gather vs dp all-reduce, ROADMAP items 1-2)."""
    if not shares or sum(shares.values()) <= 0:
        if comm and (comm.get("comm_fraction") or 0) \
                >= COMM_BOUND_FRACTION:
            return "comm-bound", _comm_hint(comm)
        return "unknown", HINTS["unknown"]
    scores = {v: sum(shares.get(p, 0.0) for p in group)
              for v, group in VERDICT_GROUPS.items()}
    verdict = max(VERDICT_GROUPS, key=lambda v: scores[v])
    if comm:
        cf = comm.get("comm_fraction") or 0.0
        if cf >= COMM_BOUND_FRACTION or cf > scores[verdict]:
            return "comm-bound", _comm_hint(comm)
    hint = HINTS[verdict]
    if verdict == "dispatch-bound":
        if retraces:
            hint = ("unbucketed/varying shapes are recompiling (%d "
                    "retraces — see xla_stats.last_retrace()): bucket "
                    "input shapes; then %s" % (int(retraces), hint))
        elif fused is False:
            hint = ("the optimizer update is not fused into the step "
                    "program (one dispatch per parameter): use a "
                    "FusedApplier-resolvable optimizer; then %s" % hint)
    elif verdict == "compute-bound" and donated is False:
        hint = ("buffer donation is OFF, so every step pays a full "
                "param/opt-state copy: enable scan_donate_params / "
                "donate_argnums; then %s" % hint)
    return verdict, hint


def verdict(basis="p50"):
    """(verdict, hint) of the live process profiler. The port trains on
    one device, so no collective inventory feeds the ``comm-bound``
    class here; :func:`classify` takes one when a caller has it."""
    return classify(profiler.shares(basis=basis))


# ---------------------------------------------------------------------------
# Cross-host merge + straggler detection
# ---------------------------------------------------------------------------

def merge_host_snapshots(dir=None):
    """Read every ``stepprof_host*.json`` under ``dir`` (default: the
    configured telemetry dir), keeping the freshest snapshot per host
    (`telemetry.merge_host_json`). Returns {host_id: snapshot_dict}."""
    return telemetry.merge_host_json("stepprof", dir)


#: a host is named a straggler only when the skew is a real fraction of
#: its step time — jitter on an unskewed run must not accuse anyone
STRAGGLER_MIN_RATIO = 0.2


def detect_stragglers(dir=None):
    """Merge per-host snapshots and publish ``step_skew_seconds`` (max
    minus min mean step time across hosts) and ``straggler_host`` (the
    slow host's id, or -1 when no host stands out / fewer than two
    hosts report). Returns the merged view:
    ``{"skew_seconds", "straggler_host", "hosts": {...}}``."""
    hosts = {h: d for h, d in merge_host_snapshots(dir).items()
             if d.get("steps", 0) > 0}
    skew, straggler = 0.0, -1
    if len(hosts) >= 2:
        means = {h: float(d.get("mean_step_seconds", 0.0))
                 for h, d in hosts.items()}
        slow = max(means, key=lambda h: means[h])
        fast = min(means, key=lambda h: means[h])
        skew = means[slow] - means[fast]
        if means[slow] > 0 and skew / means[slow] >= STRAGGLER_MIN_RATIO:
            straggler = slow
    telemetry.gauge("step_skew_seconds",
                    help="max-min mean step wall time across hosts "
                         "(0 until two hosts report)").set(skew)
    telemetry.gauge("straggler_host",
                    help="host id whose steps are slowest by more than "
                         "%d%% (-1: none)" % (STRAGGLER_MIN_RATIO * 100)
                    ).set(straggler)
    return {"skew_seconds": skew, "straggler_host": straggler,
            "hosts": hosts}


# ---------------------------------------------------------------------------
# Report CLI: python -m mxnet_tpu_torch.stepprof report [path]
# ---------------------------------------------------------------------------

def _parse_prom(text):
    """Phase p50s + sums out of a Prometheus text snapshot (the
    ``step_<phase>_seconds`` summaries `telemetry.dumps` writes).
    Returns ({phase: p50}, {phase: sum})."""
    import re
    p50s, sums = {}, {}
    for name in PHASES + (PHASE_OTHER,):
        m = re.search(r'^step_%s_seconds\{quantile="0\.5"\} ([0-9eE.+-]+)$'
                      % name, text, re.M)
        if m:
            p50s[name] = float(m.group(1))
        m = re.search(r"^step_%s_seconds_sum ([0-9eE.+-]+)$" % name,
                      text, re.M)
        if m:
            sums[name] = float(m.group(1))
    return p50s, sums


def _normalize(vals):
    denom = sum(vals.values())
    if not vals or denom <= 0:
        return {}
    return {k: v / denom for k, v in vals.items()}


def _load_source(path):
    """Resolve a report data source into
    ``{"shares", "source", "straggler", "overlap"}``.

    ``path`` may be: a stepprof/bench JSON file, a ``.prom`` snapshot, a
    directory (host snapshots preferred, ``.prom`` fallback), or None
    (telemetry dir, then ``bench_stepprof.json`` / ``bench_telemetry
    .prom`` in cwd, then the live in-process profiler)."""
    if path is None:
        d = telemetry.configured_dir() \
            or os.environ.get("MXNET_TELEMETRY_DIR")
        # bench.py drops its artifacts next to itself (the repo root),
        # so the no-arg report must look there too, not just the cwd
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        cands = ([d] if d else []) \
            + ["bench_stepprof.json", "bench_telemetry.prom"] \
            + [os.path.join(repo, fn) for fn in
               ("bench_stepprof.json", "bench_telemetry.prom")]
        for cand in cands:
            if cand and os.path.exists(cand):
                got = _load_source(cand)
                if got["shares"]:
                    return got
        if profiler.step_stats()["steps"] > 0:
            snap = profiler.snapshot()
            return {"shares": snap["shares"], "source": "live process",
                    "straggler": None, "overlap": snap["overlap"],
                    "comm": snap.get("comm")}
        return {"shares": {}, "source": "none", "straggler": None,
                "overlap": None}
    if os.path.isdir(path):
        merged = detect_stragglers(path)
        if merged["hosts"]:
            tot = {}
            comm = None
            for d in merged["hosts"].values():
                for k, v in (d.get("phase_totals") or {}).items():
                    tot[k] = tot.get(k, 0.0) + float(v)
                # worst host's comm view: snapshots carry the per-host
                # comm_stats dict since the communication-anatomy PR
                c = d.get("comm")
                if c and (comm is None
                          or (c.get("comm_fraction") or 0)
                          > (comm.get("comm_fraction") or 0)):
                    comm = c
            return {"shares": _normalize(tot),
                    "source": "%d host snapshot(s) in %s"
                              % (len(merged["hosts"]), path),
                    "straggler": merged, "overlap": None, "comm": comm}
        tot = {}
        for fn in sorted(os.listdir(path)):
            if fn.endswith(".prom"):
                with open(os.path.join(path, fn), encoding="utf-8") as fh:
                    _, sums = _parse_prom(fh.read())
                for k, v in sums.items():
                    tot[k] = tot.get(k, 0.0) + v
        return {"shares": _normalize(tot), "source": "prom files in %s"
                % path, "straggler": None, "overlap": None}
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    if path.endswith(".prom"):
        p50s, sums = _parse_prom(text)
        return {"shares": _normalize(p50s) or _normalize(sums),
                "source": path, "straggler": None, "overlap": None}
    doc = json.loads(text)
    sh = doc.get("shares") or doc.get("phases") or {}
    sh = {k: float(v) for k, v in sh.items() if isinstance(v, (int, float))}
    return {"shares": _normalize(sh), "source": path,
            "straggler": None, "overlap": doc.get("overlap"),
            "comm": doc.get("comm")}


def report(path=None, out=None, json_only=False):
    """Render the bottleneck report; returns the process exit code
    (0 = a verdict was produced, 1 = no data)."""
    import sys
    out = out or sys.stdout
    src = _load_source(path)
    sh = src["shares"]
    v, hint = classify(sh, comm=src.get("comm"))
    if not json_only:
        out.write("Step-time anatomy (%s)\n" % src["source"])
        if sh:
            width = max(len(p) for p in sh)
            for name in PHASES + (PHASE_OTHER,):
                if name in sh:
                    bar = "#" * int(round(sh[name] * 40))
                    out.write("  %-*s %6.1f%% %s\n"
                              % (width, name, sh[name] * 100.0, bar))
        ov = src.get("overlap")
        if ov and ov.get("hidden_fraction") is not None:
            out.write("  overlap: %.0f%% of device time hidden under "
                      "host phases\n" % (ov["hidden_fraction"] * 100.0))
        stra = src.get("straggler")
        if stra and len(stra["hosts"]) >= 2:
            out.write("  hosts: %d, step skew %.4fs, straggler_host=%d\n"
                      % (len(stra["hosts"]), stra["skew_seconds"],
                         stra["straggler_host"]))
        out.write("  verdict: %s\n  hint: %s\n" % (v, hint))
    rec = {"metric": "stepprof_report", "verdict": v,
           "shares": {k: round(val, 4) for k, val in sh.items()},
           "source": src["source"]}
    if src.get("straggler") and len(src["straggler"]["hosts"]) >= 2:
        rec["step_skew_seconds"] = src["straggler"]["skew_seconds"]
        rec["straggler_host"] = src["straggler"]["straggler_host"]
    out.write(json.dumps(rec) + "\n")
    return 0 if v != "unknown" else 1


def main(argv=None):
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.stepprof",
        description="Step-time anatomy report: phase shares, overlap, "
                    "straggler skew, bottleneck verdict")
    ap.add_argument("command", choices=["report"],
                    help="'report': classify a run's bottleneck")
    ap.add_argument("path", nargs="?", default=None,
                    help="stepprof/bench JSON, .prom snapshot, or a "
                         "telemetry dir (default: MXNET_TELEMETRY_DIR, "
                         "then ./bench_stepprof.json, then the live "
                         "process)")
    ap.add_argument("--json", action="store_true",
                    help="machine line only, no table")
    args = ap.parse_args(argv)
    return report(args.path, json_only=args.json)


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
