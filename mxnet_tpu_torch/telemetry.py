"""Runtime telemetry: the metrics registry, structured trace events and
their export.

Counterpart of `mxnet_tpu/telemetry.py`, with the same metric names and
the same text format, in one process-wide, thread-safe namespace:

1. **Metrics registry**: labeled :class:`Counter`, :class:`Gauge` and
   bounded-reservoir :class:`Histogram` (p50/p95/p99). :func:`dumps`
   renders Prometheus text, :func:`snapshot` returns plain dicts.
2. **Spans and events**: ``with telemetry.span("kvstore.push"): ...``
   times a region into a ``<name>_seconds`` histogram and, when an event
   log is configured, appends one JSONL line per event with wall and
   monotonic timestamps, pid, host id, tid and free-form args.
3. **Export and merge**: :func:`to_chrome` converts events to the
   chrome-trace JSON that perfetto.dev and chrome://tracing render;
   :func:`merge` stitches the per-process JSONL files of a directory into
   one timeline (wall-clock aligned, one trace "process" row per
   host/pid).

Arming: set ``MXNET_TELEMETRY_DIR`` and every process writes
``events_host<h>_pid<p>.jsonl`` plus periodic (and at-exit)
``metrics_host<h>_pid<p>.prom`` snapshots into it. Unconfigured, spans
still feed the registry and cost one dict lookup and two clock reads.

Everything here is stdlib-only at import.

Lock order: this module has one lock, the registry ``_lock``
(reentrant). Every mutation of ``_metrics`` / ``_kinds`` / ``_state`` /
``_taps`` happens under it; taps run under no telemetry lock, but
``counter()``/``gauge()`` calls from a tap re-enter ``_lock``.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import random
import re
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "get_metric", "snapshot", "dumps", "reset",
           "span", "event", "record_span", "configure", "configured_dir",
           "flush",
           "write_snapshot", "host_id", "set_host_id", "read_events",
           "to_chrome", "merge", "add_tap", "remove_tap", "swallowed",
           "write_host_json", "merge_host_json", "env_int", "env_float"]

try:
    from . import threadsan
except ImportError:
    # Loaded standalone, outside the package (a merger that only reads
    # telemetry dirs and never arms the sanitizer): a passthrough
    # register keeps this module stdlib-self-contained.
    class _ThreadsanOff:
        ARMED = False

        @staticmethod
        def register(name, lock):
            return lock

    threadsan = _ThreadsanOff()

_logger = logging.getLogger("mxnet_tpu_torch.telemetry")

_lock = threadsan.register("telemetry._lock", threading.RLock())
_metrics = {}   # (name, label_items) -> metric
_kinds = {}     # name -> (kind, help)

_state = {
    "dir": None,            # event-log + snapshot directory (None = off)
    "host_id": None,        # explicit override (set_host_id)
    "events_fh": None,      # open JSONL handle (lazy)
    "events_path": None,
    "snap_thread": None,
    "snap_stop": None,
}

_NAME_SANE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name):
    return _NAME_SANE.sub("_", name)


def _env_num(name, default, parse):
    try:
        return parse(os.environ.get(name, "") or default)
    except ValueError:
        import warnings
        warnings.warn("bad %s=%r ignored (want a number)"
                      % (name, os.environ[name]))
        return parse(default)


def env_int(name, default):
    """``int(os.environ[name])`` with warn-and-default on garbage — the
    one knob parser the observability modules share."""
    return _env_num(name, default, int)


def env_float(name, default):
    """:func:`env_int`'s float sibling."""
    return _env_num(name, default, float)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonically increasing value (Prometheus counter)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up (got %r)" % (amount,))
        with _lock:
            self.value += amount


class Gauge:
    """Point-in-time value (Prometheus gauge).

    Either pushed (:meth:`set`/:meth:`inc`) or pulled: bind a zero-arg
    callable with :meth:`set_function` and every snapshot/dumps samples
    it at scrape time — the idiom for values that already live somewhere
    (a queue's depth, a thread pool's live count) where per-update
    pushes would race or cost a hook on every transition."""

    __slots__ = ("name", "labels", "value", "fn")

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self.fn = None

    def set(self, value):
        with _lock:
            self.value = float(value)

    def set_function(self, fn):
        """Sample ``fn()`` at scrape time instead of a pushed value
        (``None`` unbinds). A raising/None-returning callable degrades
        to the last pushed value — scrapes never propagate it."""
        with _lock:
            self.fn = fn

    def read(self):
        fn = self.fn
        if fn is not None:
            try:
                v = fn()
                if v is not None:
                    return float(v)
            except Exception as exc:
                swallowed("telemetry.gauge_read", exc)
        return self.value

    def inc(self, amount=1.0):
        with _lock:
            self.value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)


class Histogram:
    """Bounded-reservoir histogram: exact count/sum/min/max, quantiles
    from a fixed-size uniform reservoir (Vitter's algorithm R — every
    observation has equal probability of being in the sample, so p50/p95
    stay unbiased no matter how long the run). Deterministically seeded:
    the same observation stream always yields the same quantiles."""

    __slots__ = ("name", "labels", "count", "sum", "min", "max",
                 "_samples", "_cap", "_rng")

    def __init__(self, name, labels, reservoir=2048):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._samples = []
        self._cap = int(reservoir)
        self._rng = random.Random(0xC0FFEE)

    def observe(self, value):
        value = float(value)
        with _lock:
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            if len(self._samples) < self._cap:
                self._samples.append(value)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._samples[j] = value

    def quantile(self, q):
        """Linear-interpolated quantile over the reservoir; None when
        nothing was observed."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with _lock:
            xs = sorted(self._samples)
        if not xs:
            return None
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _get(kind, name, help, labels, **kwargs):
    name = _sanitize(name)
    items = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
    with _lock:
        known = _kinds.get(name)
        if known is not None and known[0] != kind:
            raise ValueError("metric %r already registered as %s, not %s"
                             % (name, known[0], kind))
        if known is None or (help and not known[1]):
            _kinds[name] = (kind, help or (known[1] if known else ""))
        m = _metrics.get((name, items))
        if m is None:
            m = _KINDS[kind](name, dict(items), **kwargs)
            _metrics[(name, items)] = m
        return m


def counter(name, help="", **labels):
    """Get-or-create a labeled counter."""
    return _get("counter", name, help, labels)


def gauge(name, help="", **labels):
    """Get-or-create a labeled gauge."""
    return _get("gauge", name, help, labels)


def histogram(name, help="", reservoir=2048, **labels):
    """Get-or-create a labeled bounded-reservoir histogram."""
    return _get("histogram", name, help, labels, reservoir=reservoir)


def swallowed(site, exc=None):
    """Account a deliberately swallowed exception: bump
    ``errors_swallowed_total{site=}`` and debug-log it, raising nothing.
    The one-line idiom for ``except Exception`` handlers that must not
    propagate (exit paths, best-effort probes) — the failure still
    leaves a countable trace instead of disappearing."""
    try:
        counter("errors_swallowed_total",
                help="exceptions deliberately swallowed, by site",
                site=site).inc()
        if exc is not None:
            _logger.debug("swallowed[%s]: %r", site, exc)
    except Exception:
        pass


def get_metric(name, **labels):
    """Look up an existing metric without creating it (None if absent)."""
    items = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
    with _lock:
        return _metrics.get((_sanitize(name), items))


def reset():
    """Drop every metric (tests)."""
    with _lock:
        _metrics.clear()
        _kinds.clear()


_QUANTILES = (0.5, 0.95, 0.99)


def snapshot():
    """Plain-dict view of the registry: {name: {"type", "help",
    "series": [{"labels", ...values...}]}}. Histogram series carry
    count/sum/min/max/p50/p95/p99."""
    with _lock:
        pairs = sorted(_metrics.items())
        kinds = dict(_kinds)
    out = {}
    for (name, _items), m in pairs:
        entry = out.setdefault(name, {
            "type": kinds[name][0], "help": kinds[name][1], "series": []})
        if isinstance(m, Histogram):
            entry["series"].append({
                "labels": dict(m.labels), "count": m.count, "sum": m.sum,
                "min": m.min, "max": m.max,
                "p50": m.quantile(0.5), "p95": m.quantile(0.95),
                "p99": m.quantile(0.99)})
        else:
            value = m.read() if isinstance(m, Gauge) else m.value
            entry["series"].append({"labels": dict(m.labels),
                                    "value": value})
    return out


def _esc(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _label_str(labels, extra=()):
    items = list(labels.items()) + list(extra)
    if not items:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (_sanitize(k), _esc(v))
                             for k, v in items)


def _fmt(v):
    import math
    if v is None or not math.isfinite(v):
        # Prometheus text accepts NaN/+Inf/-Inf literals
        return "NaN" if v is None or math.isnan(v) \
            else ("+Inf" if v > 0 else "-Inf")
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def dumps():
    """Prometheus text exposition of the whole registry (histograms as
    summaries with p50/p95/p99 quantile series)."""
    snap = snapshot()
    lines = []
    for name, entry in sorted(snap.items()):
        if entry["help"]:
            lines.append("# HELP %s %s" % (name, entry["help"]))
        ptype = "summary" if entry["type"] == "histogram" else entry["type"]
        lines.append("# TYPE %s %s" % (name, ptype))
        for s in entry["series"]:
            if entry["type"] == "histogram":
                for q, key in zip(_QUANTILES, ("p50", "p95", "p99")):
                    lines.append("%s%s %s" % (
                        name, _label_str(s["labels"],
                                         [("quantile", repr(q))]),
                        _fmt(s[key])))
                lines.append("%s_sum%s %s" % (name, _label_str(s["labels"]),
                                              _fmt(s["sum"])))
                lines.append("%s_count%s %s" % (name,
                                                _label_str(s["labels"]),
                                                _fmt(s["count"])))
            else:
                lines.append("%s%s %s" % (name, _label_str(s["labels"]),
                                          _fmt(s["value"])))
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Host identity
# ---------------------------------------------------------------------------

def set_host_id(hid):
    """Pin this process's host id (called by ``dist.init`` on attach)."""
    with _lock:   # _state is only ever mutated under the registry lock
        _state["host_id"] = int(hid)


def host_id():
    """This process's host id: explicit :func:`set_host_id` >
    ``MXNET_TELEMETRY_HOST`` / ``DMLC_WORKER_ID`` env > the
    ``torch.distributed`` rank when a process group is initialized > 0.
    Never imports or initializes torch itself."""
    if _state["host_id"] is not None:
        return _state["host_id"]
    for key in ("MXNET_TELEMETRY_HOST", "DMLC_WORKER_ID"):
        v = os.environ.get(key)
        if v:
            try:
                return int(v)
            except ValueError:
                pass
    try:
        import sys
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() and \
                dist.is_initialized():
            return int(dist.get_rank())
    except Exception as exc:  # pragma: no cover
        swallowed("telemetry.host_id", exc)
    return 0


# ---------------------------------------------------------------------------
# Structured trace events (per-host JSONL)
# ---------------------------------------------------------------------------

def configure(dir=None, host=None, snapshot_interval=None):
    """Enable (or with ``dir=None`` disable) the event log + periodic
    metric snapshots. ``snapshot_interval`` seconds between per-host
    ``.prom`` snapshot rewrites (default ``MXNET_TELEMETRY_INTERVAL`` or
    30; 0 disables the background writer — :func:`flush`/exit still
    write one)."""
    # slow work (makedirs — the dir may be NFS — env parsing, thread
    # object construction) happens BEFORE the lock: every metric op in
    # every thread contends on _lock, so it must only be held for the
    # state swap itself. The whole stop-old/replace sequence then holds
    # _lock once, so two racing configure() calls can never leave a
    # leaked snap_loop thread whose stop Event was overwritten. Only
    # t.start() runs after — if a third configure() signals our stop
    # Event in that window, snap_loop's first wait() returns True and
    # the thread exits immediately.
    new_dir = os.path.abspath(dir) if dir else None
    t = stop = None
    if new_dir is not None:
        os.makedirs(new_dir, exist_ok=True)
        if snapshot_interval is None:
            snapshot_interval = float(
                os.environ.get("MXNET_TELEMETRY_INTERVAL", "30"))
        if snapshot_interval > 0:
            stop = threading.Event()

            def snap_loop():
                while not stop.wait(snapshot_interval):
                    try:
                        write_snapshot()
                    except Exception as exc:  # pragma: no cover
                        swallowed("telemetry.snap_loop", exc)
                        return

            t = threading.Thread(target=snap_loop, daemon=True,
                                 name="mxnet_tpu_torch-telemetry-snapshot")
    with _lock:
        fh, _state["events_fh"] = _state["events_fh"], None
        _state["events_path"] = None
        if fh is not None:
            try:
                fh.close()
            except OSError:  # pragma: no cover
                pass
        old_stop = _state["snap_stop"]
        if old_stop is not None:
            old_stop.set()
        _state["dir"] = new_dir
        _state["snap_stop"] = stop
        _state["snap_thread"] = t
        if host is not None:
            _state["host_id"] = int(host)
    if t is not None:
        t.start()


def configured_dir():
    return _state["dir"]


def _event_fh():
    """Lazily opened per-process JSONL handle (host id resolved at first
    event; every line also carries it, so merge never trusts filenames)."""
    with _lock:
        if _state["dir"] is None:
            return None
        fh = _state["events_fh"]
        if fh is None:
            path = os.path.join(
                _state["dir"],
                "events_host%d_pid%d.jsonl" % (host_id(), os.getpid()))
            fh = open(path, "a", encoding="utf-8")
            _state["events_fh"] = fh
            _state["events_path"] = path
        return fh


_taps = []   # in-process event subscribers (e.g. the flight recorder)


def add_tap(cb):
    """Subscribe ``cb(record_dict)`` to every event/span record, even
    when no event-log dir is configured (`xla_stats.flight_recorder`
    rides on this). Idempotent per callback."""
    with _lock:
        if cb not in _taps:
            _taps.append(cb)


def remove_tap(cb):
    with _lock:
        if cb in _taps:
            _taps.remove(cb)


def _tap(rec):
    for cb in list(_taps):
        try:
            cb(rec)
        except Exception as exc:  # a broken subscriber must not break a span
            swallowed("telemetry.tap", exc)


def _emit(rec):
    # the observability layer must never take the training step down
    # with it: a full disk or deleted telemetry dir degrades to dropped
    # events, not an exception inside kvstore.push / chaos.fire / fit
    try:
        fh = _event_fh()
        if fh is None:
            return
        line = json.dumps(rec, default=str)
        with _lock:
            if _state["events_fh"] is not fh:  # reconfigured mid-write
                return
            fh.write(line + "\n")
            fh.flush()  # chaos kills are the point: lines must be durable
    except Exception as exc:
        swallowed("telemetry.emit", exc)


def event(name, **args):
    """Record an instant event (JSONL + taps; no registry side
    effect)."""
    rec = {"name": name, "ph": "i", "ts": time.time(),
           "mono": time.monotonic(), "pid": os.getpid(),
           "host": host_id(), "tid": threading.get_ident() & 0xFFFFFF,
           "args": args}
    _tap(rec)
    _emit(rec)


def record_span(name, wall_ts, dur, mono=None, **args):
    """Append one retrospective complete ("X") span — for work whose
    start and duration the caller measured itself, reconstructed after
    the fact (the serving engine emits per-request anatomy at resolve
    time, not inline — a `span` context manager cannot bracket a
    request that flows through three threads).

    Linkage convention: correlating ids ride in ``args`` (``rid=`` for
    a request, ``batch=`` for the micro-batch that served it), so
    chrome-trace consumers can join ``serving.request`` spans to the
    ``serving.batch`` spans that carried them. No registry side effect:
    retrospective callers own their histograms."""
    if _state["dir"] is None and not _taps:
        return
    rec = {"name": name, "ph": "X", "ts": float(wall_ts),
           "mono": float(mono) if mono is not None else None,
           "dur": float(dur), "pid": os.getpid(), "host": host_id(),
           "tid": threading.get_ident() & 0xFFFFFF, "args": args}
    _tap(rec)
    _emit(rec)


class span:
    """Context manager timing a region.

    Always folds the duration into a ``<name>_seconds`` histogram;
    when an event log is configured, also appends one complete ("X")
    JSONL event carrying ``attrs`` (extend mid-span with
    ``sp["key"] = value``)."""

    __slots__ = ("name", "attrs", "_t0", "_wall")

    def __init__(self, name, **attrs):
        self.name = name
        self.attrs = attrs

    def __setitem__(self, key, value):
        self.attrs[key] = value

    def __enter__(self):
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        histogram(_sanitize(self.name) + "_seconds").observe(dur)
        if exc is not None:
            self.attrs["error"] = "%s: %s" % (type(exc).__name__,
                                              str(exc)[:200])
        if _state["dir"] is not None or _taps:
            rec = {"name": self.name, "ph": "X", "ts": self._wall,
                   "mono": self._t0, "dur": dur, "pid": os.getpid(),
                   "host": host_id(),
                   "tid": threading.get_ident() & 0xFFFFFF,
                   "args": self.attrs}
            _tap(rec)
            _emit(rec)
        return None


def write_snapshot(path=None):
    """Write the Prometheus text snapshot; default path is the configured
    dir's ``metrics_host<h>_pid<p>.prom``. Returns the path (None when
    nothing is configured and no path was given)."""
    if path is None:
        if _state["dir"] is None:
            return None
        path = os.path.join(
            _state["dir"],
            "metrics_host%d_pid%d.prom" % (host_id(), os.getpid()))
    # tmp name unique per writer: the periodic thread and an exit-path
    # flush() may snapshot concurrently, and sharing one tmp would let
    # the loser truncate the freshly published file
    tmp = "%s.tmp%d" % (path, threading.get_ident())
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(dumps())
    os.replace(tmp, path)  # snapshot readers never see a torn write
    return path


def write_host_json(prefix, doc, dir=None):
    """THE per-host JSON snapshot transport: write ``doc`` as
    ``<prefix>_host<h>_pid<p>.json`` under ``dir`` (default: the
    configured telemetry dir; None and no dir -> no-op, returns None).
    Atomic replace with a per-thread tmp name, like
    :func:`write_snapshot`, so readers never see a torn file and two
    same-process writers (a periodic exporter and an atexit flush)
    cannot tear each other's publication. stepprof, serving/reqtrace,
    and shardprof all ride this one implementation."""
    dir = dir or configured_dir()
    if dir is None:
        return None
    os.makedirs(dir, exist_ok=True)
    path = os.path.join(dir, "%s_host%d_pid%d.json"
                        % (prefix, host_id(), os.getpid()))
    tmp = "%s.tmp%d" % (path, threading.get_ident())
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, default=str)
    os.replace(tmp, path)
    return path


def merge_host_json(prefix, dir=None):
    """Read every ``<prefix>_host*.json`` under ``dir`` (default: the
    configured telemetry dir, then ``MXNET_TELEMETRY_DIR``), keeping the
    freshest snapshot per host by the docs' ``updated`` stamp. Torn or
    garbage files from a killed writer are skipped, not fatal. Returns
    ``{host_id: doc}``."""
    dir = dir or configured_dir() or os.environ.get("MXNET_TELEMETRY_DIR")
    if not dir or not os.path.isdir(dir):
        return {}
    hosts = {}
    for fn in sorted(os.listdir(dir)):
        if not (fn.startswith(prefix + "_host") and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(dir, fn), "r", encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        try:
            h = int(doc.get("host", 0))
        except (TypeError, ValueError):
            continue
        if h not in hosts or doc.get("updated", 0) > \
                hosts[h].get("updated", 0):
            hosts[h] = doc
    return hosts


def flush():
    """Flush the event log and write a metrics snapshot NOW. Safe (and
    cheap) when telemetry is unconfigured; call before ``os._exit`` so
    watchdog/chaos deaths leave durable telemetry behind."""
    try:
        with _lock:
            fh = _state["events_fh"]
            if fh is not None:
                fh.flush()
        write_snapshot()
    except Exception:  # pragma: no cover - never break the exit path
        pass


atexit.register(flush)


# ---------------------------------------------------------------------------
# Export: chrome-trace JSON + multi-host merge
# ---------------------------------------------------------------------------

def read_events(path):
    """Parse one JSONL event file (corrupt trailing lines from a killed
    writer are skipped, not fatal)."""
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def _event_files(src):
    if isinstance(src, (list, tuple)):
        return list(src)
    if os.path.isfile(src):
        return [src]
    return sorted(
        os.path.join(src, fn) for fn in os.listdir(src)
        if fn.endswith(".jsonl"))


def to_chrome(events):
    """Convert parsed events to a chrome-trace dict (perfetto /
    chrome://tracing). Each distinct (host, os-pid) becomes one trace
    process row named ``host<h>/pid<p>``; timestamps are the events'
    wall clocks (the only clock comparable across hosts), microseconds."""
    procs = {}   # (host, pid) -> chrome pid
    threads = {}  # (chrome pid, raw tid) -> chrome tid
    trace = []
    for ev in sorted(events, key=lambda e: e.get("ts", 0.0)):
        key = (ev.get("host", 0), ev.get("pid", 0))
        cpid = procs.get(key)
        if cpid is None:
            cpid = procs[key] = len(procs) + 1
            trace.append({"name": "process_name", "ph": "M", "pid": cpid,
                          "args": {"name": "host%d/pid%d" % key}})
        tkey = (cpid, ev.get("tid", 0))
        ctid = threads.get(tkey)
        if ctid is None:
            ctid = sum(1 for k in threads if k[0] == cpid) + 1
            threads[tkey] = ctid
        rec = {"name": ev.get("name", "?"), "ph": ev.get("ph", "i"),
               "ts": ev.get("ts", 0.0) * 1e6, "pid": cpid, "tid": ctid,
               "args": ev.get("args", {})}
        if rec["ph"] == "X":
            rec["dur"] = ev.get("dur", 0.0) * 1e6
        elif rec["ph"] == "i":
            rec["s"] = "p"
        trace.append(rec)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def merge(src=None, out=None):
    """Stitch per-host JSONL event logs into ONE chrome-trace timeline.

    ``src``: a directory of ``*.jsonl`` files (default: the configured
    telemetry dir), one file, or an explicit list of paths. ``out``:
    optional path for the chrome-trace JSON (open it in perfetto.dev).
    Returns the trace dict."""
    src = src if src is not None else _state["dir"]
    if src is None:
        raise ValueError("no src given and no telemetry dir configured")
    events = []
    for path in _event_files(src):
        events.extend(read_events(path))
    trace = to_chrome(events)
    if out:
        with open(out, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
    return trace


if os.environ.get("MXNET_TELEMETRY_DIR"):
    try:
        configure(os.environ["MXNET_TELEMETRY_DIR"])
    except Exception as _exc:  # unwritable dir must not kill the import
        import warnings
        warnings.warn("MXNET_TELEMETRY_DIR=%r could not be enabled (%s); "
                      "telemetry event log disabled"
                      % (os.environ["MXNET_TELEMETRY_DIR"], _exc))
        configure(None)
