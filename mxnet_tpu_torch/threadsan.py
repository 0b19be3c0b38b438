"""A runtime lock witness for the port's own locks.

Counterpart of `mxnet_tpu/threadsan.py`, host code only:

- **arming**: ``MXNET_THREADSAN=1`` at process start. When off (the
  default), :func:`register` returns the original lock object unchanged:
  nothing is wrapped, no state is kept, no atexit hook is installed.
  Subsystems register their locks at creation:
  ``_lock = threadsan.register("telemetry._lock", threading.RLock())``.
- **acquisition-order witness**: every armed lock records per-thread
  acquisition-order edges (holding A while acquiring B is an edge A->B)
  with the acquiring stack; a cycle in the edge graph is a *potential
  deadlock* report carrying the stacks of both sides of the cycle.
- **wait/hold anatomy**: ``lock_wait_seconds{lock=}`` /
  ``lock_hold_seconds{lock=}`` telemetry histograms and
  ``lock_contention_total{lock=}`` counters (a thread-local busy guard
  keeps the telemetry registry's own armed lock from recursing).
- **held-across-dispatch**: :func:`note_dispatch` is called from the
  ``CompiledProgram`` dispatch entry and the sampled
  ``torch.cuda.synchronize`` bracket; a registered lock held there is a
  report.
- **blocked-too-long watchdog**: a blocking acquire that waits longer
  than ``MXNET_THREADSAN_BLOCK_SECONDS`` (default 15) records a report
  and dumps the flight recorder.

Witness files ride the per-host snapshot transport
(``telemetry.write_host_json``) as ``threadsan_host<h>_pid<p>.json``;
``python -m mxnet_tpu_torch.threadsan report [path|dir]`` renders them.

Lock order: this module has one internal lock, ``_wlock``, guarding the
witness state; it is never registered, and nothing else is acquired
while it is held (telemetry writes happen outside it, under the
per-thread busy guard).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

__all__ = ["ARMED", "register", "arm", "disarm", "reset", "enabled",
           "note_dispatch", "snapshot", "write_witness", "report",
           "main"]

#: armed at import from MXNET_THREADSAN=1; tests flip it via arm()/
#: disarm() BEFORE creating the locks they register (arming never
#: retroactively wraps locks registered while off)
ARMED = os.environ.get("MXNET_THREADSAN", "") == "1"

#: frames kept per captured stack (innermost project frames)
_STACK_DEPTH = 8

_tl = threading.local()
_wlock = threading.Lock()
_wit = {
    "edges": {},     # (outer, inner) -> {count, site, stack, thread}
    "reports": [],   # potential_deadlock / held_across_dispatch / ...
    "stats": {},     # name -> acquires/contended/wait/hold aggregates
    "seen": set(),   # report dedup keys
}
_atexit_installed = False
#: lock labels registered dispatch_ok=True — exempt from
#: held-across-dispatch reports (they serialize work that dispatches
#: by design); deadlock edges and wait/hold anatomy still record
_dispatch_ok = set()


def enabled():
    """True when the sanitizer is armed for this process."""
    return ARMED


def _tls():
    tl = _tl
    if not hasattr(tl, "held"):
        tl.held = []     # [_Held] acquisition order, outermost first
        tl.busy = False  # re-entrancy guard for telemetry/dump calls
    return tl


def _block_seconds():
    try:
        return float(os.environ.get("MXNET_THREADSAN_BLOCK_SECONDS",
                                    "") or 15.0)
    except ValueError:
        return 15.0


def _capture_stack():
    """Innermost project frames as ``path:line (fn)`` strings, this
    module's own frames dropped."""
    out = []
    for fr in traceback.extract_stack()[:-1]:
        if os.path.basename(fr.filename) == "threadsan.py":
            continue
        out.append("%s:%d (%s)" % (fr.filename, fr.lineno, fr.name))
    return out[-_STACK_DEPTH:]


class _Held:
    __slots__ = ("name", "t0", "count")

    def __init__(self, name, t0):
        self.name = name
        self.t0 = t0
        self.count = 1


def _stats(name):
    st = _wit["stats"].get(name)
    if st is None:
        st = _wit["stats"][name] = {
            "acquires": 0, "contended": 0,
            "wait_total": 0.0, "wait_max": 0.0,
            "hold_total": 0.0, "hold_max": 0.0,
        }
    return st


def _observe(metric, name, value):
    """Publish into telemetry under the busy guard (the registry's own
    lock may itself be armed — without the guard this recurses)."""
    tl = _tls()
    if tl.busy:
        return
    tl.busy = True
    try:
        from . import telemetry
        telemetry.histogram(metric, lock=name).observe(value)
    except Exception:
        pass
    finally:
        tl.busy = False


def _count_contention(name):
    tl = _tls()
    if tl.busy:
        return
    tl.busy = True
    try:
        from . import telemetry
        telemetry.counter("lock_contention_total", lock=name).inc()
    except Exception:
        pass
    finally:
        tl.busy = False


def _find_cycle(start, target):
    """DFS over the edge graph: a path start -> ... -> target means
    adding edge (target -> start) closes a cycle. Returns the node path
    [start, ..., target] or None. Caller holds ``_wlock``."""
    adj = {}
    for (a, b) in _wit["edges"]:
        adj.setdefault(a, []).append(b)
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == target:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in adj.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


def _record_acquired(name, wait, contended):
    """Bookkeeping after a lock is newly acquired on this thread:
    stats, acquisition-order edges, cycle detection."""
    tl = _tls()
    stack = None
    report = None
    with _wlock:
        st = _stats(name)
        st["acquires"] += 1
        st["wait_total"] += wait
        st["wait_max"] = max(st["wait_max"], wait)
        if contended:
            st["contended"] += 1
        for held in tl.held:
            if held.name == name:
                continue
            key = (held.name, name)
            rec = _wit["edges"].get(key)
            if rec is None:
                if stack is None:
                    stack = _capture_stack()
                _wit["edges"][key] = {
                    "count": 1,
                    "site": stack[-1] if stack else "",
                    "stack": stack,
                    "thread": threading.current_thread().name,
                }
                # a path name -> ... -> held.name means this new edge
                # (held.name -> name) closes a cycle: potential deadlock
                path = _find_cycle(name, held.name)
                if path is not None:
                    cyc = tuple(sorted(set([held.name] + path)))
                    if cyc not in _wit["seen"]:
                        _wit["seen"].add(cyc)
                        edges = list(zip(path, path[1:])) + [key[::-1]]
                        stacks = {}
                        for a, b in edges:
                            e = _wit["edges"].get((a, b))
                            if e is not None:
                                stacks["%s -> %s" % (a, b)] = {
                                    "thread": e["thread"],
                                    "stack": e["stack"],
                                }
                        stacks["%s -> %s" % key] = {
                            "thread": threading.current_thread().name,
                            "stack": stack,
                        }
                        report = {
                            "kind": "potential_deadlock",
                            "cycle": [held.name] + path,
                            "locks": sorted(set([held.name] + path)),
                            "stacks": stacks,
                            "time": time.time(),
                        }
                        _wit["reports"].append(report)
            else:
                rec["count"] += 1
        tl.held.append(_Held(name, time.monotonic()))
    if contended:
        _count_contention(name)
    _observe("lock_wait_seconds", name, wait)
    return report


def _record_released(name):
    tl = _tls()
    hold = None
    for i in range(len(tl.held) - 1, -1, -1):
        if tl.held[i].name == name:
            hold = time.monotonic() - tl.held[i].t0
            del tl.held[i]
            break
    if hold is None:
        return
    with _wlock:
        st = _stats(name)
        st["hold_total"] += hold
        st["hold_max"] = max(st["hold_max"], hold)
    _observe("lock_hold_seconds", name, hold)


def _report_once(kind, key, doc):
    with _wlock:
        if key in _wit["seen"]:
            return False
        _wit["seen"].add(key)
        doc = dict(doc, kind=kind, time=time.time())
        _wit["reports"].append(doc)
    return True


def _dump_flight_recorder(reason):
    tl = _tls()
    if tl.busy:
        return
    tl.busy = True
    try:
        from . import xla_stats
        xla_stats.dump_flight_recorder(reason)
    except Exception:
        pass
    finally:
        tl.busy = False


class LockWitness:
    """Proxy around one registered lock. Context-manager and
    acquire/release compatible with Lock/RLock/Condition; Condition
    ``wait``/``wait_for`` are bracketed as release+reacquire so the
    hold clock matches what other threads can observe."""

    __slots__ = ("_lock", "name", "_reentrant")

    def __init__(self, lock, name):
        self._lock = lock
        self.name = name
        self._reentrant = isinstance(
            lock, (type(threading.RLock()), threading.Condition))

    # -- core bracket -----------------------------------------------------

    def _depth(self):
        tl = _tls()
        for held in tl.held:
            if held.name == self.name:
                return held
        return None

    def acquire(self, blocking=True, timeout=-1):
        tl = _tls()
        if tl.busy:
            return self._lock.acquire(blocking, timeout)
        held = self._depth()
        if held is not None and self._reentrant:
            got = self._lock.acquire(blocking, timeout)
            if got:
                held.count += 1
            return got
        t0 = time.monotonic()
        got = self._lock.acquire(False)
        contended = not got
        if not got:
            if not blocking:
                with _wlock:
                    _stats(self.name)["contended"] += 1
                _count_contention(self.name)
                return False
            block_s = _block_seconds()
            deadline = (None if timeout is None or timeout < 0
                        else t0 + timeout)
            warned = False
            while not got:
                step = block_s
                if deadline is not None:
                    step = min(step, deadline - time.monotonic())
                    if step <= 0:
                        with _wlock:
                            _stats(self.name)["contended"] += 1
                        _count_contention(self.name)
                        return False
                got = self._lock.acquire(True, step)
                waited = time.monotonic() - t0
                if not got and not warned and waited >= block_s:
                    warned = True
                    if _report_once(
                            "blocked_too_long",
                            ("blocked", self.name,
                             threading.current_thread().name),
                            {"lock": self.name,
                             "waited_seconds": waited,
                             "thread": threading.current_thread().name,
                             "holder_unknown": True,
                             "stack": _capture_stack()}):
                        _dump_flight_recorder(
                            "threadsan.blocked_too_long:%s" % self.name)
        _record_acquired(self.name, time.monotonic() - t0, contended)
        return True

    def release(self):
        tl = _tls()
        if tl.busy:
            return self._lock.release()
        held = self._depth()
        if held is not None and held.count > 1:
            held.count -= 1
            return self._lock.release()
        self._lock.release()
        _record_released(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()

    def _is_owned(self):
        # threading.Condition asks this of the lock it rides; without it
        # the default probe does a speculative acquire(False) that would
        # count phantom contention in the witness stats
        inner = getattr(self._lock, "_is_owned", None)
        if inner is not None:
            return inner()
        return self._depth() is not None

    # -- Condition surface ------------------------------------------------

    def wait(self, timeout=None):
        # the underlying Condition releases its lock for the duration:
        # end the hold bracket so hold histograms measure what OTHER
        # threads actually contend with, then re-open it on wakeup
        _record_released(self.name)
        try:
            return self._lock.wait(timeout)
        finally:
            _record_acquired(self.name, 0.0, False)

    def wait_for(self, predicate, timeout=None):
        _record_released(self.name)
        try:
            return self._lock.wait_for(predicate, timeout)
        finally:
            _record_acquired(self.name, 0.0, False)

    def notify(self, n=1):
        return self._lock.notify(n)

    def notify_all(self):
        return self._lock.notify_all()

    def __getattr__(self, attr):
        return getattr(self._lock, attr)

    def __repr__(self):
        return "LockWitness(%r, %r)" % (self.name, self._lock)


def register(name, lock, dispatch_ok=False):
    """Register a project lock under a stable label. Armed: returns a
    :class:`LockWitness` proxy; off: returns ``lock`` unchanged (the
    zero-overhead contract — callers keep the exact object they made).

    ``dispatch_ok=True`` exempts the lock from held-across-dispatch
    reports: some locks exist precisely to serialize work that itself
    dispatches (a program's compile lock held across the trace of a
    nested program). Deadlock edges and wait/hold anatomy still record.
    """
    if dispatch_ok:
        _dispatch_ok.add(name)
    if not ARMED:
        return lock
    if isinstance(lock, LockWitness):
        return lock
    global _atexit_installed
    if not _atexit_installed:
        _atexit_installed = True
        import atexit
        atexit.register(_atexit_witness)
    return LockWitness(lock, name)


def held_locks():
    """Labels of registered locks the CURRENT thread holds, outermost
    first (empty when off)."""
    if not ARMED:
        return []
    return [h.name for h in _tls().held]


def note_dispatch(site, kind="dispatch"):
    """Record a held-across-dispatch report when the current thread
    enters a compiled dispatch (or a ``block_until_ready`` bracket,
    ``kind='sync'``) while holding any registered lock. Call sites
    guard with ``if threadsan.ARMED:`` so the off path costs one
    attribute read."""
    if not ARMED:
        return None
    tl = _tls()
    if tl.busy or not tl.held:
        return None
    locks = [h.name for h in tl.held if h.name not in _dispatch_ok]
    if not locks:
        return None
    key = ("dispatch", kind, site, tuple(locks))
    doc = {"site": site, "dispatch_kind": kind, "locks": locks,
           "thread": threading.current_thread().name,
           "stack": _capture_stack()}
    return doc if _report_once("held_across_dispatch", key, doc) else None


# ---------------------------------------------------------------------------
# Arming control (tests) and state
# ---------------------------------------------------------------------------

def arm():
    """Arm for locks registered FROM NOW ON (tests). Does not wrap
    locks already registered while off."""
    global ARMED
    ARMED = True


def disarm():
    global ARMED
    ARMED = False


def reset():
    """Drop all witness state (tests)."""
    with _wlock:
        _wit["edges"].clear()
        _wit["reports"][:] = []
        _wit["stats"].clear()
        _wit["seen"].clear()


# ---------------------------------------------------------------------------
# Witness export + report CLI
# ---------------------------------------------------------------------------

def snapshot():
    """The witness document this process would export."""
    with _wlock:
        edges = [dict(outer=a, inner=b, count=rec["count"],
                      site=rec["site"], thread=rec["thread"])
                 for (a, b), rec in sorted(_wit["edges"].items())]
        doc = {
            "host": 0, "pid": os.getpid(), "updated": time.time(),
            "armed": ARMED,
            "locks": {k: dict(v) for k, v in
                      sorted(_wit["stats"].items())},
            "edges": edges,
            "reports": [dict(r) for r in _wit["reports"]],
        }
    try:
        from . import telemetry
        doc["host"] = telemetry.host_id()
    except Exception:
        pass
    return doc


def write_witness(dir=None):
    """Write ``threadsan_host<h>_pid<p>.json`` on the shared per-host
    snapshot transport. ``dir`` defaults to ``MXNET_THREADSAN_DIR``
    (a witness-only destination that leaves the global telemetry dir
    alone — tests monkeypatch ``MXNET_TELEMETRY_DIR`` and must keep
    owning it), then the configured telemetry dir, then
    ``MXNET_TELEMETRY_DIR``. Returns the path or None."""
    from . import telemetry
    dir = (dir or os.environ.get("MXNET_THREADSAN_DIR")
           or telemetry.configured_dir()
           or os.environ.get("MXNET_TELEMETRY_DIR") or None)
    if dir is None:
        return None
    return telemetry.write_host_json("threadsan", snapshot(), dir=dir)


def _atexit_witness():
    try:
        write_witness()
    except Exception:   # exit path must never crash harder
        pass


def load_witness(path_or_dir):
    """Witness docs from one file or every ``threadsan_host*.json`` in
    a dir (freshest per host). Returns ``[doc]`` (possibly empty)."""
    if os.path.isfile(path_or_dir):
        with open(path_or_dir, "r", encoding="utf-8") as fh:
            return [json.load(fh)]
    from . import telemetry
    hosts = telemetry.merge_host_json("threadsan", dir=path_or_dir)
    return [hosts[h] for h in sorted(hosts)]


def report(path_or_dir=None, out=None):
    """Human report over witness file(s): per-lock wait/hold table,
    acquisition-order edges, and every recorded hazard with stacks.
    Exit code 1 when any potential-deadlock / held-across-dispatch /
    blocked-too-long report is present."""
    out = out or sys.stdout
    path_or_dir = (path_or_dir
                   or os.environ.get("MXNET_THREADSAN_DIR")
                   or os.environ.get("MXNET_TELEMETRY_DIR") or "")
    docs = load_witness(path_or_dir) if path_or_dir else [snapshot()]
    if not docs:
        out.write("threadsan: no witness files under %r\n" % path_or_dir)
        return 2
    reports = []
    out.write("threadsan witness -- %d host(s)\n" % len(docs))
    for doc in docs:
        out.write("host %s pid %s:\n" % (doc.get("host"),
                                         doc.get("pid")))
        locks = doc.get("locks") or {}
        if locks:
            out.write("  %-42s %8s %9s %10s %10s\n"
                      % ("lock", "acquires", "contended",
                         "wait_max_s", "hold_max_s"))
            for name, st in sorted(
                    locks.items(),
                    key=lambda kv: -kv[1].get("wait_total", 0.0)):
                out.write("  %-42s %8d %9d %10.4f %10.4f\n"
                          % (name, st.get("acquires", 0),
                             st.get("contended", 0),
                             st.get("wait_max", 0.0),
                             st.get("hold_max", 0.0)))
        for e in doc.get("edges") or []:
            out.write("  edge: %s -> %s (x%d) at %s\n"
                      % (e["outer"], e["inner"], e["count"],
                         e.get("site", "?")))
        for r in doc.get("reports") or []:
            reports.append(r)
            out.write("  [%s] %s\n"
                      % (r.get("kind"),
                         " -> ".join(r.get("cycle", []))
                         or r.get("lock")
                         or "+".join(r.get("locks", []))))
            stacks = r.get("stacks")
            if isinstance(stacks, dict):
                for label, side in sorted(stacks.items()):
                    out.write("    %s [thread %s]\n"
                              % (label, side.get("thread")))
                    for fr in side.get("stack") or []:
                        out.write("      %s\n" % fr)
            elif r.get("stack"):
                for fr in r["stack"]:
                    out.write("      %s\n" % fr)
    if reports:
        kinds = sorted({r.get("kind", "?") for r in reports})
        out.write("verdict: %d hazard report(s) (%s)\n"
                  % (len(reports), ", ".join(kinds)))
        return 1
    out.write("verdict: clean (no hazard reports)\n")
    return 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.threadsan",
        description="Lock-witness report: wait/hold anatomy, "
                    "acquisition-order edges, deadlock/dispatch hazards")
    ap.add_argument("command", choices=["report"],
                    help="'report': render witness file(s)")
    ap.add_argument("path", nargs="?", default=None,
                    help="threadsan_host*.json file or a telemetry dir "
                         "(default: MXNET_TELEMETRY_DIR, then the live "
                         "process)")
    args = ap.parse_args(argv)
    return report(args.path)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
