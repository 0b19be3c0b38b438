"""Deterministic fault injection.

Counterpart of `mxnet_tpu/chaos.py`: a registry of named *sites* that
code polls at its failure points. A site stays silent until armed, so a
poll costs one dict lookup on the happy path.

Arming is deterministic (fire on the Nth poll, M times), in-process
(:func:`arm` / :func:`armed`) or across process boundaries through the
``MXNET_CHAOS`` environment variable::

    MXNET_CHAOS="memory.oom@6"              # fire on the 7th poll
    MXNET_CHAOS="memory.oom@0x2=1073741824" # first 2 polls, 1 GiB

Spec grammar: ``site[@after][xN][=value]``: skip ``after`` polls, then
fire ``N`` times (default 1) carrying ``value``; comma-separated
entries.

The port polls the ``memory.oom`` site, from memprof's dispatch hook
(`memprof.on_dispatch`), and the serving engine's
``serving.slow_request`` and ``serving.worker_death`` sites before each
batch (`serving/engine.py`); the other sites of the registry keep their
names so that a spec written for the JAX package parses here too.
"""
from __future__ import annotations

import logging
import os
import re
import threading
from contextlib import contextmanager

from . import telemetry

__all__ = ["arm", "armed", "arm_from_env", "clear", "fire", "fired",
           "is_armed", "ChaosError", "ChaosTimeout", "ChaosInterrupt",
           "maybe_timeout", "maybe_die", "maybe_interrupt_checkpoint",
           "maybe_step_fail", "heartbeat_extra_delay", "SITES",
           "DEAD_EXIT_CODE"]

SITES = {
    "coordinator.timeout": "ChaosTimeout from coordinator KV ops, "
                           "barrier, and dist.init",
    "heartbeat.delay": "stall the heartbeat writer by VALUE seconds "
                       "(default 1.0)",
    "worker.death": "os._exit(VALUE, default 17) at the elastic step "
                    "boundary — a crashed worker, no cleanup",
    "checkpoint.interrupt": "ChaosInterrupt after checkpoint data is "
                            "written but before the commit marker — a "
                            "torn checkpoint",
    "step.fail": "ChaosError from inside the training step",
    "serving.slow_request": "stall a serving replica worker for VALUE "
                            "seconds (default 0.5) before it computes a "
                            "batch — a straggler device",
    "serving.worker_death": "kill a serving replica worker thread at the "
                            "batch boundary — the in-flight batch must "
                            "fail cleanly and the worker respawn",
    "memory.oom": "raise a synthetic CUDA out-of-memory error at "
                  "CompiledProgram dispatch and at each step of the "
                  "Module (VALUE = requested bytes, default 1 GiB) so "
                  "memprof's OOM forensics are testable on the CPU",
}

#: exit code used by an injected worker death (distinct from the elastic
#: watchdog's RESTART_EXIT_CODE so logs tell the two apart)
DEAD_EXIT_CODE = 17


class ChaosError(RuntimeError):
    """Base class for injected failures."""


class ChaosTimeout(ChaosError, TimeoutError):
    """Injected coordinator timeout (retryable transient)."""


class ChaosInterrupt(ChaosError):
    """Injected interruption of a checkpoint write."""


class _Trigger:
    __slots__ = ("site", "after", "times", "value", "calls", "hits")

    def __init__(self, site, after=0, times=1, value=None):
        self.site = site
        self.after = int(after)
        self.times = int(times)
        self.value = value
        self.calls = 0
        self.hits = 0

    def poll(self):
        self.calls += 1
        if self.calls > self.after and self.hits < self.times:
            self.hits += 1
            return True
        return False


_lock = threading.Lock()
_triggers = {}  # site -> [_Trigger]
_fired = {}     # site -> total injections

_SPEC_RE = re.compile(
    r"^(?P<site>[a-z_.]+)(?:@(?P<after>\d+))?(?:x(?P<times>\d+))?"
    r"(?:=(?P<value>.+))?$")


def _check_site(site):
    if site not in SITES:
        raise ValueError("unknown chaos site %r (known: %s)"
                         % (site, ", ".join(sorted(SITES))))


def arm(site, after=0, times=1, value=None):
    """Arm ``site`` to fire on polls ``after+1 .. after+times``."""
    _check_site(site)
    trig = _Trigger(site, after=after, times=times, value=value)
    with _lock:
        _triggers.setdefault(site, []).append(trig)
    return trig


def arm_from_env(spec=None):
    """Parse an ``MXNET_CHAOS``-style spec string and arm each entry.
    Called once at import so subprocesses armed via env need no code."""
    spec = os.environ.get("MXNET_CHAOS", "") if spec is None else spec
    for entry in filter(None, (s.strip() for s in spec.split(","))):
        m = _SPEC_RE.match(entry)
        if m is None:
            raise ValueError("bad MXNET_CHAOS entry %r "
                             "(want site[@after][xN][=value])" % entry)
        arm(m.group("site"), after=int(m.group("after") or 0),
            times=int(m.group("times") or 1), value=m.group("value"))


def clear(site=None):
    """Disarm ``site`` (or every site) and reset fired counters."""
    with _lock:
        if site is None:
            _triggers.clear()
            _fired.clear()
        else:
            _triggers.pop(site, None)
            _fired.pop(site, None)


def is_armed(site):
    with _lock:
        return any(t.hits < t.times for t in _triggers.get(site, ()))


def fired(site):
    """How many times ``site`` actually injected (for test assertions)."""
    with _lock:
        return _fired.get(site, 0)


_NO_FIRE = object()


def fire(site):
    """Poll an injection point. Returns ``None`` when nothing injects;
    otherwise the armed value (``True`` when no value was given). Every
    injection is counted in the telemetry registry
    (``chaos_injections_total{site=...}``) so tests assert exact counts
    instead of scraping logs."""
    _check_site(site)
    result = _NO_FIRE
    with _lock:
        for trig in _triggers.get(site, ()):
            if trig.poll():
                _fired[site] = _fired.get(site, 0) + 1
                logging.warning("chaos: firing %s (hit %d/%d, value=%r)",
                                site, trig.hits, trig.times, trig.value)
                result = True if trig.value is None else trig.value
                break
    if result is _NO_FIRE:
        return None
    telemetry.counter("chaos_injections_total",
                      help="fault injections delivered, by site",
                      site=site).inc()
    telemetry.event("chaos.injection", site=site, value=result)
    return result


@contextmanager
def armed(site, after=0, times=1, value=None):
    """Context manager: arm for the block, disarm that trigger on exit."""
    trig = arm(site, after=after, times=times, value=value)
    try:
        yield trig
    finally:
        with _lock:
            lst = _triggers.get(site, [])
            if trig in lst:
                lst.remove(trig)


# -- convenience raisers for the standard sites -----------------------------

def maybe_timeout(where=""):
    if fire("coordinator.timeout") is not None:
        raise ChaosTimeout("chaos: injected coordinator timeout%s"
                           % (" (%s)" % where if where else ""))


def maybe_die():
    val = fire("worker.death")
    if val is not None:
        code = DEAD_EXIT_CODE if val is True else int(val)
        logging.warning("chaos: worker death, os._exit(%d)", code)
        try:
            # post-mortem ring of recent events; a lazy import keeps
            # chaos importable without torch
            from . import xla_stats
            xla_stats.dump_flight_recorder("chaos.worker.death",
                                           error="os._exit(%d)" % code)
        except Exception as exc:
            # best-effort post-mortem on a deliberate death path: the
            # dump failing must not stop the exit, but it stays counted
            telemetry.swallowed("chaos.flight_recorder", exc)
        telemetry.flush()  # os._exit skips atexit; keep the logs durable
        os._exit(code)


def maybe_interrupt_checkpoint(path=""):
    if fire("checkpoint.interrupt") is not None:
        raise ChaosInterrupt(
            "chaos: checkpoint write interrupted before commit marker%s"
            % (" at %s" % path if path else ""))


def maybe_step_fail(step=None):
    if fire("step.fail") is not None:
        raise ChaosError("chaos: injected step failure%s"
                         % ("" if step is None else " at step %s" % step))


def heartbeat_extra_delay():
    val = fire("heartbeat.delay")
    if val is None:
        return 0.0
    return 1.0 if val is True else float(val)


arm_from_env()
