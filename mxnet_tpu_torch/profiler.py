"""Profiler.

Counterpart of `mxnet_tpu/profiler.py` (reference
`python/mxnet/profiler.py`: set_config/set_state/dump/dumps/pause/resume)
and `src/profiler/`:

- Tracing runs ``torch.profiler.profile`` over the CPU and, where there
  is one, the CUDA device; stopping it exports a chrome trace
  (``trace_<pid>_<n>.pt.trace.json``) into the configured directory
  (``<filename>_trace``), which perfetto.dev and chrome://tracing render
  and :func:`device_dumps` (`xplane.py`) reads into a per-kernel
  device-time table. ``MXNET_PROFILER_AUTOSTART=1`` starts a trace at
  import (reference docs/faq/env_var.md:105).
- ``set_config(aggregate_stats=True)`` enables the in-process aggregate
  table (reference `src/profiler/aggregate_stats.cc`): every eager op
  dispatch (`ops/invoke.py`), every executor ``forward`` and
  ``forward_backward`` and every other `compiled.CompiledProgram` call
  (one entry a call, a CUDA graph replay included) is timed and folded into a
  per-name count/total/min/max/avg table; ``dumps()`` returns it.
  Ops that run inside a program's function are not timed there: the
  program's call is the entry, as a JAX compiled call is.
- ``profile_memory=True`` also tracks the output bytes of each entry and
  samples ``torch.cuda.memory_stats()`` (allocated bytes, current and
  peak) for the "Memory allocations" section.

Timing caveat: aggregate mode synchronizes the device after each timed
call (``torch.cuda.synchronize``), so its numbers are wall-clock per call
and it slows a training loop; profile a loop with the tracer instead.
No timed call synchronizes while a stream is capturing a CUDA graph.
"""
from __future__ import annotations

import os
import time

from . import telemetry

__all__ = ["set_config", "set_state", "dump", "dumps", "device_dumps",
           "pause", "resume", "reset_stats", "Scope"]

_state = {"running": False, "dir": "profile_output", "configured": False,
          "paused": False, "prof": None, "traces": 0}
_agg = {
    "enabled": False,
    "memory": False,
    "ops": {},          # name -> [count, total_us, min_us, max_us]
    "alloc": {},        # name -> [count, total_bytes, min_bytes, max_bytes]
}


def set_config(filename="profile.json", profile_all=False, profile_symbolic=True,
               profile_imperative=True, profile_memory=True, profile_api=True,
               aggregate_stats=False, **kwargs):
    _state["dir"] = os.path.splitext(filename)[0] + "_trace"
    _state["configured"] = True
    # aggregate mode is a separate opt-in, as in the reference: it
    # synchronizes every timed call, which a trace must not pay
    _agg["enabled"] = bool(aggregate_stats)
    _agg["memory"] = bool(profile_memory and aggregate_stats)


def _start():
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _state["prof"] = prof
    _state["running"] = True


def _stop():
    """Stop the trace and export it into the configured directory;
    returns the trace file's path."""
    prof = _state["prof"]
    _state["prof"] = None
    _state["running"] = False
    prof.stop()
    os.makedirs(_state["dir"], exist_ok=True)
    _state["traces"] += 1
    path = os.path.join(_state["dir"], "trace_%d_%d.pt.trace.json"
                        % (os.getpid(), _state["traces"]))
    prof.export_chrome_trace(path)
    return path


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        if not _state["running"]:
            _start()
    elif state == "stop":
        if _state["running"]:
            _stop()
    else:
        raise ValueError("state must be 'run' or 'stop'")


def dump(finished=True, profile_process="worker"):
    if _state["running"] and finished:
        set_state("stop")


def pause(profile_process="worker"):
    if _state["running"]:
        _stop()
        _state["paused"] = True


def resume(profile_process="worker"):
    """Resume a paused trace. A bare ``resume()`` with no prior
    ``set_config``/``pause`` warns and does nothing: resume is the second
    half of a pause/resume pair, not a start button."""
    if _state["running"]:
        return
    if not (_state["configured"] or _state["paused"]):
        import warnings
        warnings.warn(
            "profiler.resume() called before set_config()/pause(): no "
            "trace is configured, nothing to resume — call set_config() "
            "and set_state('run') to start one", stacklevel=2)
        return
    _start()
    _state["paused"] = False


# ---------------------------------------------------------------------------
# Aggregate statistics (reference src/profiler/aggregate_stats.cc)
# ---------------------------------------------------------------------------

def aggregate_enabled():
    return _agg["enabled"]


def memory_enabled():
    return _agg["memory"]


def record_op(name, dur_s, out_bytes=0):
    """Fold one timed call into the aggregate table, and into the
    ``op_dispatch_seconds{op=}`` histogram of the telemetry registry."""
    telemetry.histogram("op_dispatch_seconds",
                        help="timed dispatches (aggregate mode), by op",
                        op=name).observe(dur_s)
    us = dur_s * 1e6
    rec = _agg["ops"].get(name)
    if rec is None:
        _agg["ops"][name] = [1, us, us, us]
    else:
        rec[0] += 1
        rec[1] += us
        rec[2] = min(rec[2], us)
        rec[3] = max(rec[3], us)
    if _agg["memory"] and out_bytes:
        mrec = _agg["alloc"].get(name)
        if mrec is None:
            _agg["alloc"][name] = [1, out_bytes, out_bytes, out_bytes]
        else:
            mrec[0] += 1
            mrec[1] += out_bytes
            mrec[2] = min(mrec[2], out_bytes)
            mrec[3] = max(mrec[3], out_bytes)


def reset_stats():
    _agg["ops"].clear()
    _agg["alloc"].clear()


def _device_memory_lines():
    """Per-device allocator lines from `xla_stats.device_memory` (a
    ``cpu`` line of zeros without CUDA, so the table keeps its shape)."""
    from . import xla_stats
    return ["Device %s: bytes_in_use=%d peak_bytes_in_use=%d"
            % (rec["device"], rec["bytes_in_use"],
               rec["peak_bytes_in_use"])
            for rec in xla_stats.device_memory(limit=8)]


def dumps(reset=False, format="table"):
    """Aggregate-stats table (reference profiler.dumps ->
    AggregateStats::DumpTable). Empty string when nothing was collected,
    as in the reference."""
    if not _agg["ops"] and not _agg["alloc"]:
        return ""
    out = ["Profile Statistics.", "\tNote: aggregate statistics over all "
           "timed dispatches since the last reset."]
    hdr = ("%-32s %12s %14s %14s %14s %14s"
           % ("Name", "Total Count", "Time (ms)", "Min Time (ms)",
              "Max Time (ms)", "Avg Time (ms)"))
    out += ["", hdr, "-" * len(hdr)]
    for name in sorted(_agg["ops"], key=lambda n: -_agg["ops"][n][1]):
        cnt, tot, mn, mx = _agg["ops"][name]
        out.append("%-32s %12d %14.4f %14.4f %14.4f %14.4f"
                   % (name[:32], cnt, tot / 1e3, mn / 1e3, mx / 1e3,
                      tot / cnt / 1e3))
    if _agg["memory"]:
        out += ["", "Memory allocations (op output buffers)."]
        hdr = ("%-32s %12s %14s %14s %14s"
               % ("Name", "Total Count", "Total Bytes", "Min Bytes",
                  "Max Bytes"))
        out += [hdr, "-" * len(hdr)]
        for name in sorted(_agg["alloc"], key=lambda n: -_agg["alloc"][n][1]):
            cnt, tot, mn, mx = _agg["alloc"][name]
            out.append("%-32s %12d %14d %14d %14d"
                       % (name[:32], cnt, tot, mn, mx))
        mem_lines = _device_memory_lines()
        if mem_lines:
            out += ["", "Device allocator (torch.cuda.memory_stats)."] \
                + mem_lines
    if reset:
        reset_stats()
    return "\n".join(out) + "\n"


def device_dumps(logdir=None, line_filter=None, by="op", top=40):
    """Per-kernel *device-time* table from the exported trace (see
    `xplane.py`): what the trace holds, never filled in from elsewhere.
    Requires a completed trace (``set_state('stop')`` first)."""
    from . import xplane
    return xplane.dumps(logdir or _state["dir"], line_filter=line_filter,
                        by=by, top=top)


class Scope:
    """Annotate a region in the trace (reference profiler scopes), as a
    ``torch.profiler.record_function`` range."""

    def __init__(self, name="<unk>"):
        import torch
        self._ctx = torch.profiler.record_function(name)

    def __enter__(self):
        self._ctx.__enter__()
        return self

    def __exit__(self, *a):
        return self._ctx.__exit__(*a)


def _leaves(obj, out):
    if isinstance(obj, (list, tuple)):
        for v in obj:
            _leaves(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _leaves(v, out)
    else:
        t = getattr(obj, "_data", obj)
        if hasattr(t, "device") and hasattr(t, "element_size"):
            out.append(t)
    return out


def finish_timed(name, t0, outs):
    """Wait for ``outs``' device, then fold (name, elapsed, output bytes)
    into the aggregate table. Dispatch sites call it only when
    ``aggregate_enabled()``. While this thread's stream is capturing a
    CUDA graph nothing is waited for or recorded: the capture records
    work, it runs none."""
    import torch
    tensors = _leaves(outs, [])
    cuda = {t.device for t in tensors if t.device.type == "cuda"}
    if cuda:
        if torch.cuda.is_current_stream_capturing():
            return
        for dev in cuda:
            torch.cuda.synchronize(dev)
    nbytes = 0
    if _agg["memory"]:
        nbytes = sum(int(t.numel()) * int(t.element_size())
                     for t in tensors)
    record_op(name, time.perf_counter() - t0, nbytes)


if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    # MXNET_PROFILER_AGGREGATE=1 makes the autostarted run also collect
    # the aggregate table (reference env_var.md: autostart alone only
    # captures the trace)
    set_config(aggregate_stats=os.environ.get(
        "MXNET_PROFILER_AGGREGATE", "0") == "1")
    set_state("run")
