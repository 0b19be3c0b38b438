"""Trace reader: per-kernel *device-time* attribution.

Counterpart of `mxnet_tpu/xplane.py`, which decodes the XPlane protobufs
of ``jax.profiler``; the module keeps its name and API so that a reader
finds the counterpart, but it reads the chrome trace that
``torch.profiler`` exports (`profiler.py` writes one into the configured
directory when a trace stops). The aggregate table of `profiler.py`
times host wall-clock per call; this one sums the device's own timeline:

- ``by="op"``: device time by kernel name (memcpy and memset events
  included, under their own names);
- ``by="category"``: device time by the CPU op that launched the kernel,
  found through the trace's ids: a kernel's ``External id`` names the
  innermost op (or ``record_function`` range) open at its launch, and a
  kernel without one is joined through its ``correlation`` id to the
  runtime call that launched it and from there to the innermost op
  enclosing that call on its thread;
- ``by="instance"``: the kernel's name with its stream.

``device_only`` restricts the table to device events and falls back to
the CPU ops when the trace holds none (a CPU run). ``line_filter`` keeps
the events whose category (``kernel``, ``gpu_memcpy``, ``cpu_op``, ...)
or stream (``stream 7``) contains the string.

The table reports what the trace holds: a kernel the tracer lost is not
in it, and nothing fills it in from elsewhere.

Usage::

    import mxnet_tpu_torch as mx
    mx.profiler.set_config(filename='net')        # trace dir net_trace/
    mx.profiler.set_state('run')
    ... run steps ...
    mx.profiler.set_state('stop')
    print(mx.xplane.dumps('net_trace'))           # per-kernel table

or from the shell::

    python -m mxnet_tpu_torch.xplane net_trace --top 30

Stdlib-only: it runs without torch.
"""
from __future__ import annotations

import gzip
import json
import os

__all__ = ["find_trace_files", "read_trace", "op_table", "dumps",
           "busy_us", "save_json", "main"]

#: chrome-trace categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_files(logdir):
    """The exported chrome traces under ``logdir`` (or ``logdir`` itself
    when it is one file), sorted."""
    if os.path.isfile(logdir):
        return [logdir]
    out = []
    for root, _dirs, files in os.walk(logdir):
        for fn in files:
            if fn.endswith((".json", ".json.gz")):
                out.append(os.path.join(root, fn))
    return sorted(out)


def read_trace(path):
    """The ``traceEvents`` list of one exported trace."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as fh:
        doc = json.load(fh)
    return doc.get("traceEvents", []) if isinstance(doc, dict) else doc


def _cat(ev):
    return str(ev.get("cat", "")).lower()


def _is_device(ev):
    return ev.get("ph") == "X" and _cat(ev) in DEVICE_CATEGORIES


def _launchers(events):
    """(by External id: the op's name, by correlation id: the runtime
    launch event, per (pid, tid): the CPU op intervals sorted by start)."""
    by_ext, by_corr, spans = {}, {}, {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = _cat(ev)
        args = ev.get("args") or {}
        if cat in ("cpu_op", "user_annotation", "python_function"):
            ext = args.get("External id")
            # the innermost op owns an id: a later (nested) op with the
            # same id replaces the outer one
            if ext is not None:
                prev = by_ext.get(ext)
                if prev is None or ev.get("ts", 0) >= prev[0]:
                    by_ext[ext] = (ev.get("ts", 0), ev.get("name", "?"))
            if cat == "cpu_op":
                spans.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                    (float(ev.get("ts", 0)),
                     float(ev.get("ts", 0)) + float(ev.get("dur", 0)),
                     ev.get("name", "?")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = args.get("correlation")
            if corr is not None:
                by_corr[corr] = ev
    for lst in spans.values():
        lst.sort()
    return by_ext, by_corr, spans


def _enclosing(spans, ev):
    """The innermost CPU op on ``ev``'s thread whose interval holds
    ``ev``'s start."""
    ts = float(ev.get("ts", 0))
    best = None
    for start, end, name in spans.get((ev.get("pid"), ev.get("tid")), ()):
        if start > ts:
            break
        if end >= ts and (best is None or start >= best[0]):
            best = (start, name)
    return None if best is None else best[1]


def _launcher(ev, by_ext, by_corr, spans):
    args = ev.get("args") or {}
    ext = args.get("External id")
    if ext is not None and ext in by_ext:
        return by_ext[ext][1]
    launch = by_corr.get(args.get("correlation"))
    if launch is not None:
        name = _enclosing(spans, launch)
        if name is not None:
            return name
        return launch.get("name", "?")
    return "(unattributed)"


def op_table(logdir, line_filter=None, by="op", device_only=True):
    """Aggregate device time per kernel (or per launching op) from the
    exported traces under ``logdir``.

    Returns a dict mapping group key -> dict(count, total_ps, min_ps,
    max_ps, stats), the JAX package's keys (times in picoseconds)."""
    if by not in ("op", "instance", "category"):
        raise ValueError("by must be 'op', 'instance' or 'category', got %r"
                         % by)
    files = find_trace_files(logdir)
    if not files:
        raise FileNotFoundError("no trace (.json) under %r" % logdir)
    table = {}
    for path in files:
        events = read_trace(path)
        dev = [e for e in events if _is_device(e)]
        if dev or not device_only:
            chosen = dev if device_only else \
                [e for e in events if e.get("ph") == "X"]
        else:
            chosen = [e for e in events
                      if e.get("ph") == "X" and _cat(e) == "cpu_op"]
        if line_filter:
            chosen = [e for e in chosen
                      if line_filter in _cat(e)
                      or line_filter in "stream %s" % e.get("tid")]
        links = _launchers(events) if by == "category" else None
        for ev in chosen:
            name = ev.get("name", "?")
            if by == "category":
                key = _launcher(ev, *links) if _is_device(ev) else name
            elif by == "instance":
                key = "%s [stream %s]" % (name, ev.get("tid"))
            else:
                key = name
            d = int(round(float(ev.get("dur", 0)) * 1e6))   # us -> ps
            rec = table.get(key)
            if rec is None:
                table[key] = {"count": 1, "total_ps": d, "min_ps": d,
                              "max_ps": d,
                              "stats": {"category": _cat(ev)}}
            else:
                rec["count"] += 1
                rec["total_ps"] += d
                rec["min_ps"] = min(rec["min_ps"], d)
                rec["max_ps"] = max(rec["max_ps"], d)
    return table


def busy_us(logdir):
    """Device busy time of the traces under ``logdir``: the length of the
    union of their device events' intervals, in microseconds."""
    spans = []
    for path in find_trace_files(logdir):
        spans += [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                  for e in read_trace(path) if _is_device(e)]
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def dumps(logdir, line_filter=None, by="op", top=40, total_label=None):
    """Render the per-kernel device-time table (reference
    ``AggregateStats::DumpTable`` shape, with device time)."""
    table = op_table(logdir, line_filter=line_filter, by=by)
    if not table:
        return "(no events)\n"
    grand = sum(r["total_ps"] for r in table.values()) or 1
    hdr = ("%-44s %10s %12s %8s %12s" %
           ("Name", "Count", "Total (ms)", "Share", "Avg (us)"))
    out = ["Device-time per-%s table (%s)." % (by, total_label or logdir),
           "", hdr, "-" * len(hdr)]
    for key in sorted(table, key=lambda k: -table[k]["total_ps"])[:top]:
        r = table[key]
        out.append("%-44s %10d %12.3f %7.1f%% %12.2f"
                   % (key[:44], r["count"], r["total_ps"] / 1e9,
                      100.0 * r["total_ps"] / grand,
                      r["total_ps"] / r["count"] / 1e6))
    out.append("-" * len(hdr))
    out.append("%-44s %10s %12.3f" % ("TOTAL", "", grand / 1e9))
    return "\n".join(out) + "\n"


def save_json(logdir, path, line_filter=None, by="op"):
    table = op_table(logdir, line_filter=line_filter, by=by)
    with open(path, "w") as fh:
        json.dump(table, fh, indent=1, default=repr)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("logdir")
    ap.add_argument("--line", default=None,
                    help="only events whose category or stream contains "
                         "this string (e.g. 'kernel')")
    ap.add_argument("--by", default="op",
                    choices=["op", "instance", "category"])
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--json", default=None, help="also dump JSON here")
    args = ap.parse_args(argv)
    print(dumps(args.logdir, line_filter=args.line, by=args.by,
                top=args.top), end="")
    if args.json:
        save_json(args.logdir, args.json, line_filter=args.line, by=args.by)


if __name__ == "__main__":   # pragma: no cover
    main()
