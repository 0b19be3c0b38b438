"""Request anatomy (`mxnet_tpu_torch/serving/reqtrace.py`) against the JAX
package's `mxnet_tpu/serving/reqtrace.py`.

The same synthetic traces, SLO outcomes, batches and snapshot files go
through both packages: phase durations, shares and burn rates must agree
to 1e-12, verdicts, hints, report text and JSON keys exactly. Neither
module imports JAX; the JAX package's reqtrace is imported as it is.
"""
import io
import json
import os

import numpy as np
import pytest

from mxnet_tpu import telemetry as jax_telemetry
from mxnet_tpu.serving import reqtrace as jrt
from mxnet_tpu_torch import telemetry as port_telemetry
from mxnet_tpu_torch.serving import reqtrace as prt

TOL = 1e-12
MODULES = (jrt, prt)


def _close(a, b, path="doc"):
    """``a`` and ``b`` equal in structure and keys, numbers to TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], "%s[%r]" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path,)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, abs=TOL, rel=TOL), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_taxonomy_and_constants_match():
    for name in ("PHASES", "_MARKS", "QUEUE_PHASES", "SHED_HEAVY_FRACTION",
                 "PAD_WASTE_BOUND", "VERDICT_HINTS", "__all__"):
        assert getattr(prt, name) == getattr(jrt, name), name


@pytest.mark.parametrize("rid", [
    "abc-123.X:ok", "evil\nSet-Cookie: x", "x" * 500, "ünïcode-id",
    "a b\tc", "plain_ID.9"])
def test_clean_request_id_matches(rid):
    assert prt.clean_request_id(rid) == jrt.clean_request_id(rid)


@pytest.mark.parametrize("rid", [None, "", "\n\r ", "!!!"])
def test_empty_request_ids_are_minted_in_both(rid):
    for mod in MODULES:
        got = mod.clean_request_id(rid)
        assert len(got) == 16 and got != mod.clean_request_id(rid)


# ---------------------------------------------------------------------------
# Trace.phases
# ---------------------------------------------------------------------------

def _trace_marks(seed, upto):
    """Random increasing boundary marks, the first ``upto`` of them."""
    rng = np.random.RandomState(seed)
    t = 100.0 + rng.rand()
    marks = {}
    for name in jrt._MARKS[:upto]:
        marks[name] = t
        t += float(rng.exponential(0.01))
    return marks, t + float(rng.exponential(0.005))


@pytest.mark.parametrize("seed,upto", [(s, u) for s in range(3)
                                       for u in range(1, 8)])
def test_trace_phases_match(seed, upto):
    marks, end = _trace_marks(seed, upto)
    got = []
    for mod in MODULES:
        tr = mod.Trace("r%d" % seed, wall0=0.0)
        for name, t in marks.items():
            tr.mark(name, t)
        got.append(tr.phases(end))
    _close(got[0], got[1])
    assert sum(got[1].values()) == pytest.approx(end - marks["enqueued"],
                                                 abs=TOL)
    if upto == len(jrt._MARKS):
        assert set(got[1]) == set(prt.PHASES)


def test_trace_rejects_unknown_marks_in_both():
    for mod in MODULES:
        with pytest.raises(ValueError):
            mod.Trace("r").mark("not_a_mark")
        assert mod.Trace("r").phases(1.0) == {}


# ---------------------------------------------------------------------------
# SLOTracker
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _slo_run(mod, seed, target_ms, availability, windows):
    rng = np.random.RandomState(seed)
    clk = _Clock()
    slo = mod.SLOTracker(target_ms=target_ms, availability=availability,
                         windows=windows, clock=clk)
    readings = []
    for step in range(60):
        clk.t += float(rng.exponential(20.0))
        ok = rng.rand() > 0.1
        slo.record(bool(ok), float(rng.exponential(target_ms / 1e3))
                   if ok else None)
        if step % 6 == 0:
            readings.append({str(w): (slo.window_counts(w),
                                      slo.burn_rate(w))
                             for w in slo.windows})
    return readings, slo.snapshot(), slo.error_budget, slo.windows


@pytest.mark.parametrize("seed,target_ms,availability,windows", [
    (0, 100.0, 0.99, [60, 600]), (1, 250.0, 0.999, [300, 3600]),
    (2, 5.0, 0.9, [30]), (3, 50.0, 0.95, [10, 120, 900])])
def test_slo_tracker_matches(seed, target_ms, availability, windows):
    a, b = (_slo_run(mod, seed, target_ms, availability, windows)
            for mod in MODULES)
    _close(a, b)


def test_slo_validation_and_env_defaults_match(monkeypatch):
    for kw in ({"target_ms": 0, "availability": 0.9, "windows": [60]},
               {"target_ms": 50, "availability": 1.5, "windows": [60]},
               {"target_ms": 50, "availability": 0.9, "windows": []}):
        for mod in MODULES:
            with pytest.raises(ValueError):
                mod.SLOTracker(**kw)
    monkeypatch.setenv("MXNET_SLO_LATENCY_MS", "75")
    monkeypatch.setenv("MXNET_SLO_AVAILABILITY", "0.95")
    monkeypatch.setenv("MXNET_SLO_WINDOWS", "30,90")
    got = [(s.target_ms, s.availability, s.windows)
           for s in (mod.SLOTracker() for mod in MODULES)]
    assert got[0] == got[1] == (75.0, 0.95, (30, 90))
    monkeypatch.setenv("MXNET_SLO_WINDOWS", "bogus")
    assert prt.SLOTracker().windows == jrt.SLOTracker().windows


# ---------------------------------------------------------------------------
# RequestTracer: attribution, slow ring, rejects, batches
# ---------------------------------------------------------------------------

def _feed_all(mod, seed, n_fast, n_slow, rejects, batches):
    tracer = mod.RequestTracer(window=256, slow_keep=4)
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n_fast + n_slow):
        slow = i >= n_fast
        total = float(rng.uniform(0.3, 0.6) if slow
                      else rng.uniform(0.005, 0.02))
        qf = float(rng.uniform(0.6, 0.95) if slow else rng.uniform(0, 0.2))
        t0 = float(i)
        tr = mod.Trace("req-%d" % i, wall0=t0)
        q, rest = total * qf, total * (1 - qf)
        tr.mark("enqueued", t0)
        tr.mark("picked", t0 + q * 0.7)
        tr.mark("pad_start", t0 + q)
        tr.mark("pad_end", t0 + q + rest * 0.05)
        tr.mark("forward_end", t0 + q + rest * 0.15)
        tr.mark("outputs_end", t0 + q + rest * 0.9)
        tr.mark("split_end", t0 + q + rest * 0.95)
        tr.bucket, tr.batch = 4, i // 3
        recs.append(tracer.record(tr, t0 + total,
                                  status="ok" if i % 17 else "error"))
    for status in rejects:
        tracer.note_reject(status)
    for rows, bucket in batches:
        tracer.note_batch(rows, bucket)
    snap = tracer.snapshot()
    for key in ("host", "pid", "updated"):
        snap.pop(key)
    return recs, tracer.attribution(), tracer.slowest(), tracer.counts(), \
        snap


@pytest.mark.parametrize("seed,n_fast,n_slow,rejects,batches", [
    (0, 100, 2, [], [(3, 4), (4, 4), (1, 8)]),
    (1, 40, 0, ["shed"] * 6, [(8, 8)] * 5),
    (2, 10, 10, ["expired", "closed"], [(1, 2), (5, 8), (2, 2)]),
    (3, 3, 0, [], []),
    (4, 200, 5, ["shed"], [(3, 4)] * 30 + [(1, 32)]),
    (5, 0, 0, ["shed", "shed"], [])])
def test_request_tracer_matches(seed, n_fast, n_slow, rejects, batches):
    jax_telemetry.reset()
    port_telemetry.reset()
    a, b = (_feed_all(mod, seed, n_fast, n_slow, rejects, batches)
            for mod in MODULES)
    _close(a, b)
    for name, labels in (("serving_pad_waste_ratio", {}),
                         ("serving_bucket_occupancy", {"bucket": "4"}),
                         ("serving_real_rows_total", {"bucket": "4"})):
        ja = jax_telemetry.get_metric(name, **labels)
        pa = port_telemetry.get_metric(name, **labels)
        assert (ja is None) == (pa is None), name
        if ja is not None:
            read = (lambda m: m.read() if hasattr(m, "read") else m.value)
            assert read(pa) == pytest.approx(read(ja), abs=TOL)


def test_reset_and_write_host_snapshot_match(tmp_path):
    docs = []
    for mod, sub in zip(MODULES, ("jax", "port")):
        tracer = mod.RequestTracer(window=32)
        d = tmp_path / sub
        d.mkdir()
        assert tracer.write_host_snapshot(dir=str(d)) is None
        tr = mod.Trace("r1", wall0=0.0)
        tr.mark("enqueued", 1.0)
        tracer.record(tr, 1.05)
        path = tracer.write_host_snapshot(dir=str(d))
        assert os.path.basename(path).startswith("reqtrace_host")
        with open(path) as fh:
            docs.append(json.load(fh))
        tracer.reset()
        assert tracer.counts() == {} and tracer.records() == []
    assert sorted(docs[0]) == sorted(docs[1])
    for doc in docs:
        for key in ("host", "pid", "updated"):
            doc.pop(key)
    _close(docs[0], docs[1])


# ---------------------------------------------------------------------------
# classify and the report
# ---------------------------------------------------------------------------

def _shares(**kv):
    total = sum(kv.values())
    return {p: kv.get(p, 0.0) / total for p in jrt.PHASES}


CLASSIFY_CASES = [
    (_shares(queue_wait=0.5, batch_wait=0.2, device_compute=0.3), 0.0,
     None),
    (_shares(device_compute=0.7, dispatch=0.1, queue_wait=0.2), 0.0, 0.05),
    (_shares(device_compute=0.7, dispatch=0.1, queue_wait=0.2), 0.0, 0.6),
    (_shares(queue_wait=0.9, device_compute=0.1), 0.0, 0.6),
    (_shares(device_compute=1.0), 0.2, None),
    (_shares(device_compute=1.0), 0.01, None),
    (_shares(device_compute=1.0), 0.05, 0.35),
    (_shares(queue_wait=0.5, device_compute=0.5), 0.0, 0.35),
    ({}, 0.0, None),
    ({"queue_wait": 0.0}, 0.0, None),
]


@pytest.mark.parametrize("shares,shed,waste", CLASSIFY_CASES)
def test_classify_matches(shares, shed, waste):
    assert prt.classify(shares, shed_fraction=shed, pad_waste=waste) == \
        jrt.classify(shares, shed_fraction=shed, pad_waste=waste)


def _snapshot_doc(p99_shares, shed_fraction=0.0, waste=0.0, host=0):
    return {"host": host, "pid": 1, "updated": 123.0, "requests": 100,
            "counts": {"ok": 100, "shed": 3}, "shed_fraction": shed_fraction,
            "latency": {"p50": 0.002, "p95": 0.008, "p99": 0.02 + host,
                        "count": 100, "max": 0.03},
            "p50_shares": _shares(device_compute=1.0),
            "p99_shares": p99_shares,
            "pad": {"waste_ratio": waste, "buckets": {
                "4": {"batches": 3 + host, "real_rows": 9}}},
            "slowest": [{"rid": "slow-%d" % host, "total": 0.03,
                         "phases": {"queue_wait": 0.02,
                                    "device_compute": 0.01}}]}


REPORT_DOCS = [
    _snapshot_doc(_shares(queue_wait=0.7, device_compute=0.3)),
    _snapshot_doc(_shares(device_compute=0.8, dispatch=0.2)),
    _snapshot_doc(_shares(device_compute=0.8, dispatch=0.2), waste=0.5),
    _snapshot_doc(_shares(device_compute=1.0), shed_fraction=0.3),
    _snapshot_doc(_shares(queue_wait=0.62, batch_wait=0.2,
                          device_compute=0.18)),
    {},
]


def _reports(path, json_only=False):
    outs = []
    for mod in MODULES:
        out = io.StringIO()
        rc = mod.report(path, out=out, json_only=json_only)
        outs.append((rc, out.getvalue()))
    return outs


@pytest.mark.parametrize("doc", REPORT_DOCS)
@pytest.mark.parametrize("json_only", [False, True])
def test_report_on_a_snapshot_matches(tmp_path, doc, json_only):
    path = tmp_path / "reqtrace_host0_pid1.json"
    path.write_text(json.dumps(doc))
    (rc_j, text_j), (rc_p, text_p) = _reports(str(path), json_only)
    assert rc_j == rc_p and text_j == text_p
    machine = json.loads(text_p.strip().splitlines()[-1])
    assert machine["metric"] == "reqtrace_report"


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_report_merges_host_snapshots_as_jax(tmp_path, hosts):
    kinds = [_shares(queue_wait=1.0), _shares(device_compute=0.6,
                                              queue_wait=0.4),
             _shares(dispatch=0.3, device_compute=0.7)]
    for h in range(hosts):
        doc = _snapshot_doc(kinds[h], shed_fraction=0.01 * h,
                            waste=0.1 * h, host=h)
        (tmp_path / ("reqtrace_host%d_pid1.json" % h)).write_text(
            json.dumps(doc))
    merged = [mod.merge_host_snapshots(str(tmp_path)) for mod in MODULES]
    _close({str(k): v for k, v in merged[0].items()},
           {str(k): v for k, v in merged[1].items()})
    _close(jrt._combine(merged[0]), prt._combine(merged[1]))
    (rc_j, text_j), (rc_p, text_p) = _reports(str(tmp_path))
    assert rc_j == rc_p == 0 and text_j == text_p
    assert "%d host snapshot(s)" % hosts in text_p or hosts == 1


def test_report_without_data_and_the_cli(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("MXNET_TELEMETRY_DIR", raising=False)
    saved = (jrt.tracer, prt.tracer)
    try:
        jrt.tracer = jrt.RequestTracer(window=16)
        prt.tracer = prt.RequestTracer(window=16)
        (rc_j, text_j), (rc_p, text_p) = _reports(None)
        assert rc_j == rc_p == 1 and text_j == text_p
    finally:
        jrt.tracer, prt.tracer = saved
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(REPORT_DOCS[1]))
    lines = []
    for mod in MODULES:
        assert mod.main(["report", str(path), "--json"]) == 0
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert json.loads(lines[1])["verdict"] == "compute-bound"
