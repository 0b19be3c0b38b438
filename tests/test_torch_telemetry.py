"""The port's telemetry, chaos and threadsan against the JAX package's.

The same call sequence, drawn from a numpy seed, goes through
``mxnet_tpu.telemetry`` and ``mxnet_tpu_torch.telemetry`` on fresh
registries: counters, gauges and histograms with labels, and swallowed
errors; their Prometheus ``dumps()`` text and their ``snapshot()`` must
be equal (exact: the same arithmetic on the same floats). The same
events through ``to_chrome``, and the same JSONL directory through
``merge``, give equal traces. The chaos spec grammar parses the same
specs into the same triggers and refuses the same bad ones; threadsan's
witness reports the same cycle for the same lock-order inversion, and
none for a consistent order. These modules hold no JAX code, so the JAX
side runs as it is.
"""
import json
import os
import threading

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

PKGS = (mx, mxt)


def _sequence(tel, seed):
    """One registry workload from ``seed``: counters, gauges and
    histograms with labels, a pulled gauge, a swallowed error."""
    rng = np.random.RandomState(seed)
    tel.reset()
    for i in range(20):
        site = "s%d" % rng.randint(3)
        tel.counter("calls_total", help="calls", site=site).inc(
            float(rng.randint(1, 5)))
        tel.gauge("depth", help="queue depth", queue=site).set(
            float(rng.rand()))
        tel.histogram("lat_seconds", help="latency",
                      op="op%d" % (i % 2)).observe(float(rng.exponential()))
    tel.gauge("pulled", help="scrape-time").set_function(lambda: 7.5)
    tel.counter("plain_total").inc()
    tel.swallowed("test.site", ValueError("boom"))
    with tel.span("region", k=1):
        pass
    h = tel.get_metric("lat_seconds", op="op0")
    return tel.dumps(), tel.snapshot(), h.quantile(0.5)


def _strip_span(snap):
    # the span's duration is a clock reading: compare its count only
    region = snap.pop("region_seconds")
    return region["series"][0]["count"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_dumps_and_snapshot_match(seed):
    outs = [_sequence(pkg.telemetry, seed) for pkg in PKGS]
    (dj, sj, qj), (dt, st, qt) = outs
    assert _strip_span(sj) == _strip_span(st) == 1
    assert sj == st
    assert qj == qt
    strip = [line for line in dj.splitlines() if "region_seconds" not in line]
    assert strip == [line for line in dt.splitlines()
                     if "region_seconds" not in line]
    assert "errors_swallowed_total{site=\"test.site\"} 1" in dt
    for pkg in PKGS:
        pkg.telemetry.reset()


def _events(seed):
    rng = np.random.RandomState(seed)
    evs = []
    t = 1_700_000_000.0
    for i in range(12):
        t += float(rng.rand())
        rec = {"name": "step.%s" % ("dispatch", "h2d", "sync")[i % 3],
               "ph": "X" if i % 4 else "i", "ts": t,
               "mono": float(i), "pid": 100 + int(rng.randint(2)),
               "host": int(rng.randint(2)), "tid": int(rng.randint(3)),
               "args": {"i": i}}
        if rec["ph"] == "X":
            rec["dur"] = float(rng.rand()) * 1e-2
        evs.append(rec)
    return evs


@pytest.mark.parametrize("seed", [0, 1])
def test_to_chrome_and_merge_match(seed, tmp_path):
    evs = _events(seed)
    assert mx.telemetry.to_chrome(evs) == mxt.telemetry.to_chrome(evs)
    for h in (0, 1):
        with open(tmp_path / ("events_host%d_pid1.jsonl" % h), "w") as fh:
            for ev in evs:
                if ev["host"] == h:
                    fh.write(json.dumps(ev) + "\n")
            fh.write("{torn line\n")
    merged = [pkg.telemetry.merge(str(tmp_path),
                                  out=str(tmp_path / ("%d.json" % i)))
              for i, pkg in enumerate(PKGS)]
    assert merged[0] == merged[1]
    assert len([e for e in merged[1]["traceEvents"] if e["ph"] != "M"]) \
        == len(evs)


def test_configured_dir_writes_events_and_snapshot(tmp_path):
    tel = mxt.telemetry
    tel.configure(str(tmp_path), snapshot_interval=0)
    try:
        tel.counter("configured_total").inc()
        with tel.span("step.dispatch", step=1):
            pass
        tel.event("marker", x=1)
        tel.flush()
    finally:
        tel.configure(None)
    names = sorted(os.listdir(tmp_path))
    assert any(n.startswith("events_host0_pid") for n in names)
    assert any(n.endswith(".prom") for n in names)
    trace = tel.merge(str(tmp_path))
    assert {e["name"] for e in trace["traceEvents"]} >= {
        "step.dispatch", "marker"}


SPECS = ["memory.oom", "memory.oom@3", "memory.oom@0x2=1024",
         "step.fail@1x3, worker.death@6=9", "heartbeat.delay@3x2=1.5"]
BAD = ["memory.oom@", "nosuch.site", "memory.oom x2", "step.fail@-1"]


def _triggers(chaos, spec):
    chaos.clear()
    chaos.arm_from_env(spec)
    out = {site: [(t.after, t.times, t.value) for t in trigs]
           for site, trigs in chaos._triggers.items()}
    chaos.clear()
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parsing_matches(spec):
    assert _triggers(mx.chaos, spec) == _triggers(mxt.chaos, spec)


@pytest.mark.parametrize("spec", BAD)
def test_chaos_bad_spec_raises_in_both(spec):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.chaos.arm_from_env(spec)
        pkg.chaos.clear()


def test_chaos_sites_and_firing_match():
    assert set(mx.chaos.SITES) == set(mxt.chaos.SITES)
    fired = []
    for pkg in PKGS:
        pkg.chaos.clear()
        with pkg.chaos.armed("memory.oom", after=2, times=2, value="5"):
            fired.append([pkg.chaos.fire("memory.oom") for _ in range(6)])
        assert not pkg.chaos.is_armed("memory.oom")
    assert fired[0] == fired[1] == [None, None, "5", "5", None, None]


def _witness(threadsan, consistent):
    threadsan.arm()
    threadsan.reset()
    try:
        a = threadsan.register("t.A", threading.Lock())
        b = threadsan.register("t.B", threading.Lock())

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        for fn in (ab, ab if consistent else ba):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
        snap = threadsan.snapshot()
    finally:
        threadsan.disarm()
        threadsan.reset()
    reports = [r for r in snap["reports"] if r["kind"] == "potential_deadlock"]
    return ([sorted(r["cycle"]) for r in reports],
            sorted((e["outer"], e["inner"], e["count"])
                   for e in snap["edges"]))


@pytest.mark.parametrize("consistent", [False, True])
def test_threadsan_cycle_reports_match(consistent):
    jax_side = _witness(mx.threadsan, consistent)
    port = _witness(mxt.threadsan, consistent)
    assert jax_side == port
    assert len(port[0]) == (0 if consistent else 1)
