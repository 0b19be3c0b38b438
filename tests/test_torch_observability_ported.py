"""JAX-package tests of the observability stack that fail under the
installed JAX 0.9, held against the port instead.

Each of these JAX tests drives a compiled program or ``Module.fit``
through the JAX package's compile-tracking layer, which fails under JAX
0.9 (``jax.core.trace_state_clean`` is gone; ROADMAP C). There is no JAX
result to compare with, so each test here holds the port to the named
JAX test's own assertions, ported to the port's API (``executor.forward``
is not a compiled program in the port: a hybridized block,
``gluon.hybrid_forward``, is the compiled site). All on the CPU, no JAX.
"""
import io
import json
import os
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import (compiled, memprof, runprof, stepprof,
                             telemetry, xla_stats)


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """A clean registry, compile state, ledger and run ledger, with a
    telemetry dir for the flight recorder (the JAX tests' fixture)."""
    monkeypatch.setenv("MXNET_TELEMETRY_DIR", str(tmp_path))
    telemetry.reset()
    xla_stats.reset()
    runprof.reset()
    stepprof.reset()
    memprof.reset()
    yield str(tmp_path)
    telemetry.reset()
    xla_stats.reset()


def _fc_module(batch=16):
    data = mxt.sym.var("data")
    fc = mxt.sym.FullyConnected(data, num_hidden=4, name="fc")
    net = mxt.sym.SoftmaxOutput(fc, name="softmax")
    return mxt.mod.Module(net, context=mxt.cpu())


def _iter(n=64, batch=16):
    x = np.random.RandomState(0).uniform(size=(n, 10)).astype(np.float32)
    y = np.zeros(n, dtype=np.float32)
    return mxt.io.NDArrayIter(x, y, batch_size=batch)


def _dense():
    net = mxt.gluon.nn.Dense(3, in_units=5)
    net.initialize(ctx=mxt.cpu())
    net.hybridize()
    return net, mxt.nd.ones((2, 5), ctx=mxt.cpu())


def test_gluon_hybridize_compile_accounting(fresh):
    """tests/test_xla_stats.py::test_gluon_hybridize_compile_accounting
    (and test_one_compile_then_cache_hits at the port's compiled site):
    one compile, then hits, no retrace, one compile-time observation."""
    net, x = _dense()
    for _ in range(3):
        net(x)
    site = dict(site="gluon.hybrid_forward")
    assert telemetry.get_metric("jit_compiles_total", **site).value == 1
    assert telemetry.get_metric("jit_cache_hits_total", **site).value == 2
    retr = telemetry.get_metric("jit_retraces_total", **site)
    assert retr is None or retr.value == 0
    h = telemetry.get_metric("jit_compile_seconds", **site)
    assert h is not None and h.count == 1 and h.sum > 0
    assert compiled.compile_counts()["compiles"] == 1


def test_retrace_explainer_names_changed_dimension(fresh):
    """tests/test_xla_stats.py::test_retrace_explainer_names_changed_
    dimension: a new batch size is one retrace, counted, its reason naming
    the dimension that changed."""
    net, x = _dense()
    net(x)
    net(mxt.nd.ones((6, 5), ctx=mxt.cpu()))
    site = dict(site="gluon.hybrid_forward")
    assert telemetry.get_metric("jit_retraces_total", **site).value == 1
    last = xla_stats.last_retrace()
    assert last["site"] == "gluon.hybrid_forward"
    assert "dim 0: 2 -> 6" in last["reason"]


def test_memory_ledger_params_and_activations(fresh):
    """tests/test_xla_stats.py::test_memory_ledger_params_and_
    activations: bind books the parameter and gradient bytes; gauges and
    the report carry them."""
    mod = _fc_module()
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))])
    led = xla_stats.ledger()
    assert led[("softmax", "params")] == (10 * 4 + 4) * 4
    assert led[("softmax", "grads")] == (10 * 4 + 4) * 4
    assert telemetry.get_metric("memory_ledger_bytes", scope="softmax",
                                section="params").value > 0
    report = xla_stats.memory_report()
    assert "params" in report and "softmax" in report
    assert "Live tensor storages" in report


def test_device_memory_zeros_on_cpu(fresh):
    """tests/test_xla_stats.py::test_device_memory_zeros_on_cpu."""
    recs = xla_stats.device_memory()
    assert recs
    assert all(r["bytes_in_use"] == 0 and r["peak_bytes_in_use"] == 0
               for r in recs)
    for r in recs:
        g = telemetry.get_metric("hbm_bytes_in_use", device=r["device"])
        assert g is not None and g.value == 0
    lines = mxt.profiler._device_memory_lines()
    assert lines and all("bytes_in_use=0" in line for line in lines)


def test_optimizer_bytes_ledgered_after_update(fresh):
    """tests/test_xla_stats.py::test_optimizer_bytes_ledgered_after_
    update."""
    mod = _fc_module()
    mod.fit(_iter(32), num_epoch=1, eval_metric="acc",
            optimizer_params=(("learning_rate", 0.01), ("momentum", 0.9)))
    led = xla_stats.ledger()
    key = (mod._ledger_scope(), "optimizer")
    assert key in led and led[key] > 0


def test_mfu_gauges_from_fit(fresh, monkeypatch):
    """tests/test_xla_stats.py::test_mfu_gauges_from_fit."""
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "1e12")
    mod = _fc_module()
    mod.fit(_iter(), num_epoch=1, eval_metric="acc")
    assert xla_stats.flops_per_batch() == 3 * 2 * 16 * 10 * 4 - \
        2 * 16 * 10 * 4         # forward and weight gradient, no data grad
    g = xla_stats.goodput(batches=8, elapsed=0.5)
    assert g is not None and g["model_flops_per_second"] > 0
    assert g["mfu"] == pytest.approx(
        g["model_flops_per_second"] / xla_stats.peak_flops_total())
    text = telemetry.dumps()
    assert "\nmfu " in text or "\nmfu{" in text
    assert "model_flops_per_second" in text
    assert telemetry.counter("model_flops_total").value > 0


def test_fit_exception_dumps_flight_recorder(fresh):
    """tests/test_xla_stats.py::test_fit_exception_dumps_flight_
    recorder."""
    mod = _fc_module()
    boom = mxt.callback.Speedometer(16, frequent=1)

    def exploding_callback(param):
        raise RuntimeError("injected callback failure")

    with pytest.raises(RuntimeError, match="injected callback failure"):
        mod.fit(_iter(32), num_epoch=1, eval_metric="acc",
                batch_end_callback=[boom, exploding_callback])
    path = os.path.join(fresh, "flightrecorder-host%d.json"
                        % telemetry.host_id())
    doc = json.load(open(path))
    assert doc["reason"] == "fit_exception"
    assert "injected callback failure" in doc["error"]


def test_flight_recorder_keeps_each_reasons_post_mortem(fresh):
    """A later dump of another reason (a leak-sentinel trip after a
    serving worker's death) replaces the newest post-mortem but leaves
    the death's own file."""
    xla_stats.dump_flight_recorder("serving.worker_death", error="boom")
    xla_stats.dump_flight_recorder("runprof.memory_leak")
    newest = json.load(open(os.path.join(
        fresh, "flightrecorder-host%d.json" % telemetry.host_id())))
    assert newest["reason"] == "runprof.memory_leak"
    death = json.load(open(xla_stats.reason_dump_path(
        fresh, "serving.worker_death")))
    assert (death["reason"], death["error"]) == ("serving.worker_death",
                                                 "boom")
    assert os.path.basename(xla_stats.reason_dump_path(fresh, "a/b c")) \
        == "flightrecorder-host%d-a_b_c.json" % telemetry.host_id()


def test_instrumentation_adds_zero_compiles(fresh, monkeypatch):
    """tests/test_memprof.py::test_instrumentation_adds_zero_compiles."""
    monkeypatch.delenv("MXNET_MEM_LIMIT_BYTES", raising=False)
    net, x = _dense()
    net(x)
    c0 = xla_stats.compile_counts()
    assert c0["compiles"] >= 1
    for _ in range(5):
        memprof.sample("proof", force=True)
    memprof.peak_hbm_bytes()
    memprof.health()
    memprof.admit(123, what="proof")
    memprof.snapshot()
    memprof.attribution()
    memprof.report(out=io.StringIO())
    net(x)
    c1 = xla_stats.compile_counts()
    assert c1["compiles"] == c0["compiles"]
    assert c1["cache_hits"] >= c0["cache_hits"] + 1


def test_fit_loop_sampled_health_check(fresh, monkeypatch):
    """tests/test_runprof.py::test_fit_loop_sampled_health_check."""
    monkeypatch.setenv("MXNET_RUNPROF_CHECK_EVERY", "2")
    mod = _fc_module()
    mod.fit(_iter(), num_epoch=2, eval_metric="acc")
    snap = runprof.snapshot()
    assert snap["states"]["train_productive"] > 0
    assert 0 < snap["goodput_fraction"] <= 1
    assert snap["anomaly_counts"] == {}
    assert snap["steps"] == 8


def test_compile_feeds_ledger_and_instrumentation_is_free(fresh):
    """tests/test_runprof.py::test_compile_feeds_ledger_and_
    instrumentation_is_free."""
    net, x = _dense()
    net(x)
    assert runprof.state_seconds("compile") > 0
    c = telemetry.get_metric("run_state_seconds", state="compile")
    assert c is not None and c.value > 0
    before = xla_stats.compile_counts()
    for _ in range(16):
        runprof.note_step({"data_wait": 0.001}, 0.01)
    runprof.note_state("checkpoint_save", 0.01)
    runprof.observe_metric("loss", 0.5)
    runprof.snapshot()
    runprof.report(out=io.StringIO())
    assert xla_stats.compile_counts() == before


def test_fit_phase_series_and_speedometer(fresh):
    """tests/test_telemetry.py::test_fit_phase_series_and_speedometer."""
    mod = _fc_module()
    mod.fit(_iter(), num_epoch=2, eval_metric="acc")
    assert telemetry.counter("fit_batches_total").value == 8
    assert telemetry.counter("fit_samples_total").value == 128
    for phase in ("data_wait", "h2d", "dispatch", "device_compute"):
        h = telemetry.get_metric("step_%s_seconds" % phase)
        assert h is not None and h.count >= 8, phase
    assert telemetry.get_metric("step_seconds").count >= 8
    sp = mxt.callback.Speedometer(batch_size=16, frequent=4)
    sp._mark()
    telemetry.counter("fit_samples_total").inc(1000)
    time.sleep(0.05)
    speed = sp._speed()
    assert 1000 / 0.05 * 0.2 < speed < 1000 / 0.05 * 1.2
    sp2 = mxt.callback.Speedometer(batch_size=16, frequent=4)
    sp2._mark()
    time.sleep(0.01)
    assert sp2._speed() == pytest.approx(
        4 * 16 / (time.time() - sp2.tic), rel=0.8)


def test_fit_records_taxonomy_and_consistent_verdict(fresh):
    """tests/test_stepprof.py::test_fit_records_taxonomy_and_consistent_
    verdict: one step record a batch, the taxonomy's phases, shares that
    sum to 1, and the report's verdict equal to the live one."""
    mod = _fc_module()
    mod.fit(_iter(), num_epoch=2, eval_metric="acc")
    snap = stepprof.snapshot()
    assert snap["steps"] == 8
    for phase in ("data_wait", "h2d", "dispatch", "device_compute"):
        assert snap["phase_totals"].get(phase, 0) > 0, phase
    assert sum(snap["shares"].values()) == pytest.approx(1.0, abs=1e-9)
    out = io.StringIO()
    path = os.path.join(fresh, "snap.json")
    with open(path, "w") as fh:
        json.dump(snap, fh)
    stepprof.report(path, out=out, json_only=True)
    rec = json.loads(out.getvalue().splitlines()[-1])
    assert rec["verdict"] == stepprof.verdict()[0] == snap["verdict"]
