"""The serving stack's hooks on the CPU: the compiled inference forward,
compile accounting, request tracing, ``/metrics``, ``X-Request-Id``,
``/healthz``, chaos and worker respawn, memory admission, and
``tools/serve_bench.py``.

The LM graph of `test_torch_symbol` (small widths) with seeded weights;
the engine's outputs are held against the JAX package's ``Predictor``,
which runs with its compile-tracking layer off (``MXNET_XLA_STATS=0``:
under the installed JAX it fails, ROADMAP C), and the JAX engine's
``stats()`` and metric names against the port's.
"""
import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import chaos, compiled, memprof, telemetry
from mxnet_tpu_torch.serving import reqtrace

from test_torch_symbol import T, V, lm

TOL = 1e-5
STATES = ("data", "lstm_state", "lstm_state_cell")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    sym = lm(mxt)
    shapes, _, _ = sym.infer_shape(data=(1, T))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in STATES}
    return sym.tojson(), params


@pytest.fixture(autouse=True)
def _no_chaos():
    chaos.clear()
    yield
    chaos.clear()


def _tokens(rng, n):
    return rng.randint(0, V, (n, T)).astype(np.float32)


def _engine(model, warmup=True, ctx=None, **cfg):
    js, params = model
    return mxt.serving.InferenceEngine(
        js, mxt.params_from_numpy(params, mxt.cpu()),
        input_shapes={"data": (T,)}, ctx=ctx or mxt.cpu(),
        config=mxt.serving.EngineConfig(**cfg), warmup=warmup)


def _metric(name, **labels):
    m = telemetry.get_metric(name, **labels)
    if m is None:
        return 0.0
    return m.read() if hasattr(m, "read") else m.value


def _jax_predictor(model, rows):
    js, params = model
    return mx.Predictor(js, {k: mx.nd.array(v) for k, v in params.items()},
                        ctx=mx.cpu(), input_shapes={"data": (rows, T)})


# ---------------------------------------------------------------------------
# the compiled inference forward
# ---------------------------------------------------------------------------

def test_predictor_family_shares_one_program(model):
    js, params = model
    base = mxt.Predictor(js, mxt.params_from_numpy(params, mxt.cpu()),
                         ctx=mxt.cpu(), input_shapes={"data": (1, T)})
    sib = base.sibling({"data": (4, T)})
    other = mxt.Predictor(js, mxt.params_from_numpy(params, mxt.cpu()),
                          ctx=mxt.cpu(), input_shapes={"data": (1, T)})
    assert sib._exec._program is base._exec._program
    assert other._exec._program is not base._exec._program
    before = compiled.compile_counts()
    rng = np.random.RandomState(1)
    for pred, rows in ((base, 1), (sib, 4), (base, 1), (sib, 4)):
        pred.forward(data=_tokens(rng, rows))
    after = compiled.compile_counts()
    assert after["compiles"] - before["compiles"] == 2
    assert after["cache_hits"] - before["cache_hits"] == 2
    base.reshape({"data": (4, T)})
    assert base._exec._program is sib._exec._program


@pytest.mark.parametrize("rows", [1, 3])
def test_compiled_forward_matches_jax_and_eager(model, rows, monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")
    toks = _tokens(np.random.RandomState(rows), rows)
    jp = _jax_predictor(model, rows)
    jp.forward(data=toks)
    js, params = model
    tp = mxt.Predictor(js, mxt.params_from_numpy(params, mxt.cpu()),
                       ctx=mxt.cpu(), input_shapes={"data": (rows, T)})
    outs = []
    for _ in range(2):          # a compile, then a cache hit
        tp.forward(data=toks)
        outs.append(tp.get_output(0))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[1], jp.get_output(0), rtol=TOL,
                               atol=TOL)
    # the monitored forward runs the graph eagerly, op by op: same result
    seen = []
    tp._exec.set_monitor_callback(lambda name, arr: seen.append(name))
    tp.forward(data=toks)
    np.testing.assert_allclose(tp.get_output(0), outs[1], rtol=1e-6,
                               atol=1e-7)
    assert seen


def test_moved_storage_is_one_retrace_naming_it(model):
    eng = _engine(model, max_batch_size=2)
    try:
        assert eng.cold_compiles() == 0
        pred = eng._replicas[0].preds[2]
        w = pred._exec.arg_dict["decoder_weight"]
        w._data = w._data.clone()        # the storage moves
        eng.predict({"data": _tokens(np.random.RandomState(0), 2)},
                    timeout=60)
        assert eng.cold_compiles() == 1
        reason = compiled.last_retrace()["reason"]
        assert "decoder_weight" in reason and "storage moved" in reason
    finally:
        eng.shutdown()


def test_training_forward_stays_eager_and_score_counts(model):
    sym = mxt.sym.SoftmaxOutput(mxt.sym.FullyConnected(
        mxt.sym.var("data"), num_hidden=4, name="fc"), name="softmax")
    mod = mxt.mod.Module(sym, context=mxt.cpu())
    x = np.random.RandomState(0).rand(32, 6).astype(np.float32)
    it = mxt.io.NDArrayIter(x, np.zeros(32, np.float32), batch_size=8)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    before = compiled.compile_counts()
    mod.forward(next(iter(it)), is_train=True)
    assert compiled.compile_counts() == before
    it.reset()
    mod.score(it, "acc")
    after = compiled.compile_counts()
    assert after["compiles"] - before["compiles"] == 1
    assert after["cache_hits"] - before["cache_hits"] == 3


# ---------------------------------------------------------------------------
# the engine's hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("replicas", [1, 2])
def test_engine_matches_jax_with_warm_compiles(model, replicas,
                                               monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")
    rng = np.random.RandomState(4 + replicas)
    reqs = [_tokens(rng, int(rng.randint(1, 5))) for _ in range(24)]
    allrows = np.concatenate(reqs)
    jp = _jax_predictor(model, allrows.shape[0])
    jp.forward(data=allrows)
    want = np.split(jp.get_output(0),
                    np.cumsum([r.shape[0] for r in reqs])[:-1])
    eng = _engine(model, max_batch_size=8, max_batch_delay_ms=2.0,
                  max_queue=64, replicas=replicas)
    try:
        assert eng.warmup_compiles == replicas * len(eng.buckets)
        ids = ["client-%d" % i for i in range(len(reqs))]
        with ThreadPoolExecutor(6) as pool:
            outs = list(pool.map(
                lambda a: eng.predict({"data": a[0]}, timeout=60,
                                      rid=a[1])[0], zip(reqs, ids)))
        for got, exp in zip(outs, want):
            np.testing.assert_allclose(got, exp, rtol=TOL, atol=TOL)
        assert eng.cold_compiles() == 0
        st = eng.stats()
        for key in ("queue_depth", "pending", "slo", "workers_alive",
                    "replicas", "warmup_compiles", "cold_compiles",
                    "headroom_bytes", "peak_fraction",
                    "admission_rejections_total"):
            assert key in st, key
        assert st["workers_alive"] == st["replicas"] == replicas
        assert st["cold_compiles"] == 0 and st["pending"] == 0
        assert st["slo"]["good_total"] >= len(reqs)
    finally:
        eng.shutdown()


def test_stats_and_metric_names_cover_the_jax_engine(model, monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")
    from mxnet_tpu import telemetry as jax_telemetry
    from mxnet_tpu.serving import EngineConfig, InferenceEngine
    js, params = model
    jeng = InferenceEngine(js, {k: mx.nd.array(v) for k, v in
                                params.items()}, {"data": (T,)},
                           ctx=mx.cpu(), config=EngineConfig(
                               max_batch_size=1), warmup=False)
    peng = _engine(model, warmup=False, max_batch_size=1)
    try:
        toks = _tokens(np.random.RandomState(3), 1)
        jeng.predict({"data": toks}, timeout=120)
        peng.predict({"data": toks}, timeout=60)
        assert set(jeng.stats()) <= set(peng.stats())
        names = lambda text: set(re.findall(r"^# TYPE (serving_\w+)",
                                            text, re.M))
        assert names(jax_telemetry.dumps()) <= names(telemetry.dumps())
    finally:
        jeng.shutdown()
        peng.shutdown()


def test_request_ids_reach_rejections_and_traces(model):
    eng = _engine(model, max_batch_size=2, max_queue=2)
    try:
        eng.predict({"data": _tokens(np.random.RandomState(0), 1)},
                    timeout=60, rid="trace-me-1")
        assert any(r["rid"] == "trace-me-1"
                   for r in reqtrace.tracer.records())
        with pytest.raises(mxt.serving.RequestRejected) as exc:
            eng.submit({"data": _tokens(np.random.RandomState(0), 1)},
                       deadline_ms=-5, rid="late\n-one")
        assert exc.value.status == "expired" and exc.value.rid == "late-one"
    finally:
        eng.shutdown()
    with pytest.raises(mxt.serving.RequestRejected) as exc:
        eng.submit({"data": _tokens(np.random.RandomState(0), 1)},
                   rid="after-close")
    assert exc.value.status == "closed" and exc.value.rid == "after-close"


def test_phases_telescope_for_every_request(model):
    reqtrace.reset()
    eng = _engine(model, max_batch_size=4, max_batch_delay_ms=1.0)
    try:
        rng = np.random.RandomState(7)
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(lambda r: eng.predict({"data": r}, timeout=60),
                          [_tokens(rng, int(rng.randint(1, 4)))
                           for _ in range(20)]))
        recs = reqtrace.tracer.records()
        assert len(recs) == 20
        for rec in recs:
            assert set(rec["phases"]) == set(reqtrace.PHASES)
            assert sum(rec["phases"].values()) == pytest.approx(
                rec["total"], abs=1e-9)
            assert rec["bucket"] in eng.buckets
        att = reqtrace.tracer.attribution()
        assert sum(att["p99_shares"].values()) == pytest.approx(1.0)
    finally:
        eng.shutdown()


def test_slow_request_lands_in_batch_wait(model):
    eng = _engine(model, max_batch_size=1, max_batch_delay_ms=0.0)
    try:
        reqtrace.reset()
        with chaos.armed("serving.slow_request", value="0.2"):
            eng.predict({"data": _tokens(np.random.RandomState(0), 1)},
                        timeout=60)
        rec, = reqtrace.tracer.records()
        assert rec["phases"]["batch_wait"] >= 0.2
        assert max(rec["phases"], key=rec["phases"].get) == "batch_wait"
        assert chaos.fired("serving.slow_request") == 1
    finally:
        eng.shutdown()


def test_worker_death_fails_only_the_inflight_batch(model, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_DIR", str(tmp_path))
    eng = _engine(model, max_batch_size=2, max_batch_delay_ms=0.0)
    deaths = _metric("serving_worker_deaths_total", replica="0")
    respawns = _metric("serving_worker_respawns_total")
    errors = _metric("serving_requests_total", status="error")
    try:
        chaos.arm("serving.worker_death")
        with pytest.raises(mxt.MXNetError, match="worker died"):
            eng.predict({"data": _tokens(np.random.RandomState(0), 2)},
                        timeout=60)
        rng = np.random.RandomState(1)
        for _ in range(20):
            out = eng.predict({"data": _tokens(rng, 1)}, timeout=60)[0]
            assert out.shape == (1, T, V)
        assert _metric("serving_worker_deaths_total",
                       replica="0") - deaths == 1
        assert _metric("serving_worker_respawns_total") - respawns == 1
        assert _metric("serving_requests_total",
                       status="error") - errors == 1
        assert eng._replicas[0].deaths == 1
        assert eng.stats()["workers_alive"] == 1
        assert eng.cold_compiles() == 0
        dump = tmp_path / ("flightrecorder-host%d.json"
                           % telemetry.host_id())
        assert json.loads(dump.read_text())["reason"] == \
            "serving.worker_death"
    finally:
        eng.shutdown()


def test_admission_refuses_before_any_replica_binds(model, monkeypatch):
    # no allocator on the CPU: a device record with a 1 MiB limit stands
    # for the card's
    fake = [{"device": "cuda:0", "kind": "test", "bytes_in_use": 0,
             "peak_bytes_in_use": 0, "bytes_limit": 1 << 20}]
    monkeypatch.setattr(memprof, "_raw_device_stats", lambda limit=64: fake)
    rejections = _metric("admission_rejections_total")
    compiles = compiled.compile_counts()["compiles"]
    js, params = model
    with pytest.raises(memprof.MemoryAdmissionError) as exc:
        mxt.serving.InferenceEngine(
            js, mxt.params_from_numpy(params, mxt.cpu()),
            input_shapes={"data": (T,)}, ctx=[mxt.cpu()] * 64,
            config=mxt.serving.EngineConfig(max_batch_size=2))
    assert "64 replica(s)" in str(exc.value)
    assert exc.value.decision["admitted"] is False
    assert _metric("admission_rejections_total") - rejections == 1
    assert compiled.compile_counts()["compiles"] == compiles
    eng = _engine(model, warmup=False, max_batch_size=1)   # fits: admitted
    try:
        assert eng.stats()["admission_rejections_total"] >= 1
        assert eng.stats()["headroom_bytes"] is not None
    finally:
        eng.shutdown()


def test_shutdown_freezes_the_engine_gauges(model):
    eng = _engine(model, max_batch_size=1)
    eng.shutdown()
    gauge = telemetry.get_metric("serving_workers_alive",
                                 engine=eng._engine_label)
    assert gauge.read() == 0


# ---------------------------------------------------------------------------
# HTTP: /metrics, X-Request-Id, /healthz
# ---------------------------------------------------------------------------

def _http(port, path, doc=None, rid=None):
    body = None if doc is None else json.dumps(doc).encode()
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path), data=body,
        method="GET" if doc is None else "POST", headers=headers)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def _prom(text, name, **labels):
    """The sum of ``name``'s samples whose labels include ``labels``."""
    total = 0.0
    for m in re.finditer(r"^%s(\{[^}]*\})? (\S+)$" % re.escape(name), text,
                         re.M):
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1) or ""))
        if all(got.get(k) == v for k, v in labels.items()):
            total += float(m.group(2))
    return total


def test_http_metrics_request_ids_and_healthz(model):
    eng = _engine(model, max_batch_size=4)
    srv = mxt.serving.serve(eng, port=0, allow_shutdown=True)
    try:
        _, _, text0 = _http(srv.port, "/metrics")
        ok0 = _prom(text0.decode(), "serving_requests_total", status="ok")
        rng = np.random.RandomState(2)
        for i in range(5):
            code, headers, body = _http(
                srv.port, "/predict",
                {"inputs": {"data": _tokens(rng, 1 + i % 3).tolist()}},
                rid="client-rid-%d" % i)
            assert code == 200
            assert headers["X-Request-Id"] == "client-rid-%d" % i
        code, headers, _ = _http(srv.port, "/predict", {
            "inputs": {"data": _tokens(rng, 1).tolist()}})
        assert code == 200 and re.fullmatch(r"[0-9a-f]{16}",
                                            headers["X-Request-Id"])
        code, headers, body = _http(srv.port, "/predict",
                                    {"inputs": {"x": [[0]]}}, rid="bad-1")
        assert code == 400 and json.loads(body)["request_id"] == "bad-1"
        code, headers, body = _http(srv.port, "/nope", rid="lost")
        assert code == 404 and json.loads(body)["request_id"] == "lost"
        assert headers["X-Request-Id"] == "lost"
        code, headers, body = _http(srv.port, "/metrics")
        assert code == 200 and headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        text = body.decode()
        assert _prom(text, "serving_requests_total", status="ok") - ok0 \
            == 6
        assert _prom(text, "serving_batches_total") == \
            _metric_sum("serving_batches_total")
        assert _prom(text, "serving_http_requests_total", route="/predict",
                     code="200") >= 6
        code, _, body = _http(srv.port, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok"
        assert health["cold_compiles"] == 0
        assert health["warmup_compiles"] == len(eng.buckets)
        for key in ("headroom_bytes", "queue_depth", "pending", "slo",
                    "peak_fraction", "admission_rejections_total"):
            assert key in health
        assert _http(srv.port, "/shutdown", {})[0] == 200
        assert srv.join(timeout=60)
    finally:
        srv.stop()


def _metric_sum(name):
    snap = telemetry.snapshot().get(name) or {"series": []}
    return sum(s["value"] for s in snap["series"])


def test_server_cli_respawns_a_worker_killed_under_mxnet_chaos(model,
                                                                tmp_path):
    js, params = model
    (tmp_path / "lm.json").write_text(js)
    mxt.nd.save(str(tmp_path / "lm.params"),
                mxt.params_from_numpy(params, mxt.cpu()))
    env = dict(os.environ, MXNET_CHAOS="serving.worker_death",
               MXNET_TELEMETRY_DIR=str(tmp_path), PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving.server",
         "--symbol", str(tmp_path / "lm.json"), "--params",
         str(tmp_path / "lm.params"), "--input", "data:%d" % T, "--ctx",
         "cpu", "--port", "0", "--max-batch", "2", "--allow-shutdown"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVING "), proc.stderr.read()[-2000:]
        info = json.loads(line.split(" ", 1)[1])
        assert info["warmup_compiles"] == 2
        rng = np.random.RandomState(0)
        replies = [_http(info["port"], "/predict", {"inputs": {
            "data": _tokens(rng, 1).tolist()}}) for _ in range(6)]
        # the worker's death is an MXNetError, which the JAX package's
        # server, and so the port's, answers with 400
        assert [r[0] for r in replies] == [400] + [200] * 5
        assert "worker died" in json.loads(replies[0][2])["error"]
        text = _http(info["port"], "/metrics")[2].decode()
        assert _prom(text, "serving_worker_deaths_total") == 1
        assert _prom(text, "serving_worker_respawns_total") == 1
        assert _prom(text, "chaos_injections_total",
                     site="serving.worker_death") == 1
        assert _http(info["port"], "/shutdown", {})[0] == 200
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# serve_bench
# ---------------------------------------------------------------------------

def test_serve_bench_closed_and_open_on_the_demo_mlp():
    sys.path.insert(0, os.path.join(REPO, "mxnet_tpu_torch", "tools"))
    try:
        import serve_bench
    finally:
        sys.path.pop(0)
    records = serve_bench.bench_records(
        clients=4, requests_per_client=15, qps=100.0, seconds=1.5,
        mode="both", ctx="cpu",
        config=mxt.serving.EngineConfig(max_batch_size=8))
    by = {r["metric"]: r for r in records}
    assert by["serving_warmup_compiles"]["value"] == 4
    assert by["serving_cold_compiles"]["value"] == 0
    for mode in ("closed", "open"):
        assert by["serving_%s_rps" % mode]["value"] > 0
        p99 = by["serving_%s_p99_ms" % mode]
        assert p99["value"] >= by["serving_%s_p50_ms" % mode]["value"] > 0
        assert p99["verdict"] in reqtrace.VERDICT_HINTS
        assert sum(p99["phases"].values()) == pytest.approx(1.0, abs=1e-3)
        assert "serving_%s_pad_waste_ratio" % mode in by


def test_serve_bench_cli_against_a_running_server(model):
    eng = _engine(model, max_batch_size=4)
    srv = mxt.serving.serve(eng, port=0)
    try:
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "mxnet_tpu_torch", "tools",
                                          "serve_bench.py"),
             "--url", "http://127.0.0.1:%d" % srv.port, "--input",
             "data:%d" % T, "--clients", "2", "--requests", "3",
             "--sizes", "1,2"], capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
        assert out.returncode == 0, out.stderr[-2000:]
        recs = {json.loads(ln)["metric"]: json.loads(ln)
                for ln in out.stdout.splitlines()}
        assert recs["serving_closed_rps"]["value"] > 0
        assert "serving_closed_error_total" not in recs
    finally:
        srv.stop()
