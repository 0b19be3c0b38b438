#!/usr/bin/env python
"""Serving load generator: closed- and open-loop benchmarks against the
port's dynamic-batching inference engine (`mxnet_tpu_torch/serving/`).

Counterpart of the repository's ``tools/serve_bench.py`` (the JAX
package's), with its load models, its JSON metric lines and their names:

- **closed loop** (``--mode closed``): N client threads, each holding at
  most one request in flight (submit, block on the result, repeat).
  Measures sustainable throughput -- "how fast can K users go".
- **open loop** (``--mode open``): requests fire at a fixed arrival rate
  regardless of completions (``--qps``), the way real traffic arrives.
  Latency percentiles under an open load expose queueing delay the
  closed loop hides; shed counts expose where backpressure engages.

Reports throughput and p50/p95/p99 as JSON metric lines
(``{"metric", "value", "unit", ...}``). Every generated request carries a
trace id (``rid=`` into the engine, ``X-Request-Id`` over HTTP), so a run's
tail is attributable: the in-process paths reset `serving.reqtrace` per
loop and attach the p99 phase shares and the verdict to the p99 line.

The default target is a built-in small MLP engine on ``--ctx gpu``
(``gpu(0)``; ``--ctx cpu`` runs it on the CPU); ``--symbol/--params/
--input`` serve an exported model (the PTB LM, for one), and ``--url
http://host:port`` a RUNNING server (closed loop only: an open loop over
HTTP would measure the client's connection churn, not the engine)::

    python3 mxnet_tpu_torch/tools/serve_bench.py --mode both --ctx cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _ctx(spec):
    """A Context, or one parsed from ``gpu``, ``gpu:N`` or ``cpu``
    (default ``gpu``)."""
    from mxnet_tpu_torch.context import Context
    from mxnet_tpu_torch.serving.server import _parse_ctx
    return spec if isinstance(spec, Context) else _parse_ctx(spec or "gpu")


def build_demo_engine(config=None, ctx=None):
    """A small MLP engine over random weights: enough compute to batch,
    small enough to warm in a second. Returns ``(engine, input_name,
    example_shape)``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import InferenceEngine

    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=64, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(h, num_hidden=10, name="fc2")
    shapes, _, _ = net.infer_shape(data=(2, 32))
    rng = np.random.RandomState(0)
    params = {name: mx.nd.array((rng.randn(*shape) * 0.1).astype(
        np.float32), ctx=mx.cpu())
        for name, shape in zip(net.list_arguments(), shapes)
        if name != "data"}
    engine = InferenceEngine(net.tojson(), params, {"data": (32,)},
                             ctx=_ctx(ctx), config=config)
    return engine, "data", (32,)


def build_file_engine(symbol_path, params_path, input_specs, config=None,
                      ctx=None):
    from mxnet_tpu_torch.serving import InferenceEngine
    from mxnet_tpu_torch.serving.server import _parse_input_spec
    with open(symbol_path, "r", encoding="utf-8") as fh:
        symbol_json = fh.read()
    shapes = _parse_input_spec(input_specs)
    engine = InferenceEngine(symbol_json, params_path, shapes,
                             ctx=_ctx(ctx), config=config)
    name, shape = next(iter(shapes.items()))
    return engine, name, shape


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) \
        * (pos - lo)


class _Tally:
    """Thread-safe latency/status accumulator."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies = []      # seconds, completed requests only
        self.statuses = {}       # status -> count
        self.rows_done = 0

    def ok(self, latency, rows):
        with self.lock:
            self.latencies.append(latency)
            self.statuses["ok"] = self.statuses.get("ok", 0) + 1
            self.rows_done += rows

    def fail(self, status):
        with self.lock:
            self.statuses[status] = self.statuses.get(status, 0) + 1

    def records(self, mode, elapsed):
        lats = sorted(self.latencies)
        done = len(lats)
        recs = [
            {"metric": "serving_%s_rps" % mode,
             "value": round(done / elapsed, 2) if elapsed else 0.0,
             "unit": "req/s", "mode": mode},
            {"metric": "serving_%s_rows_per_sec" % mode,
             "value": round(self.rows_done / elapsed, 2) if elapsed
             else 0.0,
             "unit": "rows/s", "mode": mode},
        ]
        for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            recs.append({"metric": "serving_%s_%s_ms" % (mode, label),
                         "value": round(_percentile(lats, q) * 1e3, 3),
                         "unit": "ms", "mode": mode})
        for status, count in sorted(self.statuses.items()):
            if status != "ok":
                recs.append({"metric": "serving_%s_%s_total"
                             % (mode, status),
                             "value": count, "unit": "requests",
                             "mode": mode})
        return recs


def _status_of(exc):
    return getattr(exc, "status", "error")


def run_closed(submit_and_wait, clients, requests_per_client, sizes,
               make_input):
    """Closed loop: ``clients`` threads each issue
    ``requests_per_client`` blocking requests of rotating ``sizes``.
    ``submit_and_wait(inputs, rid) -> rows`` raises on rejection or
    error; ``rid`` is the per-request trace id the submitter must pass on
    (engine ``rid=`` / HTTP ``X-Request-Id``)."""
    tally = _Tally()

    def client(cid):
        rng = np.random.RandomState(cid)
        for i in range(requests_per_client):
            n = sizes[(cid + i) % len(sizes)]
            inputs = make_input(n, rng)
            t0 = time.monotonic()
            try:
                rows = submit_and_wait(inputs, "bench-c%d-%d" % (cid, i))
            except Exception as exc:   # noqa: BLE001 - tallied
                tally.fail(_status_of(exc))
                continue
            tally.ok(time.monotonic() - t0, rows)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return tally, time.monotonic() - t0


def run_open(engine, qps, seconds, sizes, make_input):
    """Open loop: fire ``engine.submit`` at a fixed ``qps`` for
    ``seconds`` without waiting; latencies land via future callbacks
    (arrival-time anchored, so queueing delay is IN the number)."""
    from mxnet_tpu_torch.serving import RequestRejected

    if qps <= 0:
        raise ValueError("open-loop qps must be > 0, got %g" % qps)
    tally = _Tally()
    rng = np.random.RandomState(0)
    interval = 1.0 / qps
    futures = []
    t0 = time.monotonic()
    i = 0
    while time.monotonic() - t0 < seconds:
        target = t0 + i * interval
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        n = sizes[i % len(sizes)]
        sent = time.monotonic()
        try:
            fut = engine.submit(make_input(n, rng), rid="bench-o%d" % i)
        except RequestRejected as exc:
            tally.fail(exc.status)
        else:
            def _done(f, sent=sent, n=n):
                exc = f.exception()
                if exc is None:
                    tally.ok(time.monotonic() - sent, n)
                else:
                    tally.fail(_status_of(exc))
            fut.add_done_callback(_done)
            futures.append(fut)
        i += 1
    for fut in futures:
        try:
            fut.result(timeout=30)
        except Exception:   # noqa: BLE001 - already tallied by callback
            pass
    return tally, time.monotonic() - t0


def http_submit_and_wait(host, port, input_name, timeout=30):
    """Closed-loop submitter over HTTP (one connection per client
    thread, stdlib only)."""
    import http.client
    local = threading.local()

    def call(inputs, rid=None):
        conn = getattr(local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
            local.conn = conn
        body = json.dumps({"inputs": {k: v.tolist()
                                      for k, v in inputs.items()}})
        headers = {"Content-Type": "application/json"}
        if rid:
            headers["X-Request-Id"] = rid
        try:
            conn.request("POST", "/predict", body, headers)
            resp = conn.getresponse()
            doc = json.loads(resp.read())
        except Exception:
            local.conn = None   # poisoned connection: rebuild next call
            raise
        if resp.status != 200:
            err = RuntimeError(doc.get("error", "HTTP %d" % resp.status))
            err.status = doc.get("status", "error")
            raise err
        return len(inputs[input_name])

    return call


def _attach_anatomy(records, mode):
    """Fold the reqtrace window's tail attribution into this loop's
    records: the p99 metric line carries the p99 phase shares and the
    verdict, plus a pad-waste line."""
    from mxnet_tpu_torch.serving import reqtrace
    att = reqtrace.tracer.attribution()
    if not att["requests"]:
        return
    verdict, _hint = reqtrace.classify(
        att["p99_shares"], shed_fraction=att["shed_fraction"],
        pad_waste=att["pad"].get("waste_ratio"))
    for rec in records:
        if rec.get("metric") == "serving_%s_p99_ms" % mode:
            rec["phases"] = {k: round(v, 4)
                             for k, v in att["p99_shares"].items()}
            rec["verdict"] = verdict
    records.append({"metric": "serving_%s_pad_waste_ratio" % mode,
                    "value": round(att["pad"].get("waste_ratio", 0.0), 4),
                    "unit": "ratio", "mode": mode})


def bench_records(clients=8, requests_per_client=25, qps=150.0,
                  seconds=2.0, sizes=(1, 2, 3, 5), config=None,
                  mode="both", engine_factory=None, ctx=None):
    """The one in-process bench path (the CLI's non-URL branch lands
    here): closed and/or open loop against ``engine_factory()`` (default:
    the demo engine on ``ctx``); returns the metric records (the engine
    is shut down)."""
    from mxnet_tpu_torch.serving import reqtrace
    make = engine_factory or (lambda: build_demo_engine(config=config,
                                                        ctx=ctx))
    engine, name, shape = make()
    records = [{"metric": "serving_warmup_compiles",
                "value": engine.warmup_compiles, "unit": "compiles",
                "buckets": engine.buckets}]

    def make_input(n, rng):
        return {name: rng.rand(n, *shape).astype(np.float32)}

    def submit_and_wait(inputs, rid=None):
        engine.predict(inputs, timeout=30, rid=rid)
        return len(inputs[name])

    try:
        if mode in ("closed", "both"):
            reqtrace.reset()   # this loop's window, not warmup's
            tally, elapsed = run_closed(submit_and_wait, clients,
                                        requests_per_client, list(sizes),
                                        make_input)
            recs = tally.records("closed", elapsed)
            _attach_anatomy(recs, "closed")
            records.extend(recs)
        if mode in ("open", "both"):
            reqtrace.reset()
            tally, elapsed = run_open(engine, qps, seconds, list(sizes),
                                      make_input)
            recs = tally.records("open", elapsed)
            _attach_anatomy(recs, "open")
            records.extend(recs)
        records.append({"metric": "serving_cold_compiles",
                        "value": engine.cold_compiles(),
                        "unit": "compiles"})
        # memory anatomy: peak device bytes ride alongside p99, so a
        # latency regression and a memory regression read from one run
        try:
            from mxnet_tpu_torch import memprof
            records.append({"metric": "serving_peak_hbm_bytes",
                            "value": memprof.peak_hbm_bytes(),
                            "unit": "bytes"})
        except Exception as e:
            records.append({"metric": "serving_peak_hbm_bytes",
                            "value": None, "unit": "bytes",
                            "error": str(e)[:200]})
    finally:
        engine.shutdown()
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["closed", "open", "both"],
                    default="both")
    ap.add_argument("--clients", type=int, default=8,
                    help="closed-loop client threads")
    ap.add_argument("--requests", type=int, default=25,
                    help="closed-loop requests per client")
    ap.add_argument("--qps", type=float, default=150.0,
                    help="open-loop arrival rate")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="open-loop duration")
    ap.add_argument("--sizes", default="1,2,3,5",
                    help="rotating request row counts")
    ap.add_argument("--ctx", default="gpu",
                    help="device of the in-process engine: gpu, gpu:N or "
                         "cpu (default gpu = gpu:0)")
    ap.add_argument("--symbol", default=None)
    ap.add_argument("--params", default=None)
    ap.add_argument("--input", action="append", default=None,
                    help="name:d1,d2,... per-example shape (with "
                         "--symbol)")
    ap.add_argument("--url", default=None,
                    help="benchmark a RUNNING server (host:port or "
                         "http://host:port; closed loop only)")
    ap.add_argument("--out", default=None,
                    help="also append the JSON metric lines to a file")
    args = ap.parse_args(argv)
    if args.mode in ("open", "both") and args.qps <= 0 and not args.url:
        ap.error("--qps must be > 0 for open-loop mode")
    sizes = [int(s) for s in args.sizes.split(",") if s]

    records = []
    if args.url:
        target = args.url.split("//")[-1].rstrip("/")
        host, _, port = target.partition(":")
        input_name, shape = "data", (32,)
        if args.input:
            from mxnet_tpu_torch.serving.server import _parse_input_spec
            input_name, shape = next(iter(
                _parse_input_spec(args.input).items()))
        call = http_submit_and_wait(host, int(port or 80), input_name)

        def make_input(n, rng):
            return {input_name: rng.rand(n, *shape).astype(np.float32)}

        tally, elapsed = run_closed(call, args.clients, args.requests,
                                    sizes, make_input)
        records.extend(tally.records("closed", elapsed))
    else:
        factory = None
        if args.symbol:
            factory = lambda: build_file_engine(  # noqa: E731
                args.symbol, args.params, args.input, ctx=args.ctx)
        records = bench_records(
            clients=args.clients, requests_per_client=args.requests,
            qps=args.qps, seconds=args.seconds, sizes=sizes,
            mode=args.mode, engine_factory=factory, ctx=args.ctx)

    for rec in records:
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a", encoding="utf-8") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
