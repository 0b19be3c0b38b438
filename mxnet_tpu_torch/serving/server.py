"""Stdlib HTTP front end for the serving engine.

Counterpart of `mxnet_tpu/serving/server.py`: a ``ThreadingHTTPServer``
(the engine's bounded queue, not the socket layer, limits concurrency)
exposing

- ``POST /predict`` -- JSON ``{"inputs": {name: nested list},
  "deadline_ms": optional}`` -> ``{"outputs": [...], "shapes": [...]}``;
  engine rejections map to 429 (shed), 504 (deadline expired) and 503
  (draining/closed), a bad request to 400, a compute error to 500;
- ``GET /healthz`` -- 200 with the engine's `stats()` while it accepts
  work and a replica worker is alive, 503 otherwise (a draining engine
  fails its health check first, so a balancer stops routing to it before
  shutdown). The body carries the saturation signals (``queue_depth``,
  ``pending``, ``slo.burn_rate`` per window), the compile counts
  (``warmup_compiles``, ``cold_compiles``) and memprof's headroom triple
  (``headroom_bytes``, ``peak_fraction``, ``admission_rejections_total``);
- ``GET /metrics`` -- the whole telemetry registry as Prometheus text
  (`telemetry.dumps()`);
- ``POST /shutdown`` -- only with ``allow_shutdown=True``: drains the
  engine and stops the server;
- any other route -- 404.

Request tracing (`serving/reqtrace.py`): every request gets a trace id
-- the ``X-Request-Id`` header when the client sent one (sanitized),
minted otherwise -- propagated into the engine's per-request anatomy,
echoed back as an ``X-Request-Id`` response header on every route, and
embedded as ``request_id`` in error bodies, so a failing request can be
joined to its ``serving.request`` span in the telemetry JSONL. Every
route also feeds ``serving_http_requests_total{route=,code=}`` and
``serving_http_seconds{route=}``.

CLI::

    python -m mxnet_tpu_torch.serving.server --symbol net.json \\
        --params net.params --input data:35 --port 8000

serves on ``gpu(0)`` (``--ctx cpu`` for the CPU) and prints one
``SERVING {json}`` line with the bound address once every bucket is warm.
"""
from __future__ import annotations

import argparse
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import telemetry
from ..base import MXNetError
from ..context import cpu, gpu
from . import reqtrace
from .engine import EngineConfig, InferenceEngine, RequestRejected

__all__ = ["serve", "ServingHTTPServer", "main"]

logger = logging.getLogger("mxnet_tpu_torch.serving")

#: request-body cap: a bigger predict body is a client error
MAX_BODY_BYTES = 64 << 20

_REJECT_HTTP = {"shed": 429, "expired": 504, "closed": 503}

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_ROUTES = ("/predict", "/healthz", "/metrics", "/shutdown")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # set per request in _handle before route dispatch
    _rid = None
    _code = 0

    def log_message(self, fmt, *args):   # stderr spam -> debug log
        logger.debug("http: " + fmt, *args)

    def _send(self, code, body, content_type):
        self._code = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if self._rid:
            self.send_header("X-Request-Id", self._rid)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code, doc):
        self._send(code, json.dumps(doc).encode("utf-8"),
                   "application/json")

    def _send_error(self, code, doc):
        """An error body, carrying the request's trace id."""
        self._send_json(code, dict(doc, request_id=self._rid))

    def _handle(self, dispatch):
        """Route wrapper: resolve the trace id (the client's
        ``X-Request-Id`` or a minted one) and feed the per-route
        status/latency series whatever the route does."""
        self._rid = reqtrace.clean_request_id(
            self.headers.get("X-Request-Id"))
        self._code = 0
        route = self.path if self.path in _ROUTES else "other"
        t0 = time.monotonic()
        try:
            dispatch()
        finally:
            telemetry.histogram(
                "serving_http_seconds",
                help="HTTP handler wall time by route",
                route=route).observe(time.monotonic() - t0)
            telemetry.counter(
                "serving_http_requests_total",
                help="HTTP requests by route and status code",
                route=route, code=str(self._code)).inc()

    def do_GET(self):
        self._handle(self._get)

    def do_POST(self):
        self._handle(self._post)

    def _get(self):
        if self.path == "/healthz":
            st = self.server.engine.stats()
            healthy = (not st["closed"] and not st["draining"]
                       and st["workers_alive"] > 0)
            st["status"] = "ok" if healthy else "unhealthy"
            self._send_json(200 if healthy else 503, st)
        elif self.path == "/metrics":
            self._send(200, telemetry.dumps().encode("utf-8"),
                       PROM_CONTENT_TYPE)
        else:
            self._send_error(404, {"error": "no route %r" % self.path})

    def _post(self):
        if self.path == "/predict":
            self._predict()
        elif self.path == "/shutdown" and self.server.allow_shutdown:
            self._send_json(200, {"status": "shutting down"})
            # stop() joins the serve thread; it must run OFF a handler
            # thread or serve_forever deadlocks waiting on this request
            threading.Thread(target=self.server.stop, daemon=True).start()
        else:
            self._send_error(404, {"error": "no route %r" % self.path})

    def _predict(self):
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length <= 0:
            return self._send_error(400, {"error": "a JSON body with "
                                                   "Content-Length is "
                                                   "required"})
        if length > MAX_BODY_BYTES:
            return self._send_error(413, {"error": "body of %d bytes "
                                          "exceeds the %d byte cap"
                                          % (length, MAX_BODY_BYTES)})
        try:
            doc = json.loads(self.rfile.read(length).decode("utf-8"))
            arrays = {str(k): np.asarray(v)
                      for k, v in doc["inputs"].items()}
            deadline_ms = doc.get("deadline_ms")
        except (ValueError, KeyError, TypeError, AttributeError) as exc:
            return self._send_error(400, {"error": "bad request body: %s"
                                          % exc})
        try:
            outs = self.server.engine.predict(arrays,
                                              deadline_ms=deadline_ms,
                                              rid=self._rid)
        except RequestRejected as exc:
            return self._send_error(_REJECT_HTTP.get(exc.status, 503),
                                    {"error": str(exc),
                                     "status": exc.status})
        except MXNetError as exc:   # validation: client's fault
            return self._send_error(400, {"error": str(exc)})
        except Exception as exc:    # compute/engine failure: ours
            logger.exception("predict failed")
            return self._send_error(500, {"error": repr(exc),
                                          "status": "error"})
        self._send_json(200, {"outputs": [o.tolist() for o in outs],
                              "shapes": [list(o.shape) for o in outs]})


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to one engine; `serve` wires it up."""

    daemon_threads = True

    def __init__(self, addr, engine, allow_shutdown=False):
        super().__init__(addr, _Handler)
        self.engine = engine
        self.allow_shutdown = allow_shutdown
        self._thread = None

    @property
    def port(self):
        return self.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True,
                                        name="mxnet_tpu_torch-serving-http")
        self._thread.start()
        return self

    def stop(self, drain=True):
        """Drain the engine, then stop accepting connections."""
        self.engine.shutdown(drain=drain)
        self.shutdown()
        self.server_close()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.stop()

    def join(self, timeout=None):
        """Wait for the serve thread to stop (after ``/shutdown`` or
        :meth:`stop`); True when it has."""
        if self._thread is not None:
            self._thread.join(timeout)
        return self._thread is None or not self._thread.is_alive()


def serve(engine, host="127.0.0.1", port=0, allow_shutdown=False):
    """Start serving ``engine`` over HTTP on a daemon thread; returns
    the :class:`ServingHTTPServer` (``.port`` for ``port=0``)."""
    return ServingHTTPServer((host, port), engine,
                             allow_shutdown=allow_shutdown).start()


def _parse_input_spec(specs):
    """``name:2,3`` per-example shape args -> {"name": (2, 3)}."""
    shapes = {}
    for spec in specs:
        name, _, dims = spec.partition(":")
        if not name:
            raise SystemExit("bad --input %r (want name:d1,d2,...)" % spec)
        shapes[name] = tuple(int(d) for d in dims.split(",") if d != "")
    return shapes


def _parse_ctx(spec):
    """``gpu``, ``gpu:N`` or ``cpu`` -> Context."""
    kind, _, idx = spec.partition(":")
    if kind not in ("gpu", "cpu"):
        raise SystemExit("bad --ctx %r (want gpu, gpu:N or cpu)" % spec)
    return (gpu if kind == "gpu" else cpu)(int(idx or 0))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a (symbol JSON, params) model over HTTP with "
                    "dynamic batching")
    ap.add_argument("--symbol", required=True,
                    help="symbol JSON file (Symbol.tojson)")
    ap.add_argument("--params", required=True, help=".params file")
    ap.add_argument("--input", required=True, action="append",
                    help="per-example input shape, name:d1,d2,... "
                         "(repeatable; NO batch axis)")
    ap.add_argument("--ctx", default="gpu",
                    help="device: gpu, gpu:N or cpu (default gpu = gpu:0)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 picks a free port (printed on the SERVING "
                         "line)")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-delay-ms", type=float, default=None)
    ap.add_argument("--queue-depth", type=int, default=None)
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--allow-shutdown", action="store_true",
                    help="expose POST /shutdown (tests, supervised "
                         "deployments)")
    args = ap.parse_args(argv)

    with open(args.symbol, "r", encoding="utf-8") as fh:
        symbol_json = fh.read()
    cfg = EngineConfig(max_batch_size=args.max_batch,
                       max_batch_delay_ms=args.max_delay_ms,
                       max_queue=args.queue_depth,
                       replicas=args.replicas)
    engine = InferenceEngine(symbol_json, args.params,
                             input_shapes=_parse_input_spec(args.input),
                             ctx=_parse_ctx(args.ctx), config=cfg)
    server = ServingHTTPServer((args.host, args.port), engine,
                               allow_shutdown=args.allow_shutdown)
    print("SERVING %s" % json.dumps({
        "host": args.host, "port": server.port, "ctx": args.ctx,
        "buckets": engine.buckets,
        "warmup_compiles": engine.warmup_compiles,
        "warmup_seconds": engine.warmup_seconds}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.shutdown()
        server.server_close()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
