"""Inference serving: dynamic micro-batching over batch-size buckets,
backpressure, an HTTP front end and per-request observability
(counterpart of `mxnet_tpu/serving/`).

- `batching` -- bucketing math (ladder, pick, pad, split) and the
  :class:`PadLedger`;
- `reqtrace` -- request anatomy: per-request trace ids and the fixed
  ``queue_wait/batch_wait/pad/dispatch/device_compute/split/respond``
  phase taxonomy, the :class:`SLOTracker` burn-rate gauges, and the
  ``python -m mxnet_tpu_torch.serving.reqtrace report`` tail-latency
  attribution CLI;
- `engine` -- :class:`InferenceEngine`: replica pool, one captured CUDA
  graph per bucket, bounded queue, dynamic micro-batching, deadlines,
  load shedding (:class:`RequestRejected`), drain/shutdown, worker
  crash recovery, memory admission;
- `server` -- stdlib HTTP front end: ``/predict`` (with
  ``X-Request-Id`` propagation), ``/healthz`` (saturation-aware),
  ``/metrics`` (Prometheus text), ``/shutdown``.
"""
from .batching import (bucket_sizes, pick_bucket, pad_rows, split_rows,
                       PadLedger)
from . import reqtrace
from .reqtrace import SLOTracker
from .engine import EngineConfig, InferenceEngine, RequestRejected
from .server import ServingHTTPServer, serve

__all__ = ["bucket_sizes", "pick_bucket", "pad_rows", "split_rows",
           "PadLedger", "reqtrace", "SLOTracker",
           "EngineConfig", "InferenceEngine", "RequestRejected",
           "ServingHTTPServer", "serve"]
