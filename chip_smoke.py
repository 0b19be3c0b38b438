#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository on a host with a CUDA device::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, then serves the
2x650 PTB LSTM language model (vocab 10000, embed 650, 2 LSTM layers of
650, 35 steps, fp32; the configuration of
``examples/rnn/word_lm/benchmark.py``) with seeded random weights
through the port's user entry points, in six phases:

1. build the kernels (one ``nvcc`` per source, all at once);
2. ``fused_lstm`` kernel vs plain version at the served shapes
   (T=35, B in {1, 8, 32}, I=H=650) and at a ragged small shape, with
   kernel, plain and cuDNN (``torch.nn.LSTM``, timed as a yardstick only)
   times and the kernel's bound;
3. ``Predictor`` on ``gpu(0)`` vs the same ``Predictor`` on ``cpu()``;
4. ``InferenceEngine`` on ``gpu(0)`` (buckets 1..32) under 100 concurrent
   requests of 1-8 rows, sampled results held against the CPU reference;
5. the HTTP server in-process: two ``/predict`` requests, ``/healthz``,
   ``/shutdown``;
6. ``torch.profiler`` over one served forward at the top bucket: device
   time by kernel and the device's idle share;

and then trains the same LM, the configuration of the training benchmark
(``examples/rnn/word_lm/benchmark.py``: batch 32, SGD with lr 1 and
``clip_gradient`` 0.25, Xavier init), in three more:

7. the training kernels ``fused_lstm_train`` (K2) and
   ``lstm_bwd_recurrence`` (K3) vs their plain versions, and a
   ``FusedLSTM`` layer's six gradients vs the plain backward, at T=35,
   B in {8, 32}, I=H=650 and a ragged shape, with kernel, plain and cuDNN
   (forward, backward, both; timed as a yardstick only) times;
8. ``Module`` on ``gpu(0)`` from ``mx.random.seed(0)``: 2 ``_step``s held
   against the same Module on ``cpu()``, 20 timed steps of
   ``_step_scan`` after 2 warm-up steps (tokens/s trained) between two
   halves of 20 timed per-batch ``_step``s (the path ``fit`` takes by
   default, each batch copied from host memory), ``fit`` for
   one short epoch of an ``NDArrayIter`` with ``Perplexity`` and
   ``Speedometer``, and ``score`` on an eval iterator (K1);
9. ``torch.profiler`` over one train step.

Phases 3-5 are the serving main path and phase 8 the training one: every
kernel's launch count is set to 0 before each and read after it. The
serving path must launch K1; the training path must launch K2 and K3
exactly once per layer and step, and K1 once per layer and eval batch.
Any failed check exits non-zero. The last lines
are the card's name and power limit (``nvidia-smi``), one JSON line with
every ported kernel's numbers, and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

VOCAB, EMBED, HIDDEN, LAYERS, SEQ = 10000, 650, 650, 2, 35
SEED = 0
SERVED_BATCHES = (1, 8, 32)
RAGGED = (5, 3, 7, 13)          # T, B, I, H: H and B off every tile size
# kernel vs plain, f32 on both: the h @ Wh sums (650 terms) run in another
# order than cuBLAS's, and the difference compounds over 35 steps
LSTM_ATOL = 1e-4
# served probabilities, GPU vs CPU (both f32; TF32 off): 1e-4 relative on
# values near 1/VOCAB
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-7
ENGINE_REQUESTS, ENGINE_CLIENTS, ENGINE_MAX_BATCH = 100, 16, 32
# training: the benchmark's batch and optimizer (examples/rnn/word_lm/
# benchmark.py:37,74-76)
TRAIN_BATCH = 32
TRAIN_BATCHES = (8, TRAIN_BATCH)
TRAIN_OPT = {"learning_rate": 1.0, "clip_gradient": 0.25}
SCAN_STEPS, FIT_BATCHES, EVAL_BATCHES = 20, 6, 2
# 2 full-width train steps on the card vs the same Module on the CPU, f32
# both, TF32 off: only summation order differs, in the forward, the
# gradients and through lr 1 into the next step. Outputs are
# probabilities near 1/VOCAB; parameters are up to ~0.3.
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-7
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32
# FLOP/s outside the tensor cores, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn):
    """Run ``fn`` once under torch.profiler. Returns the profiled wall
    time in ms and {kernel name: [launches, device ms]}; the kernels are
    empty when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            kernels[e.key[:60]] = [e.count, e.self_device_time_total / 1e3]
    return wall, kernels


def lstm_inputs(t, b, i, h, device, seed):
    """One LSTM layer's inputs; weights at PyTorch's LSTM init scale."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def u(scale, *shape):
        return torch.from_numpy(rng.uniform(-scale, scale, shape)
                                .astype(np.float32)).to(device)
    return (u(1.0, t, b, i), u(0.5, b, h), u(0.5, b, h),
            u(k, i, 4 * h), u(k, h, 4 * h), u(k, 4 * h))


def lstm_bound_ms(t, b, i, h):
    """Least time for one layer: every input read once and every output
    written once, or the matrix products' f32 operations, whichever is
    larger. Returns (ms, "bytes" | "operations")."""
    nbytes = 4 * (t * b * i + 2 * b * h + i * 4 * h + h * 4 * h + 4 * h
                  + t * b * h + 2 * b * h)
    flops = 2 * t * b * 4 * h * (i + h)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cudnn_lstm(x, h0, c0, wx, wh, b):
    """torch.nn.LSTM (cuDNN) with the same weights: the yardstick only."""
    inp, hid = wx.shape[0], wh.shape[0]
    lstm = torch.nn.LSTM(inp, hid).to(x.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    return lambda: lstm(x, (h0[None], c0[None]))


def phase_kernel(ops, device):
    """fused_lstm kernel vs plain at the served and a ragged shape."""
    fused_lstm, plain = ops.fused_lstm, ops.fused_lstm_plain
    rows = []
    worst = 0.0
    shapes = [(SEQ, b, EMBED, HIDDEN) for b in SERVED_BATCHES] + [RAGGED]
    for n, (t, b, i, h) in enumerate(shapes):
        args = lstm_inputs(t, b, i, h, device, SEED + n)
        with torch.no_grad():
            got = fused_lstm(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  "fused_lstm output not finite at %s" % ((t, b, i, h),))
            check(err <= LSTM_ATOL, "fused_lstm vs plain max abs err %.3g "
                  "> %.1g at T=%d B=%d I=%d H=%d" % (err, LSTM_ATOL, t, b,
                                                     i, h))
            worst = max(worst, err)
            row = {"T": t, "B": b, "I": i, "H": h, "max_abs_err": err}
            if (t, b, i, h) != RAGGED:
                lib = cudnn_lstm(*args)
                lib_err = float((lib()[0] - got[0]).abs().max())
                bound, by = lstm_bound_ms(t, b, i, h)
                row.update(
                    ms=time_ms(lambda: fused_lstm(*args), 20),
                    plain_ms=time_ms(lambda: plain(*args), 20),
                    library_ms=time_ms(lib, 20), library_max_abs_err=lib_err,
                    bound_ms=bound, bound_by=by)
                # the recurrence kernel's own device time, per step
                _, kern = device_profile(lambda: fused_lstm(*args))
                steps = [v for k, v in kern.items() if "lstm_step" in k]
                row["step_us"] = (steps[0][1] / steps[0][0] * 1e3
                                  if steps else None)
        log("phase 2 fused_lstm %s" % json.dumps(row))
        rows.append(row)
    return rows, worst


def lm_symbol(mx):
    """The served graph, batch-major at both ends (the engine batches
    along axis 0; RNN is time-major)."""
    data = mx.sym.var("data")
    x = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                         name="embed")
    x = mx.sym.SwapAxis(x, dim1=0, dim2=1, name="to_tnc")
    x = mx.sym.RNN(x, state_size=HIDDEN, num_layers=LAYERS, mode="lstm",
                   name="lstm")
    x = mx.sym.SwapAxis(x, dim1=0, dim2=1, name="to_ntc")
    x = mx.sym.FullyConnected(x, num_hidden=VOCAB, flatten=False,
                              name="decoder")
    return mx.sym.softmax(x, axis=-1, name="prob")


def lm_params(sym, seed):
    """Seeded weights (uniform +-0.1, the word_lm init scale); the RNN
    begin states are inputs, not weights."""
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=(1, SEQ))
    return {name: rng.uniform(-0.1, 0.1, shape).astype(np.float32)
            for name, shape in zip(sym.list_arguments(), shapes)
            if name not in ("data", "lstm_state", "lstm_state_cell")}


def tokens(rng, n):
    return rng.randint(0, VOCAB, (n, SEQ)).astype(np.float32)


def check_probs(out, n, what):
    check(out.shape == (n, SEQ, VOCAB), "%s shape %s" % (what, out.shape))
    check(bool(np.isfinite(out).all()), "%s not finite" % what)
    check(np.allclose(out.sum(-1), 1.0, atol=1e-4),
          "%s rows do not sum to 1" % what)


class Reference:
    """CPU predictors of the same model, one per row count."""

    def __init__(self, mx, sym_json, params):
        self._base = mx.Predictor(sym_json, params, ctx=mx.cpu(),
                                  input_shapes={"data": (1, SEQ)})
        self._preds = {1: self._base}

    def __call__(self, toks):
        n = toks.shape[0]
        if n not in self._preds:
            self._preds[n] = self._base.sibling({"data": (n, SEQ)})
        pred = self._preds[n]
        pred.forward(data=toks)
        return pred.get_output(0)


def compare(got, want, what):
    err = float(np.abs(got - want).max())
    check(np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL),
          "%s differs from the CPU reference (max abs err %.3g)"
          % (what, err))
    return err


def phase_predictor(mx, sym_json, params, ref, rng, ctx):
    n = 4
    pred = mx.Predictor(sym_json, params, ctx=ctx,
                        input_shapes={"data": (n, SEQ)})
    toks = tokens(rng, n)
    before = mx.ops.fused_lstm.launches
    pred.forward(data=toks)
    out = pred.get_output(0)
    grew = mx.ops.fused_lstm.launches - before
    if ctx.device_type == "gpu":
        check(grew == LAYERS, "one forward launched fused_lstm %d times, "
              "want %d (one per layer)" % (grew, LAYERS))
    check_probs(out, n, "Predictor output")
    err = compare(out, ref(toks), "Predictor output")
    log("phase 3 predictor %s" % json.dumps({
        "rows": n, "fused_lstm_launches_per_forward": grew,
        "max_abs_err_vs_cpu": err}))


def phase_engine(mx, sym_json, params, ref, rng, ctx):
    cfg = mx.serving.EngineConfig(max_batch_size=ENGINE_MAX_BATCH,
                                  max_batch_delay_ms=2.0,
                                  max_queue=2 * ENGINE_REQUESTS)
    engine = mx.serving.InferenceEngine(sym_json, params,
                                        input_shapes={"data": (SEQ,)},
                                        ctx=ctx, config=cfg)
    reqs = [tokens(rng, int(rng.randint(1, 9)))
            for _ in range(ENGINE_REQUESTS)]

    def one(toks):
        t0 = time.perf_counter()
        out = engine.predict({"data": toks}, timeout=300)[0]
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(ENGINE_CLIENTS) as pool:
        results = list(pool.map(one, reqs))
    wall = time.perf_counter() - t0
    for toks, (out, _) in zip(reqs, results):
        check_probs(out, toks.shape[0], "engine output")
    sample = range(0, ENGINE_REQUESTS, ENGINE_REQUESTS // 8)
    err = max(compare(results[i][0], ref(reqs[i]), "engine request %d" % i)
              for i in sample)
    lat = np.array([lat for _, lat in results]) * 1e3
    rows = sum(r.shape[0] for r in reqs)
    st = engine.stats()
    check(st["requests"].get("ok") == ENGINE_REQUESTS,
          "engine request counts %s" % st["requests"])
    log("phase 4 engine %s" % json.dumps({
        "requests": ENGINE_REQUESTS, "clients": ENGINE_CLIENTS,
        "rows": rows, "wall_s": wall,
        "requests_per_s": ENGINE_REQUESTS / wall,
        "tokens_per_s": rows * SEQ / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "warmup_s": st["warmup_seconds"],
        "pad_waste": st["padding"]["waste_ratio"],
        "batches": {b: v["batches"]
                    for b, v in st["padding"]["buckets"].items()},
        "sampled": len(sample), "max_abs_err_vs_cpu": err}))
    return engine


def phase_http(mx, engine, ref, rng):
    server = mx.serving.serve(engine, port=0, allow_shutdown=True)
    base = "http://127.0.0.1:%d" % server.port
    # a local server: never route through a proxy from the environment
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def call(path, doc=None):
        body = None if doc is None else json.dumps(doc).encode()
        req = urllib.request.Request(base + path, data=body, method=(
            "GET" if doc is None else "POST"),
            headers={"Content-Type": "application/json"})
        with opener.open(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())

    errs = []
    for _ in range(2):
        toks = tokens(rng, 1)
        code, doc = call("/predict", {"inputs": {"data": toks.tolist()}})
        check(code == 200, "/predict answered %d" % code)
        out = np.asarray(doc["outputs"][0], dtype=np.float32)
        check_probs(out, 1, "/predict output")
        errs.append(compare(out, ref(toks), "/predict output"))
    code, health = call("/healthz")
    check(code == 200 and health["status"] == "ok",
          "/healthz answered %d %s" % (code, health.get("status")))
    code, _ = call("/shutdown", {})
    check(code == 200, "/shutdown answered %d" % code)
    check(server.join(timeout=120) and engine.stats()["closed"],
          "server did not stop after /shutdown")
    log("phase 5 http %s" % json.dumps({
        "predict_requests": 2, "max_abs_err_vs_cpu": max(errs),
        "healthz": health["status"]}))


def phase_profile(mx, sym_json, params, rng):
    """Where a served forward's device time goes, at the top bucket."""
    n = ENGINE_MAX_BATCH
    pred = mx.Predictor(sym_json, params, ctx=mx.gpu(0),
                        input_shapes={"data": (n, SEQ)})
    toks = tokens(rng, n)
    pred.forward(data=toks)      # warm: allocations, first launches
    wall, kern = device_profile(lambda: pred.forward(data=toks))
    busy = sum(ms for _, ms in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:6]
    log("phase 6 profile %s" % json.dumps({
        "rows": n, "forward_wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": (1 - busy / wall) if kern else None,
        "top_kernels": [{"kernel": k, "launches": c, "ms": ms,
                         "share": ms / busy} for k, (c, ms) in top]}))


# ---------------------------------------------------------------------------
# the training slice: K2/K3 and Module training of the same LM
# ---------------------------------------------------------------------------
def bound_ms(nbytes, flops):
    """The larger of bytes over HBM bandwidth and f32 operations over the
    CUDA cores' peak: (ms, "bytes" | "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def train_bounds(t, b, i, h):
    """Bounds of the two timed wrappers, f32, each input read and each
    output written once.

    K2, ``fused_lstm_train``: reads x, h0, c0, wx, wh, b; writes hseq,
    cseq and gates; 2·T·B·4H·(I+H) operations (the input projection it
    runs and the recurrence). K3, ``lstm_bwd_recurrence``: reads dhseq,
    dh_n, dc_n, gates, cseq, c0, wh; writes dgates, dh0, dc0;
    2·T·B·4H·H operations (T carry products, the last one dh0)."""
    bh, g = b * h, 4 * h
    k2 = bound_ms(4 * (t * b * i + 2 * bh + i * g + h * g + g
                       + 2 * t * bh + t * b * g),
                  2 * t * b * g * (i + h))
    k3 = bound_ms(4 * (t * bh + 2 * bh + t * b * g + t * bh + bh + h * g
                       + t * b * g + 2 * bh),
                  2 * t * b * g * h)
    return k2, k3


def cudnn_train(x, h0, c0, wx, wh, b, cots):
    """torch.nn.LSTM (cuDNN) with the same weights, for the yardstick
    only: (training forward, backward of one retained forward, forward +
    backward) as callables."""
    inp, hid = wx.shape[0], wh.shape[0]
    lstm = torch.nn.LSTM(inp, hid).to(x.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    leaves = [a.detach().requires_grad_(True) for a in (x, h0, c0)]
    wrt = leaves + list(lstm.parameters())

    def fwd():
        y, (hn, cn) = lstm(leaves[0], (leaves[1][None], leaves[2][None]))
        return [y, hn[0], cn[0]]
    kept = fwd()
    return (fwd,
            lambda: torch.autograd.grad(kept, wrt, cots, retain_graph=True),
            lambda: torch.autograd.grad(fwd(), wrt, cots))


def step_us(fn, kernel):
    """Mean device µs of one launch of ``kernel`` while ``fn`` runs."""
    _, kern = device_profile(fn)
    steps = [v for k, v in kern.items() if kernel in k]
    return steps[0][1] / steps[0][0] * 1e3 if steps else None


def max_err(got, want, what, rtol=LSTM_ATOL, atol=LSTM_ATOL):
    """Max abs difference of two tensor lists; fails unless every pair is
    within ``atol + rtol * |want|`` and finite."""
    worst = 0.0
    for n, (g, w) in enumerate(zip(got, want)):
        check(bool(torch.isfinite(g).all()), "%s output %d not finite"
              % (what, n))
        check(bool(torch.allclose(g, w, rtol=rtol, atol=atol)),
              "%s output %d differs from the plain version (max abs err "
              "%.3g)" % (what, n, float((g - w).abs().max())))
        worst = max(worst, float((g - w).abs().max()))
    return worst


def phase_train_kernels(ops, device):
    """K2 (fused_lstm_train) and K3 (lstm_bwd_recurrence) against their
    plain versions, and the six gradients of a FusedLSTM layer against
    the plain backward, at T=35, B in {8, 32}, I=H=650 and a ragged
    shape; kernel, plain and cuDNN times with each kernel's bound."""
    rows = []
    worst = 0.0
    shapes = [(SEQ, b, EMBED, HIDDEN) for b in TRAIN_BATCHES] + [RAGGED]
    for n, (t, b, i, h) in enumerate(shapes):
        args = lstm_inputs(t, b, i, h, device, SEED + 10 + n)
        rng = np.random.RandomState(SEED + 20 + n)
        cots = [torch.from_numpy(rng.randn(*s).astype(np.float32))
                .to(device) for s in ((t, b, h), (b, h), (b, h))]
        x, h0, c0, wx, wh, bias = args
        with torch.no_grad():
            res = ops.fused_lstm_train_plain(*args)
            err2 = max_err(ops.fused_lstm_train(*args), res,
                           "fused_lstm_train %s" % ((t, b, i, h),))
            bwd_args = (*cots, res[2], res[1], c0, wh)
            err3 = max_err(ops.lstm_bwd_recurrence(*bwd_args),
                           ops.lstm_bwd_recurrence_plain(*bwd_args),
                           "lstm_bwd_recurrence %s" % ((t, b, i, h),))
            want = ops.fused_lstm_backward_plain(*cots, x, h0, c0, wx, wh,
                                                 *res)
        leaves = [a.detach().requires_grad_(True) for a in args]
        got = torch.autograd.grad(ops.FusedLSTM.apply(*leaves), leaves,
                                  cots)
        err_g = max_err(got, want, "FusedLSTM gradients %s"
                        % ((t, b, i, h),))
        worst = max(worst, err2, err3, err_g)
        row = {"T": t, "B": b, "I": i, "H": h, "k2_max_abs_err": err2,
               "k3_max_abs_err": err3, "grad_max_abs_err": err_g}
        if (t, b, i, h) != RAGGED:
            (k2b, k2by), (k3b, k3by) = train_bounds(t, b, i, h)
            lib_fwd, lib_bwd, lib_both = cudnn_train(*args, cots)

            def layer():
                return torch.autograd.grad(ops.FusedLSTM.apply(*leaves),
                                           leaves, cots)
            with torch.no_grad():
                row.update(
                    k2_ms=time_ms(lambda: ops.fused_lstm_train(*args), 20),
                    k2_plain_ms=time_ms(
                        lambda: ops.fused_lstm_train_plain(*args), 20),
                    k2_bound_ms=k2b, k2_bound_by=k2by,
                    k3_ms=time_ms(lambda: ops.lstm_bwd_recurrence(
                        *bwd_args), 20),
                    k3_plain_ms=time_ms(lambda: ops.lstm_bwd_recurrence_plain(
                        *bwd_args), 20),
                    k3_bound_ms=k3b, k3_bound_by=k3by,
                    backward_ms=time_ms(lambda: ops.fused_lstm_backward(
                        *cots, x, h0, c0, wx, wh, *res), 20),
                    k2_step_us=step_us(lambda: ops.fused_lstm_train(*args),
                                       "lstm_train_step"),
                    k3_step_us=step_us(lambda: ops.lstm_bwd_recurrence(
                        *bwd_args), "lstm_bwd_step"))
            row.update(layer_fwd_bwd_ms=time_ms(layer, 20),
                       cudnn_fwd_ms=time_ms(lib_fwd, 20),
                       cudnn_bwd_ms=time_ms(lib_bwd, 20),
                       cudnn_fwd_bwd_ms=time_ms(lib_both, 20))
        log("phase 7 train kernels %s" % json.dumps(row))
        rows.append(row)
    return rows, worst


def bench_symbol(mx, reshape_label=False):
    """The training benchmark's graph (`examples/rnn/word_lm/
    benchmark.py:52-58`), time-major data (T, B), labels (T*B,). With
    ``reshape_label`` the label is a (T, B) input reshaped in the graph,
    the reference word_lm `train.py:74-84` form, so an NDArrayIter that
    cuts (T, B) batches feeds it."""
    data = mx.sym.var("data")
    x = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                         name="embed")
    x = mx.sym.RNN(x, state_size=HIDDEN, num_layers=LAYERS, mode="lstm",
                   name="lstm")
    x = mx.sym.FullyConnected(mx.sym.Reshape(x, shape=(-1, HIDDEN)),
                              num_hidden=VOCAB, name="decoder")
    if reshape_label:
        label = mx.sym.Reshape(mx.sym.var("softmax_label"), shape=(-1,))
        return mx.sym.SoftmaxOutput(x, label, name="softmax")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def train_module(mx, ctx):
    """bind, seeded Xavier init and SGD (lr 1, clip 0.25), as the
    benchmark does; rescale_grad is 1/T (data is (T, B))."""
    mod = mx.mod.Module(bench_symbol(mx), context=ctx)
    mod.bind(data_shapes=[("data", (SEQ, TRAIN_BATCH))],
             label_shapes=[("softmax_label", (SEQ * TRAIN_BATCH,))])
    mx.random.seed(SEED)
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
    return mod


def lm_batches(mx, rng, n):
    """n batches of random token ids, on the CPU (Module copies them)."""
    return [mx.io.DataBatch(
        data=[mx.nd.array(rng.randint(0, VOCAB, (SEQ, TRAIN_BATCH)))],
        label=[mx.nd.array(rng.randint(0, VOCAB, SEQ * TRAIN_BATCH))])
        for _ in range(n)]


def lm_iter(mx, rng, batches):
    """NDArrayIter over ``batches`` (T, B) slices of random token ids."""
    shape = (batches * SEQ, TRAIN_BATCH)
    return mx.io.NDArrayIter(rng.randint(0, VOCAB, shape).astype(np.float32),
                             rng.randint(0, VOCAB, shape).astype(np.float32),
                             batch_size=SEQ)


def sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()


def phase_train(mx, ctx, rng):
    """The training main path on ``ctx``: 2 steps held against the same
    Module on the CPU, 20 timed steps of ``_step_scan`` after 2 warm-up
    steps, then ``fit`` for one short epoch and ``score``. Returns
    (module, summary)."""
    mod = train_module(mx, ctx)
    ref = train_module(mx, mx.cpu())
    for name, arr in mod.get_params()[0].items():
        check(np.array_equal(arr.asnumpy(),
                             ref.get_params()[0][name].asnumpy()),
              "seeded init of %s differs between %s and cpu" % (name, ctx))
    batches = lm_batches(mx, rng, 4 + 2 * SCAN_STEPS)
    out_err = 0.0
    for step, batch in enumerate(batches[:2]):
        mod._step(batch)
        ref._step(batch)
        got = mod.get_outputs()[0].asnumpy()
        want = ref.get_outputs()[0].asnumpy()
        check(got.shape == (SEQ * TRAIN_BATCH, VOCAB)
              and bool(np.isfinite(got).all()),
              "train step %d output %s not finite" % (step, got.shape))
        check(np.allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL),
              "train step %d output differs from the CPU module (max abs "
              "err %.3g)" % (step, float(np.abs(got - want).max())))
        out_err = max(out_err, float(np.abs(got - want).max()))
    param_err = {}
    for name, arr in mod.get_params()[0].items():
        got, want = arr.asnumpy(), ref.get_params()[0][name].asnumpy()
        check(np.allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL),
              "%s after 2 steps differs from the CPU module (max abs err "
              "%.3g)" % (name, float(np.abs(got - want).max())))
        param_err[name] = float(np.abs(got - want).max())
    del ref

    for batch in batches[2:4]:           # warm-up
        mod._step(batch)

    def step_loop(group):
        """Per-batch ``_step``s (the fit loop's path): seconds."""
        sync(ctx)
        t = time.perf_counter()
        for b in group:
            mod._step(b)
        sync(ctx)
        return time.perf_counter() - t
    half = SCAN_STEPS // 2
    loop_s = step_loop(batches[4:4 + half])
    sync(ctx)
    t0 = time.perf_counter()
    stacked = mod._step_scan(batches[4 + half:4 + half + SCAN_STEPS])
    sync(ctx)
    wall = time.perf_counter() - t0
    loop_s += step_loop(batches[4 + half + SCAN_STEPS:])
    outs = stacked[0].data
    check(tuple(outs.shape) == (SCAN_STEPS, SEQ * TRAIN_BATCH, VOCAB)
          and bool(torch.isfinite(outs).all()),
          "_step_scan outputs %s not finite" % (tuple(outs.shape),))
    del stacked, outs

    fit_mod = mx.mod.Module(bench_symbol(mx, reshape_label=True),
                            context=ctx)
    speedo = mx.callback.Speedometer(SEQ * TRAIN_BATCH, frequent=2,
                                     auto_reset=False)
    train_ppl = mx.metric.Perplexity()
    t1 = time.perf_counter()
    fit_mod.fit(lm_iter(mx, rng, FIT_BATCHES), eval_metric=train_ppl,
                batch_end_callback=speedo, optimizer="sgd",
                optimizer_params=TRAIN_OPT, arg_params=mod.get_params()[0],
                num_epoch=1)
    sync(ctx)
    fit_wall = time.perf_counter() - t1
    k1_before = mx.ops.fused_lstm.launches
    (_, eval_ppl), = fit_mod.score(lm_iter(mx, rng, EVAL_BATCHES),
                                   mx.metric.Perplexity())
    k1_by_score = mx.ops.fused_lstm.launches - k1_before
    check(np.isfinite(train_ppl.get()[1]) and np.isfinite(eval_ppl),
          "perplexity not finite: train %s, eval %s"
          % (train_ppl.get()[1], eval_ppl))
    check(speedo.history, "Speedometer logged nothing")
    summary = {
        "steps_vs_cpu": 2, "output_max_abs_err_vs_cpu": out_err,
        "param_max_abs_err_vs_cpu": param_err,
        "scan_steps": SCAN_STEPS, "scan_wall_s": wall,
        "tokens_per_s": SCAN_STEPS * SEQ * TRAIN_BATCH / wall,
        "steps_per_s": SCAN_STEPS / wall,
        "step_loop_steps": 2 * half,
        "step_loop_tokens_per_s": 2 * half * SEQ * TRAIN_BATCH / loop_s,
        "fit_batches": FIT_BATCHES, "fit_wall_s": fit_wall,
        "fit_train_perplexity": train_ppl.get()[1],
        "speedometer_samples_per_s": [s for _, _, s in speedo.history],
        "eval_batches": EVAL_BATCHES, "eval_perplexity": eval_ppl,
        "k1_launches_by_score": k1_by_score}
    return mod, summary


def phase_train_profile(mod, rng, mx):
    """Where one train step's device time goes."""
    batch = lm_batches(mx, rng, 1)[0]
    wall, kern = device_profile(lambda: mod._step(batch))
    busy = sum(ms for _, ms in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:10]
    log("phase 9 train profile %s" % json.dumps({
        "step_wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": (1 - busy / wall) if kern else None,
        "top_kernels": [{"kernel": k, "launches": c, "ms": ms,
                         "share": ms / busy} for k, (c, ms) in top]}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs the port on the GPU",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build

    # full f32 everywhere, on the kernel's side and the references'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = nvidia_smi()
    log("card: %s (torch %s, CUDA %s)" % (card, torch.__version__,
                                          torch.version.cuda))

    secs = _build.build_all()
    log("phase 1 build %s" % json.dumps({"sources": list(_build.SOURCES),
                                         "seconds": secs}))
    for name in _build.SOURCES:
        for line in (_build.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas %s: %s" % (name, line.strip()))

    rows, worst = phase_kernel(mx.ops, device)

    sym_json = lm_symbol(mx).tojson()
    host = lm_params(lm_symbol(mx), SEED)
    ref = Reference(mx, sym_json, mx.params_from_numpy(host, mx.cpu()))
    gpu_params = mx.params_from_numpy(host, mx.gpu(0))
    rng = np.random.RandomState(SEED + 1)

    mx.ops.fused_lstm.launches = 0            # the main path starts here
    phase_predictor(mx, sym_json, gpu_params, ref, rng, mx.gpu(0))
    engine = phase_engine(mx, sym_json, gpu_params, ref, rng, mx.gpu(0))
    phase_http(mx, engine, ref, rng)
    launches = mx.ops.fused_lstm.launches     # ... and ends here
    check(launches > 0, "the main path never launched fused_lstm")
    phase_profile(mx, sym_json, gpu_params, rng)

    train_rows, train_worst = phase_train_kernels(mx.ops, device)
    counters = (mx.ops.fused_lstm, mx.ops.fused_lstm_train,
                mx.ops.lstm_bwd_recurrence)
    for c in counters:                        # the training path starts
        c.launches = 0
    mod, summary = phase_train(mx, mx.gpu(0), rng)
    k1, k2, k3 = (c.launches for c in counters)   # ... and ends here
    steps = 4 + 2 * SCAN_STEPS + FIT_BATCHES
    summary.update(train_steps=steps, launches={
        "fused_lstm": k1, "fused_lstm_train": k2, "lstm_bwd_recurrence": k3})
    log("phase 8 train %s" % json.dumps(summary))
    check(k2 == LAYERS * steps and k3 == LAYERS * steps,
          "training launched fused_lstm_train %d and lstm_bwd_recurrence %d "
          "times, want %d each (%d layers x %d steps)"
          % (k2, k3, LAYERS * steps, LAYERS, steps))
    check(summary["k1_launches_by_score"] == LAYERS * EVAL_BATCHES,
          "score launched fused_lstm %d times, want %d"
          % (summary["k1_launches_by_score"], LAYERS * EVAL_BATCHES))
    phase_train_profile(mod, rng, mx)

    top = next(r for r in rows if r["B"] == max(SERVED_BATCHES))
    train = next(r for r in train_rows if r["B"] == TRAIN_BATCH)
    pallas = "mxnet_tpu/ops/pallas_kernels.py"
    train_src = "mxnet_tpu_torch/csrc/fused_lstm_train.cu"
    kernels = [{
        "name": "fused_lstm", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/fused_lstm.cu",
        "replaces": pallas + ":295",
        "launches": launches, "max_abs_err": worst,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"]}, {
        "name": "fused_lstm_train", "route": "cuda", "source": train_src,
        "replaces": pallas + ":348", "launches": k2,
        "max_abs_err": train_worst, "ms": train["k2_ms"],
        "plain_ms": train["k2_plain_ms"], "bound_ms": train["k2_bound_ms"],
        "bound_by": train["k2_bound_by"],
        "library_ms": train["cudnn_fwd_ms"]}, {
        "name": "lstm_bwd_recurrence", "route": "cuda", "source": train_src,
        "replaces": pallas + ":382", "launches": k3,
        "max_abs_err": train_worst, "ms": train["k3_ms"],
        "plain_ms": train["k3_plain_ms"], "bound_ms": train["k3_bound_ms"],
        "bound_by": train["k3_bound_by"],
        "library_ms": train["cudnn_bwd_ms"]}]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
