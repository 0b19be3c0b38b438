"""The port's headline benchmarks: ResNet-50 v1 inference at batch 32 and
training at bf16 batch 128, on one CUDA card.

    python3 mxnet_tpu_torch/tools/bench.py [--infer-only]

The counterpart of the repository's ``bench.py`` (which stays the JAX
bench), printing JSON lines with its keys (``metric``, ``value``,
``unit``, ``vs_baseline`` against its constants) and a few that say how
the number was taken, after the card's name and power limit
(``nvidia-smi``):

- ``resnet50_infer_imgs_per_sec_bs32``: the flow of ``bench.py``'s
  inference half on the port: ``vision.resnet50_v1`` (layout from
  ``MXNET_BENCH_LAYOUT``, NCHW by default), ``initialize`` on ``gpu(0)``,
  ``hybridize()``, an input from ``nd.random.uniform``, one warm call,
  then ``net._cached_jit`` over the parameters in ``net._param_order``:
  two rounds of 8 x 100 calls, each round bracketed by a synchronize,
  the best reported. Each call's batch is the input rolled by the call's
  index along the batch axis, as ``bench.py`` rolls it: every call is
  one replay of the captured graph over a new input. Convolutions use
  PyTorch's default TF32 setting for cuDNN, which the line records.
- ``resnet50_train_imgs_per_sec_bf16_bs128``: the configuration of
  ``tools/bench_all.py::bench_resnet50_train`` (NHWC, bf16, batch 128,
  SGD lr 0.05 momentum 0.9, Xavier, 30 staged batches a
  ``Module._step_scan``, 15 calls a round, best of two rounds after one
  warm call) through the port's Gluon -> ``_trace_symbol`` -> ``Module``.

The functions take the batch, the iteration counts and the context, so
they also run small on ``cpu()``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BASELINE_IMG_S = 109.0       # bench.py: K80 ResNet-50 batch-32 inference
TRAIN_TARGET_IMG_S = 2900.0  # bench.py: the A100-class train target
CLASSES = 1000


def emit(rec):
    print(json.dumps(rec), flush=True)
    return rec


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_infer(batch=32, iters=100, calls=8, ctx=None, layout="NCHW",
                model="resnet50_v1", hybridize=True, rounds=2):
    """Inference img/s of a zoo model over ``rounds`` rounds of ``calls``
    x ``iters`` forwards (the best round), hybridized or eager; prints
    and returns the metric line."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    if layout not in ("NCHW", "NHWC"):
        raise ValueError("layout must be NCHW or NHWC, got %r" % layout)
    ctx = ctx if ctx is not None else mx.gpu(0)
    net = vision.get_model(model, **({"layout": layout}
                                     if layout != "NCHW" else {}))
    net.initialize(ctx=ctx)
    if hybridize:
        net.hybridize()
    shape = (batch, 3, 224, 224) if layout == "NCHW" \
        else (batch, 224, 224, 3)
    x = mx.nd.random.uniform(shape=shape, ctx=ctx)
    net(x).asnumpy()            # finishes deferred init, captures

    if hybridize:
        cached = net._cached_jit
        params = tuple(net.collect_params()[n].data().data
                       for n in net._param_order)

        def forward(xi):
            return cached(params, 0, False, xi)[0][0]
    else:
        def forward(xi):
            return net(mx.nd.NDArray(xi, ctx)).data

    xv = x.data

    def run(acc):
        for i in range(iters):
            acc = acc + forward(torch.roll(xv, i, 0)).sum()
        return acc

    zero = torch.zeros((), device=xv.device)
    float(run(zero))
    best = 0.0
    for _ in range(rounds):
        _sync(xv.device)
        t0 = time.perf_counter()
        acc = zero
        for _ in range(calls):
            acc = run(acc)
        float(acc)
        best = max(best, batch * iters * calls / (time.perf_counter() - t0))
    return emit({
        "metric": "%s_infer_imgs_per_sec_bs%d" % (model.split("_")[0], batch),
        "value": best, "unit": "img/s", "vs_baseline": best / BASELINE_IMG_S,
        "layout": layout, "hybridized": hybridize,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "device": str(xv.device)})


def bench_train(batch=128, iters=30, calls=15, ctx=None, rounds=2):
    """Training img/s of ResNet-50 v1 (NHWC, bf16) through
    ``Module._step_scan`` over ``iters`` staged batches, ``calls`` scans
    a round, the best of ``rounds``; prints and returns the metric
    line."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    ctx = ctx if ctx is not None else mx.gpu(0)
    image = (224, 224, 3)
    net = vision.get_model("resnet50_v1", classes=CLASSES, layout="NHWC")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(mx.nd.zeros((batch,) + image, ctx=ctx))
    sym = mx.sym.SoftmaxOutput(net._trace_symbol(), name="softmax")
    mod = mx.mod.Module(sym, context=ctx)
    type_dict = {p: "bfloat16" for p in mod._param_names}
    type_dict["data"] = "bfloat16"
    mod.bind(data_shapes=[("data", (batch,) + image)],
             label_shapes=[("softmax_label", (batch,))], type_dict=type_dict)
    mod.init_params(initializer=mx.init.Xavier(),
                    arg_params={k: v.data()
                                for k, v in net.collect_params().items()},
                    allow_missing=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9})
    rng = np.random.RandomState(0)
    batches = [mx.io.DataBatch(
        data=[mx.nd.random.uniform(shape=(batch,) + image, ctx=ctx,
                                   dtype="bfloat16")],
        label=[mx.nd.array(rng.randint(0, CLASSES, batch), ctx=ctx)])
        for _ in range(iters)]
    device = batches[0].data[0].data.device
    mod._step_scan(batches)
    _sync(device)
    best = 0.0
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = mod._step_scan(batches)
        _sync(device)
        best = max(best, batch * iters * calls / (time.perf_counter() - t0))
    if not bool(torch.isfinite(out[0].data).all()):
        raise RuntimeError("the trained ResNet-50's outputs are not finite")
    return emit({
        "metric": "resnet50_train_imgs_per_sec_bf16_bs%d" % batch,
        "value": best, "unit": "img/s",
        "vs_baseline": best / TRAIN_TARGET_IMG_S,
        "layout": "NHWC", "device": str(device)})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--infer-only", action="store_true",
                   help="skip the training benchmark")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the benchmarks run on the card",
              file=sys.stderr)
        return 2
    layout = os.environ.get("MXNET_BENCH_LAYOUT", "NCHW")
    if layout not in ("NCHW", "NHWC"):
        print("MXNET_BENCH_LAYOUT must be NCHW or NHWC, got %r" % layout,
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    bench_infer(layout=layout)
    if not args.infer_only:
        bench_train()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))
    sys.exit(main())
