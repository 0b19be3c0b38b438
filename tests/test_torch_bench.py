"""The port's bench script (`mxnet_tpu_torch/tools/bench.py`) and the
inference lines of the repository's ``bench.py`` on the port, small, on
the CPU: the functions print JSON lines with ``bench.py``'s keys, and
``bench.py``'s flow (``resnet50_v1``, ``initialize``, ``hybridize``,
``nd.random.uniform``, a warm call, ``_cached_jit`` over ``_param_order``)
runs on ``mxnet_tpu_torch`` with ``ctx = cpu()`` in place of the TPU.
No number here is a device measurement."""
import json

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.tools import bench

KEYS = {"metric", "value", "unit", "vs_baseline"}


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("hybridize", [True, False])
def test_bench_infer_prints_its_line(capsys, hybridize):
    rec = bench.bench_infer(batch=2, iters=1, calls=1, ctx=mx.cpu(),
                            model="resnet18_v1", hybridize=hybridize,
                            layout="NHWC" if hybridize else "NCHW")
    (line,) = _lines(capsys)
    assert line == rec
    assert KEYS <= set(line)
    assert line["metric"] == "resnet18_infer_imgs_per_sec_bs2"
    assert line["unit"] == "img/s" and line["value"] > 0
    assert line["vs_baseline"] == line["value"] / bench.BASELINE_IMG_S
    assert line["hybridized"] is hybridize and line["device"] == "cpu"


def test_bench_train_prints_its_line(capsys):
    rec = bench.bench_train(batch=2, iters=2, calls=1, ctx=mx.cpu(),
                            rounds=1)
    (line,) = _lines(capsys)
    assert line == rec and KEYS <= set(line)
    assert line["metric"] == "resnet50_train_imgs_per_sec_bf16_bs2"
    assert line["vs_baseline"] == line["value"] / bench.TRAIN_TARGET_IMG_S


def test_bench_py_inference_flow():
    """``bench.py``'s inference set-up, line for line, at batch 2."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    batch = 2
    ctx = mx.cpu()
    layout = "NCHW"
    kwargs = {"layout": layout} if layout != "NCHW" else {}
    net = vision.resnet50_v1(**kwargs)
    net.initialize(ctx=ctx)
    net.hybridize()
    shape = (batch, 3, 224, 224) if layout == "NCHW" \
        else (batch, 224, 224, 3)
    x = mx.nd.random.uniform(shape=shape, ctx=ctx)
    out = net(x).asnumpy()
    cached = net._cached_jit
    params = tuple(net.collect_params()[n].data()._data
                   for n in net._param_order)
    assert out.shape == (batch, 1000) and np.isfinite(out).all()
    outs, aux_up = cached(params, 0, False, x._data)
    assert aux_up == {}
    np.testing.assert_array_equal(outs[0].numpy(), out)
    assert net._param_order == sorted(net.collect_params().keys())
    assert len(params) == len(net.collect_params())
    assert sum(n.endswith("running_mean") for n in net._param_order) == 53
