"""Gluon training on the port (the autograd tape, a hybridized call
under ``record()``, ``Trainer``, the loss) against the JAX package, on
the CPU.

A thin ResNet v1 (``ResNetV1(BottleneckV1, [1, 1, 1, 1],
[16, 128, 256, 384, 512], classes=10)``: every stage changes channels, so
stages 2-4 open with a stride-2 1x1 body conv and downsample over 128,
256 and 384 channels, the six sites that ``MXNET_CONV1X1_PALLAS`` routes
to K5) is built in both packages from the same seeded weights and
trained 3 steps on one batch of 8 images of 32x32 by the loop of
`examples/gluon/train_resnet50.py`: ``with autograd.record(): loss =
loss_fn(net(x), y)``, ``loss.backward()``, ``trainer.step(8)`` with
``SoftmaxCrossEntropyLoss`` and SGD (momentum 0.9, wd 1e-4), eager and
hybridized, NCHW and NHWC, and NHWC hybridized with the gate on (K5's
plain version here; the JAX package runs the Pallas kernel in interpret
mode). One forward outside ``record()`` finishes deferred init in both
packages first. After each step the per-sample losses are held to rtol
1e-4, atol 1e-6, and every parameter (the moving statistics included) by
relative norm per parameter to 1e-4 (f32 both sides: only summation
order differs).

The steps use lr 0.002, not the example's 0.1, and images whose samples
differ in scale and offset. The forwards differ by about 2e-5 in the
loss (f32 convolutions summed in another order); a larger step drives
the losses of the repeated batch toward 0 within 3 steps, where that
absolute difference exceeds the relative tolerance (at lr 0.005 the
third step's smallest losses, near 0.3, read 1.3e-4). A ReLU net's
gradient jumps where another summation order carries an activation
across zero, and both packages' single-pass BatchNorm variance
(``E[x^2] - mean^2``) cancels where a channel's values nearly agree
across the batch, as those of the 1x1 stage-4 maps of images drawn from
one distribution do: such inputs move the two packages apart by rounding
alone (parameters 1e-2 apart after 3 steps with uniform [0, 1) images at
batch 4; 2e-4 to 6e-4 at lr 0.05). At these settings the readings are
below 3.5e-5 (losses) and 2.2e-6 (parameters).

The port alone: hybridized training equals eager bit for bit; the gate
sends each of the six sites' input gradient through ``conv1x1_s2_dgrad``
in every backward, and none with it off; ``hybridize(remat=True)`` (and
``MXNET_BACKWARD_DO_MIRROR=1``) gives the gradients of the plain program,
recomputes in the backward pass and steps BatchNorm once; a recorded call
with deferred init steps it once too; ``grad_req="add"`` accumulates over
two backwards and ``zero_grad`` clears it; the recorded signature is one
compile, then hits, apart from the inference one, which an optimizer step
does not retrace; the Trainer's kvstore, ``update``, learning rate and
state files.
"""
import functools
import os

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd, compiled, gluon
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops import nn as nn_ops
from mxnet_tpu_torch.ops.registry import get_op

SPEC = ([1, 1, 1, 1], [16, 128, 256, 384, 512])
BATCH, CLASSES, STEPS = 8, 10, 3
SHAPES = {"NCHW": (BATCH, 3, 32, 32), "NHWC": (BATCH, 32, 32, 3)}
OPT = {"learning_rate": 0.002, "momentum": 0.9, "wd": 1e-4}
LOSS_RTOL, LOSS_ATOL, PARAM_REL = 1e-4, 1e-6, 1e-4
CPU = mxt.cpu()
K5_SITES = 6


def _weights(params):
    """Seeded weights at sane scales, by name (He-normal convs, gamma
    near 1, moving variance near 1)."""
    rng = np.random.RandomState(0)
    out = {}
    for name in sorted(params.keys()):
        s = params[name].shape
        if name.endswith("weight"):
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif name.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, s)
        elif name.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, s)
        else:
            v = rng.randn(*s) * 0.1
        out[name] = v.astype(np.float32)
    return out


def _batch(layout):
    """Images whose samples differ in scale and offset, and labels."""
    rng = np.random.RandomState(1)
    shape = SHAPES[layout]
    x = rng.randn(*shape) * rng.uniform(0.5, 2.0, (BATCH, 1, 1, 1)) \
        + rng.randn(BATCH, 1, 1, 1)
    return x.astype(np.float32), \
        rng.randint(0, CLASSES, BATCH).astype(np.float32)


class _Gate:
    """``MXNET_CONV1X1_PALLAS`` set for a block of code."""

    def __init__(self, on):
        self._on = on
        self._saved = None

    def __enter__(self):
        self._saved = os.environ.get("MXNET_CONV1X1_PALLAS")
        os.environ["MXNET_CONV1X1_PALLAS"] = "1" if self._on else "0"

    def __exit__(self, *exc):
        if self._saved is None:
            os.environ.pop("MXNET_CONV1X1_PALLAS", None)
        else:
            os.environ["MXNET_CONV1X1_PALLAS"] = self._saved


def _port_net(layout, hybrid, **flags):
    net = tvision.ResNetV1(tvision.BottleneckV1, *SPEC, classes=CLASSES,
                           layout=layout, prefix="net_")
    net.initialize(mxt.init.Xavier(magnitude=2), ctx=CPU)
    net(mxt.nd.zeros(SHAPES[layout], ctx=CPU))
    weights = _weights(net.collect_params())
    mxt.set_block_params(net, weights)
    if hybrid:
        net.hybridize(**flags)
    return net, weights


def _params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _port_steps(net, layout, steps=STEPS):
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _batch(layout)
    x, y = mxt.nd.array(x, ctx=CPU), mxt.nd.array(y, ctx=CPU)
    out = []
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(BATCH)
        out.append({"loss": loss.asnumpy(), "params": _params(net)})
    return out


@functools.lru_cache(maxsize=None)
def port_run(layout, hybrid, gate=False):
    with _Gate(gate):
        net, _ = _port_net(layout, hybrid)
        return _port_steps(net, layout)


@functools.lru_cache(maxsize=None)
def jax_run(layout, hybrid, gate=False):
    saved = os.environ.get("MXNET_XLA_STATS")
    os.environ["MXNET_XLA_STATS"] = "0"
    try:
        with _Gate(gate):
            net = jresnet.ResNetV1(jresnet.BottleneckV1, *SPEC,
                                   classes=CLASSES, layout=layout,
                                   prefix="net_")
            net.initialize(mx.init.Xavier(magnitude=2), ctx=mx.cpu())
            net(mx.nd.zeros(SHAPES[layout]))
            weights = _weights(net.collect_params())
            for name, param in net.collect_params().items():
                param.set_data(mx.nd.array(weights[name]))
            if hybrid:
                net.hybridize()
            trainer = jgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
            loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
            x, y = _batch(layout)
            x, y = mx.nd.array(x), mx.nd.array(y)
            out = []
            for _ in range(STEPS):
                with jautograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                trainer.step(BATCH)
                out.append({"loss": loss.asnumpy(), "params": {
                    n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}})
            return out
    finally:
        if saved is None:
            os.environ.pop("MXNET_XLA_STATS", None)
        else:
            os.environ["MXNET_XLA_STATS"] = saved


def _rel(got, want):
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else \
        float(np.linalg.norm(got))


CASES = [("NCHW", False, False), ("NCHW", True, False),
         ("NHWC", False, False), ("NHWC", True, False),
         ("NHWC", True, True)]


@pytest.mark.parametrize(
    "layout,hybrid,gate", CASES,
    ids=["%s-%s%s" % (lay, "hybrid" if h else "eager", "-k5" if g else "")
         for lay, h, g in CASES])
def test_training_matches_jax(layout, hybrid, gate):
    got, want = port_run(layout, hybrid, gate), jax_run(layout, hybrid, gate)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g["loss"].shape == (BATCH,)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg="step %d" % step)
        errs = {n: _rel(g["params"][n], v) for n, v in w["params"].items()}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= PARAM_REL, (step, worst, errs[worst])
    # the loss on the repeated batch falls, and the statistics moved
    assert got[-1]["loss"].mean() < got[0]["loss"].mean()
    first = _port_net(layout, False)[1]
    assert all(not np.array_equal(got[0]["params"][n], first[n])
               for n in first if "running" in n)


@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_hybridized_training_equals_eager(layout):
    for h, e in zip(port_run(layout, True), port_run(layout, False)):
        np.testing.assert_array_equal(h["loss"], e["loss"])
        for n, v in e["params"].items():
            np.testing.assert_array_equal(h["params"][n], v, err_msg=n)


@pytest.mark.parametrize("gate", [True, False])
def test_gate_sends_the_six_sites_through_k5(monkeypatch, gate):
    calls = []
    plain = nn_ops.conv1x1_s2_dgrad

    def counted(dy, w2, h, w):
        calls.append((tuple(dy.shape), tuple(w2.shape)))
        return plain(dy, w2, h, w)
    monkeypatch.setattr(nn_ops, "conv1x1_s2_dgrad", counted)
    with _Gate(gate):
        net, _ = _port_net("NHWC", True)
        del calls[:]
        _port_steps(net, "NHWC", steps=2)
    assert len(calls) == (2 * K5_SITES if gate else 0)
    if gate:
        assert sorted({c[1][1] for c in calls}) == [128, 256, 384]


def _bn_calls(monkeypatch):
    """Count the BatchNorm op's runs."""
    op = get_op("BatchNorm")
    calls = []
    fn = op.fcompute

    def counted(params, *args):
        calls.append(1)
        return fn(params, *args)
    monkeypatch.setattr(op, "fcompute", counted)
    return calls


def _grads(net):
    return {n: p.grad().asnumpy() for n, p in net.collect_params().items()
            if p.grad_req != "null"}


def _one_backward(net, layout):
    x, y = _batch(layout)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = loss_fn(net(mxt.nd.array(x, ctx=CPU)),
                       mxt.nd.array(y, ctx=CPU))
    loss.backward()
    return loss.asnumpy()


@pytest.mark.parametrize("how", ["remat", "mirror"])
def test_remat_matches_plain_and_steps_batchnorm_once(monkeypatch, how):
    if how == "mirror":
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
        flags = {}
    else:
        flags = {"remat": True}
    plain, _ = _port_net("NHWC", True)
    remat, _ = _port_net("NHWC", True, **flags)
    assert remat._flags.get("remat")
    want_loss = _one_backward(plain, "NHWC")
    calls = _bn_calls(monkeypatch)
    x, y = _batch("NHWC")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = loss_fn(remat(mxt.nd.array(x, ctx=CPU)),
                       mxt.nd.array(y, ctx=CPU))
    n_forward = len(calls)
    loss.backward()
    # the backward ran every BatchNorm again, and nothing stepped twice
    assert n_forward > 0 and len(calls) == 2 * n_forward
    np.testing.assert_array_equal(loss.asnumpy(), want_loss)
    got, want = _grads(remat), _grads(plain)
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)
    got, want = _params(remat), _params(plain)
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)


def test_deferred_init_under_record_steps_batchnorm_once():
    """A hybridized net's first call, under record(), finishes deferred
    init: its moving statistics step once, as the eager net's do (the
    initializer draws from numpy's generator, seeded alike for both)."""
    nets = []
    for hybrid in (True, False):
        net = tvision.ResNetV1(tvision.BottleneckV1, *SPEC,
                               classes=CLASSES, prefix="net_")
        np.random.seed(3)
        net.initialize(mxt.init.Xavier(), ctx=CPU)
        assert net.collect_params()["net_conv0_weight"]._data is None
        if hybrid:
            net.hybridize()
        _one_backward(net, "NCHW")
        nets.append(net)
    hybrid, eager = (_params(n) for n in nets)
    for n, v in eager.items():
        np.testing.assert_array_equal(hybrid[n], v, err_msg=n)
    # one step from the initial 0 and 1: 0.1 of the batch's statistics
    mean = eager["net_batchnorm0_running_mean"]
    var = eager["net_batchnorm0_running_var"]
    assert mean.any() and not np.allclose(var, 1.0)
    x = mxt.nd.array(_batch("NCHW")[0], ctx=CPU)
    conv0 = next(iter(nets[1].features._children.values()))
    stem = conv0(x).asnumpy()
    np.testing.assert_allclose(mean, 0.1 * stem.mean(axis=(0, 2, 3)),
                               rtol=1e-4, atol=1e-6)
    for n, v in _grads(nets[1]).items():
        np.testing.assert_array_equal(_grads(nets[0])[n], v, err_msg=n)


def test_grad_req_add_accumulates_and_zero_grad_clears():
    net, _ = _port_net("NCHW", True)
    _one_backward(net, "NCHW")
    once = _grads(net)
    params = net.collect_params()
    params.setattr("grad_req", "add")
    assert all(p.grad_req == "add" for n, p in params.items()
               if "running" not in n)
    assert all(not p.grad().asnumpy().any() for p in params.values()
               if p.grad_req != "null")
    for _ in range(2):
        _one_backward(net, "NCHW")
    for n, v in _grads(net).items():
        np.testing.assert_allclose(v, 2 * once[n], rtol=1e-5, atol=1e-7,
                                   err_msg=n)
    params.zero_grad()
    assert not any(v.any() for v in _grads(net).values())
    params.setattr("grad_req", "null")
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        params["net_conv0_weight"].grad()
    assert not params["net_conv0_weight"].data().data.requires_grad


def test_recorded_signature_and_the_inference_one():
    net, _ = _port_net("NCHW", True)
    x = mxt.nd.array(_batch("NCHW")[0], ctx=CPU)
    compiled.reset()
    net(x)
    for _ in range(2):
        _one_backward(net, "NCHW")
    counts = compiled.compile_counts()
    assert counts == {"compiles": 2, "cache_hits": 1, "retraces": 1,
                      "uncaptured": 0}
    assert "autograd recording: static value False -> True" in \
        compiled.last_retrace()["reason"]
    # the optimizer writes the parameters in place: the inference
    # signature is still cached after a training step
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    trainer.step(BATCH)
    out = net(x)
    assert compiled.compile_counts() == {"compiles": 2, "cache_hits": 2,
                                         "retraces": 1, "uncaptured": 0}
    assert out.grad is None and not out.data.requires_grad


def test_trainer_kvstore_update_and_learning_rate(tmp_path):
    net, _ = _port_net("NCHW", False)
    params = net.collect_params()
    for kv in ("dist_sync", "dist_device_sync", object()):
        with pytest.raises(mxt.MXNetError, match="queue A item 10"):
            gluon.Trainer(params, "sgd", dict(OPT), kvstore=kv)
    trainer = gluon.Trainer(params, "sgd", dict(OPT), kvstore=None)
    assert trainer.learning_rate == OPT["learning_rate"]
    trainer.set_learning_rate(0.01)
    assert trainer.learning_rate == 0.01
    # the state file holds the optimizer (here no update has run yet)
    trainer.save_states(str(tmp_path / "t.states"))
    trainer.load_states(str(tmp_path / "t.states"))
    assert trainer.learning_rate == 0.01 and trainer._updaters[0].states == {}
    # update() is step() without the (one-process, empty) allreduce
    other, _ = _port_net("NCHW", False)
    for n in (net, other):
        _one_backward(n, "NCHW")
    trainer.allreduce_grads()
    trainer.update(BATCH)
    gluon.Trainer(other.collect_params(), "sgd",
                  dict(OPT, learning_rate=0.01)).step(BATCH)
    for n, v in _params(other).items():
        np.testing.assert_array_equal(_params(net)[n], v, err_msg=n)
