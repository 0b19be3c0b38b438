"""The model zoo's vision families of the port against the JAX package's,
on the CPU: names, parameters, and the small variants' forwards.

Every one of the 34 names of ``get_model`` builds in both packages with
the same parameter names and (deferred) shapes, and ``pretrained=True``
raises. The smallest variant of AlexNet, VGG, SqueezeNet, MobileNet v1
and v2 runs eagerly at batch 1 (224 x 224) from the JAX net's Xavier
weights, carried across by ``weights.set_block_params``: logits at rtol
1e-4, atol 1e-5 (f32 on both sides; XLA's and PyTorch's convolutions sum
in other orders through up to 20 layers). In the port the hybridized
call gives the eager logits (rtol 1e-6, atol 1e-7: the same kernels, one
program). ``Concurrent``, ``HybridConcurrent`` and ``Identity`` match
the JAX blocks eagerly and as symbols. DenseNet-121 and Inception-v3 are
`test_torch_zoo_deep.py`. The JAX nets run hybridized with
``MXNET_XLA_STATS=0`` (one XLA program a net; its eager forward compiles
as long).
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

RTOL, ATOL = 1e-4, 1e-5
SAME_RTOL, SAME_ATOL = 1e-6, 1e-7
CPU = mxt.cpu()


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _shapes(net):
    return {n: tuple(p.shape) for n, p in net.collect_params().items()}


def test_get_model_serves_every_jax_name():
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(tvision._models) == 34
    with pytest.raises(ValueError):
        tvision.get_model("no_such_net")


def _prefix(name):
    """One prefix for a net in both packages: each numbers unnamed blocks
    by its own process-wide counter, which other tests move."""
    return name.replace(".", "_") + "_"


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_parameter_names_and_shapes(name):
    kw = {"classes": 10, "prefix": _prefix(name)}
    with mx.cpu():
        want = _shapes(jvision.get_model(name, **kw))
    got = _shapes(tvision.get_model(name, **kw))
    assert got == want
    with pytest.raises(mxt.MXNetError, match="pretrained"):
        tvision.get_model(name, pretrained=True)


def carried(name, size, batch=1, seed=0, **kw):
    """(JAX net, port net, input): the JAX net initialised with Xavier
    and hybridized, its weights carried into the port's."""
    x = np.random.RandomState(seed).randn(batch, 3, size, size) \
        .astype(np.float32)
    kw = dict(kw, prefix=_prefix(name))
    with mx.cpu():
        mx.random.seed(seed)
        jnet = jvision.get_model(name, **kw)
        jnet.initialize(mx.init.Xavier())
        jnet.hybridize()
        jnet(mx.nd.array(x))
    tnet = tvision.get_model(name, **kw)
    tnet.initialize(mxt.init.Xavier(), ctx=CPU)
    mxt.set_block_params(tnet, {n: p.data().asnumpy() for n, p in
                                jnet.collect_params().items()})
    return jnet, tnet, x


def check_family(name, size):
    jnet, tnet, x = carried(name, size)
    with mx.cpu():
        want = jnet(mx.nd.array(x)).asnumpy()
    eager = tnet(mxt.nd.array(x, ctx=CPU)).asnumpy()
    assert eager.shape == want.shape == (1, 1000)
    scale = np.abs(want).max()
    np.testing.assert_allclose(eager, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=name)
    tnet.hybridize()
    hybrid = tnet(mxt.nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(hybrid, eager, rtol=SAME_RTOL,
                               atol=SAME_ATOL * scale, err_msg=name)


@pytest.mark.parametrize("name", ["alexnet", "vgg11", "squeezenet1.1",
                                  "mobilenet0.25", "mobilenetv2_0.25"])
def test_family_forward_matches_jax(name):
    check_family(name, 224)


def _branches(pkg, hybrid):
    nn = pkg.gluon.nn
    contrib = pkg.gluon.contrib.nn
    block = (contrib.HybridConcurrent if hybrid else contrib.Concurrent)(
        axis=1, prefix="cc_")
    with block.name_scope():
        block.add(nn.Dense(3, in_units=4), contrib.Identity(),
                  nn.Dense(2, in_units=4, activation="relu"))
    return block


@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["Concurrent", "HybridConcurrent"])
def test_contrib_blocks(hybrid):
    x = np.random.RandomState(4).randn(5, 4).astype(np.float32)
    with mx.cpu():
        jblock = _branches(mx, hybrid)
        jblock.initialize(mx.init.Xavier())
        want = jblock(mx.nd.array(x)).asnumpy()
    tblock = _branches(mxt, hybrid)
    tblock.initialize(ctx=CPU)
    mxt.set_block_params(tblock, {n: p.data().asnumpy() for n, p in
                                  jblock.collect_params().items()})
    got = tblock(mxt.nd.array(x, ctx=CPU)).asnumpy()
    assert got.shape == (5, 9)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if hybrid:
        tsym, jsym = tblock._trace_symbol(), jblock(mx.sym.var("data"))
        assert tsym.list_arguments() == jsym.list_arguments()
        assert json.loads(tsym.tojson())["heads"] == \
            json.loads(jsym.tojson())["heads"]
        tblock.hybridize()
        np.testing.assert_allclose(
            tblock(mxt.nd.array(x, ctx=CPU)).asnumpy(), got, rtol=1e-6,
            atol=1e-7)
    assert mxt.gluon.contrib.nn.__all__ == mx.gluon.contrib.nn.__all__
