"""The port's autograd tape against the JAX package's, on the CPU.

The same inputs, drawn from a numpy seed, go through both packages'
``nd`` ops under ``autograd.record()``; the gradients that land in
``.grad`` (or that ``autograd.grad`` returns) are held to rtol 1e-5,
atol 1e-6 (f32 both sides; the convolution and BatchNorm chains sum in
another order): elementwise, ``FullyConnected``, ``Convolution`` and
``BatchNorm`` chains; ``grad_req`` write, add and null; ``grad`` with and
without ``create_graph`` (a second-order case); a custom ``Function``;
``mark_variables``, head gradients and ``pause()``; the freed-graph and
no-tape errors. The port alone: a write into a recorded input before the
backward raises, and the recording flags.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as tag

RTOL, ATOL = 1e-5, 1e-6
CPU = mxt.cpu()


def _arrays(*shapes, seed=0, positive=False):
    rng = np.random.RandomState(seed)
    out = []
    for s in shapes:
        v = rng.randn(*s)
        out.append((np.abs(v) + 0.5 if positive else v).astype(np.float32))
    return out


def _both(values):
    """The same numpy values as JAX and port NDArrays, each a leaf."""
    j = [mx.nd.array(v) for v in values]
    t = [mxt.nd.array(v, ctx=CPU) for v in values]
    for a in j + t:
        a.attach_grad()
    return j, t


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def _elementwise(nd, a, b):
    y = nd.exp(a * 0.3) * nd.log(b) + nd.sqrt(b) / (a * a + 1.0)
    y = nd.sigmoid(y) - nd.relu(a - 0.1) * nd.abs(b - 1.0)
    y = nd.maximum(y, a) + nd.minimum(y, 0.2) + nd.square(y - b)
    return (y * 2.0 - 1.0).sum()


def _fully_connected(nd, x, w, b):
    h = nd.FullyConnected(x, w, b, num_hidden=w.shape[0])
    h = nd.Activation(h, act_type="tanh")
    return nd.mean(nd.square(h), axis=1).sum()


def _convolution(nd, x, w, b):
    y = nd.Convolution(x, w, b, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       num_filter=w.shape[0])
    y = nd.Activation(y, act_type="relu")
    return nd.sum(nd.Pooling(y, kernel=(2, 2), stride=(2, 2),
                             pool_type="avg") * y.mean())


def _batchnorm(nd, x, w, gamma, beta, r):
    mean = nd.zeros((w.shape[0],), ctx=_ctx(x))
    var = nd.zeros((w.shape[0],), ctx=_ctx(x)) + 1.0
    y = nd.Convolution(x, w, kernel=(1, 1), num_filter=w.shape[0],
                       no_bias=True)
    y = _first(nd.BatchNorm(y, gamma, beta, mean, var, fix_gamma=False,
                            eps=1e-5))
    return nd.sum(nd.Activation(y, act_type="tanh") * r)


def _ctx(arr):
    return arr.context


CHAINS = {
    "elementwise": (_elementwise, [(4, 5), (4, 5)], True),
    "fully_connected": (_fully_connected, [(6, 10), (7, 10), (7,)], False),
    "convolution": (_convolution, [(2, 3, 8, 8), (4, 3, 3, 3), (4,)], False),
    "batchnorm": (_batchnorm, [(4, 3, 6, 6), (5, 3, 1, 1), (5,), (5,),
                               (4, 5, 6, 6)], False),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_backward_through_chain_matches_jax(chain):
    fn, shapes, positive = CHAINS[chain]
    values = _arrays(*shapes, seed=len(chain), positive=positive)
    j, t = _both(values)
    with jag.record():
        jy = fn(mx.nd, *j)
    jy.backward()
    with tag.record():
        ty = fn(mxt.nd, *t)
    ty.backward()
    np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    for k, (ja, ta) in enumerate(zip(j, t)):
        assert ta.grad.shape == ja.grad.shape
        np.testing.assert_allclose(ta.grad.asnumpy(), ja.grad.asnumpy(),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg="input %d" % k)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_matches_jax(req):
    values = _arrays((3, 4), (3, 4), seed=5)
    got = {}
    for name, pkg, ag, ctx in (("jax", mx, jag, {}),
                               ("port", mxt, tag, {"ctx": CPU})):
        a, b = (pkg.nd.array(v, **ctx) for v in values)
        a.attach_grad(grad_req=req)
        for k in range(2):
            with ag.record():
                y = (a * b * (k + 1.0)).sum()
            y.backward()
        got[name] = a.grad.asnumpy()
    np.testing.assert_allclose(got["port"], got["jax"], rtol=RTOL, atol=ATOL)
    want = {"write": 2 * values[1], "add": 3 * values[1],
            "null": np.zeros_like(values[1])}[req]
    np.testing.assert_allclose(got["port"], want, rtol=RTOL, atol=ATOL)


def test_grad_without_create_graph_matches_jax():
    values = _arrays((5,), (5,), seed=6, positive=True)
    j, t = _both(values)
    with jag.record():
        jy = (j[0] * j[0] * j[1]).sum() + mx.nd.log(j[1]).sum()
    with tag.record():
        ty = (t[0] * t[0] * t[1]).sum() + mxt.nd.log(t[1]).sum()
    jg = jag.grad(jy, j)
    tg = tag.grad(ty, t)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
    # grad() writes no .grad buffer, and the graph is freed
    assert not t[0].grad.asnumpy().any()
    with pytest.raises(mxt.MXNetError, match="already freed"):
        ty.backward()


def test_second_order_grad_matches_jax():
    """d/dx of sum((dy/dx)^2) for y = sum(x^3 * w): the first gradient,
    3 x^2 w, is on the tape (create_graph), so the second backward gives
    36 x^3 w^2."""
    values = _arrays((6,), (6,), seed=7)
    j, t = _both(values)
    for pkg, ag, (x, w) in ((mx, jag, j), (mxt, tag, t)):
        with ag.record():
            y = (x * x * x * w).sum()
            g = ag.grad(y, x, create_graph=True)
            z = (g * g).sum()
        z.backward()
    want = 36 * values[0] ** 3 * values[1] ** 2
    np.testing.assert_allclose(t[0].grad.asnumpy(), j[0].grad.asnumpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[0].grad.asnumpy(), want, rtol=1e-4,
                               atol=1e-5)


def _sigmoid_function(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1.0 / (1.0 + pkg.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1.0 - y)
    return Sigmoid()


def test_custom_function_matches_jax():
    values = _arrays((3, 4), seed=8)
    j, t = _both(values)
    for pkg, ag, x in ((mx, jag, j[0]), (mxt, tag, t[0])):
        fn = _sigmoid_function(pkg)
        with ag.record():
            y = fn(x * 2.0)
            z = (y * y).sum()
        z.backward()
        # outside record() it computes the forward only
        assert fn(x).shape == (3, 4)
    np.testing.assert_allclose(t[0].grad.asnumpy(), j[0].grad.asnumpy(),
                               rtol=RTOL, atol=ATOL)


def test_mark_variables_head_grads_and_pause_match_jax():
    values = _arrays((4,), (4,), (4,), seed=9)
    got = {}
    for name, pkg, ag, ctx in (("jax", mx, jag, {}),
                               ("port", mxt, tag, {"ctx": CPU})):
        x, c, hg = (pkg.nd.array(v, **ctx) for v in values)
        gx = pkg.nd.zeros((4,), **ctx)
        ag.mark_variables([x], [gx], "write")
        with ag.record():
            y = x * x
            with ag.pause():
                assert not ag.is_recording()
                const = x * c        # not recorded: a constant
            out = y * const
        out.backward(hg)
        got[name] = gx.asnumpy()
    np.testing.assert_allclose(got["port"], got["jax"], rtol=RTOL, atol=ATOL)
    x, c, hg = values
    np.testing.assert_allclose(got["port"], 2 * x * (x * c) * hg,
                               rtol=RTOL, atol=ATOL)


def test_backward_errors_match_jax():
    for pkg, ag, ctx in ((mx, jag, {}), (mxt, tag, {"ctx": CPU})):
        x = pkg.nd.array(np.ones((3,), np.float32), **ctx)
        with pytest.raises(pkg.base.MXNetError if pkg is mx
                           else mxt.MXNetError, match="not attached"):
            (x * 2.0).backward()
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()                 # the graph was kept once
        with pytest.raises(Exception, match="already freed"):
            y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), 2.0 * np.ones(3))


def test_write_into_a_recorded_input_raises():
    """The JAX package reads a recorded op's inputs as they were at record
    time; torch saves the tensor itself, so the port refuses a backward
    after the tensor was written."""
    x = mxt.nd.array(np.arange(3, dtype=np.float32), ctx=CPU)
    x.attach_grad()
    with tag.record():
        y = (x * x).sum()
    x[:] = 5.0
    with pytest.raises(mxt.MXNetError, match="written in place"):
        y.backward()


def test_flags_and_detach():
    assert not tag.is_recording() and not tag.is_training()
    with tag.record():
        assert tag.is_recording() and tag.is_training()
        with tag.predict_mode():
            assert tag.is_recording() and not tag.is_training()
    with tag.train_mode():
        assert tag.is_training() and not tag.is_recording()
    prev = tag.set_recording(True)
    assert prev is False and tag.is_recording()
    tag.set_recording(prev)
    assert tag.set_training(True) is False
    tag.set_training(False)
    x = mxt.nd.array([1.0, 2.0], ctx=CPU)
    x.attach_grad()
    with tag.record():
        y = x * 3.0
        d = y.detach()
    assert y.data.requires_grad and not d.data.requires_grad
    assert d.grad is None
    with pytest.raises(NotImplementedError):
        tag.get_symbol(y)
