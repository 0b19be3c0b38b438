"""Python custom operators (``mx.operator``) in the port against the JAX
package.

The cases of `tests/test_custom_op.py` run in both packages from the same
numpy inputs: eager forward, the gradient under ``autograd.record()``,
two outputs, a symbol executor's forward and backward, and an op name
that was never registered. Beside them: ``assign`` with every ``req``, a
loss-like op (``need_top_grad=False``) whose backward ignores the head
gradient, and a hybridized Gluon block holding ``Custom``, which gives
the eager block's outputs and gradients and is counted by
``compiled.compile_counts()["uncaptured"]``: on the card such a program
runs eagerly instead of being captured. Values are held to f32 rtol 1e-6
(the same numpy code runs in both packages). The JAX package runs with
``MXNET_XLA_STATS=0``: under the installed JAX its executor's
compile-tracking layer fails.
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import compiled

RTOL = 1e-6


def _register(mx, prefix):
    """The test ops of tests/test_custom_op.py, plus a loss, in ``mx``."""

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], 1.0 / (1.0 + np.exp(-x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            g = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], g * y * (1.0 - y))

    @mx.operator.register(prefix + "sigmoid")
    class SigmoidProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class Split2(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], x * 2)
            self.assign(out_data[1], req[1], x + 1)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0].asnumpy() * 2 + out_grad[1].asnumpy())

    @mx.operator.register(prefix + "split2")
    class Split2Prop(mx.operator.CustomOpProp):
        def list_outputs(self):
            return ["a", "b"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Split2()

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], y / y.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().astype(np.int64)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], y / lab.shape[0])

    @mx.operator.register(prefix + "softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


_register(mxj, "tt_")
_register(mxt, "tt_")


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _both(fn):
    """``fn(mx, ctx)`` in the JAX package and in the port (on the CPU)."""
    return fn(mxj, mxj.cpu()), fn(mxt, mxt.cpu())


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_custom_forward_eager():
    xv = _x(2, 3)
    want, got = _both(lambda mx, ctx: mx.nd.Custom(
        mx.nd.array(xv, ctx=ctx), op_type="tt_sigmoid").asnumpy())
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, 1 / (1 + np.exp(-xv)), rtol=RTOL)


def test_custom_backward_autograd():
    xv = _x(1, 3, seed=1)

    def run(mx, ctx):
        x = mx.nd.array(xv, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            loss = (mx.nd.Custom(x, op_type="tt_sigmoid") * 3.0).sum()
        loss.backward()
        return x.grad.asnumpy()

    want, got = _both(run)
    s = 1 / (1 + np.exp(-xv))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, 3 * s * (1 - s), rtol=1e-5)


def test_custom_multi_output():
    xv = np.arange(4, dtype=np.float32).reshape(2, 2)

    def run(mx, ctx):
        x = mx.nd.array(xv, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            a, b = mx.nd.Custom(x, op_type="tt_split2")
            loss = (a * a).sum() + (b * 3).sum()
        loss.backward()
        return a.asnumpy(), b.asnumpy(), x.grad.asnumpy()

    want, got = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    np.testing.assert_allclose(got[0], xv * 2)
    np.testing.assert_allclose(got[2], 2 * (2 * xv * 2) + 3)


def test_custom_in_symbol_executor():
    xv = _x(2, 3, seed=2)
    gv = _x(2, 3, seed=3)

    def run(mx, ctx):
        out = mx.sym.Custom(mx.sym.Variable("data"), op_type="tt_sigmoid",
                            name="sig")
        ex = out.simple_bind(ctx, data=(2, 3))
        ex.forward(is_train=True, data=mx.nd.array(xv, ctx=ctx))
        ex.backward(mx.nd.array(gv, ctx=ctx))
        return ex.outputs[0].asnumpy(), ex.grad_arrays[0].asnumpy()

    want, got = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    s = 1 / (1 + np.exp(-xv))
    np.testing.assert_allclose(got[1], gv * s * (1 - s), rtol=1e-5)


def test_custom_unregistered_raises():
    for mx in (mxj, mxt):
        with pytest.raises(mx.MXNetError):
            mx.nd.Custom(mx.nd.ones((1,), ctx=mx.cpu()),
                         op_type="definitely_missing")


def test_loss_op_takes_no_head_gradient():
    """need_top_grad=False: a backward from the output, and an executor's
    backward without out_grads, give the op's own gradient."""
    xv = _x(4, 3, seed=4)
    lab = np.array([0, 2, 1, 2], np.float32)

    def run(mx, ctx):
        x = mx.nd.array(xv, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(x, mx.nd.array(lab, ctx=ctx),
                             op_type="tt_softmax")
        y.backward()
        sym = mx.sym.Custom(mx.sym.Variable("data"),
                            mx.sym.Variable("label"), op_type="tt_softmax")
        ex = sym.simple_bind(ctx, data=(4, 3), label=(4,))
        ex.forward(is_train=True, data=mx.nd.array(xv, ctx=ctx),
                   label=mx.nd.array(lab, ctx=ctx))
        ex.backward()
        return y.asnumpy(), x.grad.asnumpy(), ex.grad_dict["data"].asnumpy()

    want, got = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    p = got[0].copy()
    p[np.arange(4), lab.astype(int)] -= 1
    np.testing.assert_allclose(got[1], p / 4, rtol=1e-5)
    np.testing.assert_allclose(got[2], p / 4, rtol=1e-5)


@pytest.mark.parametrize("req,want", [("write", [5.0, 5.0]),
                                      ("inplace", [5.0, 5.0]),
                                      ("add", [6.0, 7.0]),
                                      ("null", [1.0, 2.0])])
def test_assign_honours_every_req(req, want):
    for mx in (mxj, mxt):
        dst = mx.nd.array(np.array([1.0, 2.0], np.float32), ctx=mx.cpu())
        mx.operator.CustomOp().assign(dst, req, np.array([5.0, 5.0]))
        np.testing.assert_array_equal(dst.asnumpy(), want)
    with pytest.raises(ValueError):
        mxt.operator.CustomOp().assign(dst, "sum", np.zeros(2))


def _custom_block(mx):

    class Net(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = mx.gluon.nn.Dense(3, in_units=4)

        def hybrid_forward(self, F, x):
            return F.Custom(self.dense(x), op_type="tt_sigmoid") * 2.0

    mx.random.seed(0)
    np.random.seed(0)
    net = Net(prefix="cnet_")
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    return net


def test_hybridized_block_with_custom_runs_uncaptured():
    """A hybridized block holding Custom gives the eager block's outputs
    and gradients (and the JAX package's), and its program is counted as
    uncaptured once."""
    xv = _x(5, 4, seed=5)

    def run(mx, ctx, hybridize):
        net = _custom_block(mx)
        if mx is mxt:      # the same weights in both packages
            src = _custom_block(mxj)
            for (_, p), (_, q) in zip(sorted(net.collect_params().items()),
                                      sorted(src.collect_params().items())):
                p.set_data(mx.nd.array(q.data().asnumpy(), ctx=ctx))
        if hybridize:
            net.hybridize()
        x = mx.nd.array(xv, ctx=ctx)
        outs = []
        for _ in range(2):
            with mx.autograd.record():
                y = net(x)
            y.backward()
            outs.append(y.asnumpy())
        outs.append(net(x).asnumpy())
        outs.append(net(x).asnumpy())
        outs.append(net.dense.weight.grad().asnumpy())
        return outs

    want = run(mxj, mxj.cpu(), True)
    eager = run(mxt, mxt.cpu(), False)
    compiled.reset()
    hyb = run(mxt, mxt.cpu(), True)
    counts = compiled.compile_counts()
    assert counts["uncaptured"] == 1, counts
    assert counts["compiles"] == 2, counts
    for g, e, w in zip(hyb, eager, want):
        np.testing.assert_allclose(g, e, rtol=RTOL)
        np.testing.assert_allclose(g, w, rtol=1e-5)


def test_custom_reaches_the_namespaces():
    assert mxt.operator.get_prop_cls("tt_sigmoid").__name__ == "SigmoidProp"
    assert callable(mxt.nd.Custom) and callable(mxt.sym.Custom)
    with pytest.raises(mxt.MXNetError):
        mxt.operator.register("bad")(object)
