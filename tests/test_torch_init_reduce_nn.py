"""The port's source, reduction and new neural-network operators against
the JAX package's, on the CPU.

Every op of `mxnet_tpu/ops/init_ops.py` and `mxnet_tpu/ops/reduce.py`,
aliases included, and ``Dropout``, ``LeakyReLU``, ``SoftmaxActivation``
and ``softmax_cross_entropy`` of `mxnet_tpu/ops/nn.py` have their cases
in the one op table, `mxnet_tpu_torch/tools/op_sweep.py`: the same
attributes and numpy inputs go to the JAX op's ``fcompute`` and to the
port's, at the tolerances of `tests/torch_parity.py` (integer and shape
results exact; f32 rtol 1e-5, atol 1e-6). They are held in f32 only: in
bf16 the JAX package rounds intermediate steps to bf16 (the running
product of ``prod``, softmax's sum, the ``leaky`` and ``rrelu`` slopes
themselves) and reads up to 0.019 relative from the port's single
rounding; the card sweep holds the port's bf16 on the card against its
CPU. ``Dropout``'s mask and
``rrelu``'s training slopes come from torch's generator, so they are
held to their distributions and seeds, not to the JAX package's bits;
outside training both ops are held to the JAX package.
"""
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops.registry import get_op as jax_get_op
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.tools import op_sweep
from torch_parity import ATOL, RTOL, cases_of, check, jax_ops_of

CPU = mxt.cpu()
NN_OPS = ("Dropout", "LeakyReLU", "SoftmaxActivation",
          "softmax_cross_entropy")


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("filename", ["init_ops.py", "reduce.py"])
def test_every_jax_op_of_the_file_is_covered(filename):
    assert jax_ops_of(filename) <= {c.name for c in op_sweep.CASES}


@pytest.mark.parametrize("case,dtype", cases_of(
    "init_ops.py", "reduce.py", names=NN_OPS, bf16=False))
def test_op(case, dtype):
    check(case, dtype)


def test_init_op_infers_on_meta():
    """Without a context (symbolic shape inference) an init op returns a
    meta tensor of the right shape."""
    out = get_op("_arange").fcompute({"start": 0, "stop": 6,
                                      "repeat": 2})[0]
    assert out.device.type == "meta" and tuple(out.shape) == (12,)


@pytest.mark.parametrize("args,kw", [
    ((5,), {}), ((2, 8, 1.5), {}), ((0, 3), {"repeat": 2}),
    ((1, 7, 2), {"dtype": "int32"})])
def test_nd_arange(args, kw):
    want = mx.nd.arange(*args, **kw).asnumpy()
    got = mxt.nd.arange(*args, ctx=CPU, **kw).asnumpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("fn,args", [
    ("ones", ((2, 3),)), ("full", ((2, 3), 1.5)), ("empty", ((2, 3),)),
    ("zeros", (4,))])
def test_nd_constructors(fn, args):
    got = getattr(mxt.nd, fn)(*args, ctx=CPU)
    want = getattr(mx.nd, fn)(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    if fn != "empty":
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("name", ["prod", "sum", "max", "min"])
def test_integer_reductions_keep_values(name):
    x = np.arange(1, 13, dtype=np.int32).reshape(3, 4) % 5 + 1
    want = jax_get_op(name).fcompute({"axis": 1}, jnp.asarray(x))
    got = get_op(name).fcompute({"axis": 1}, torch.from_numpy(x))
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("act", ["leaky", "elu", "selu", "prelu"])
def test_leaky_relu_gradients(act):
    x = _rand(2, 3, 4)
    g = np.array([0.1, -0.2, 0.3], np.float32)
    grads = []
    for pkg, kw in ((mx, {}), (mxt, {"ctx": CPU})):
        a = pkg.nd.array(x, **kw)
        gamma = pkg.nd.array(g, **kw)
        a.attach_grad()
        gamma.attach_grad()
        with pkg.autograd.record(train_mode=False):
            extra = [gamma] if act == "prelu" else []
            y = pkg.nd.LeakyReLU(a, *extra, act_type=act, slope=0.3)
            y = (y * y).sum()
        y.backward()
        grads.append([a.grad.asnumpy()] + (
            [gamma.grad.asnumpy()] if act == "prelu" else []))
    for got, want in zip(grads[1], grads[0]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rrelu_in_training_draws_slopes_in_range():
    x = -np.abs(_rand(64, 64)) - 0.1
    op = get_op("LeakyReLU")
    params = {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.3,
              "_is_train": True}
    assert op.draws(params) and not op.draws(dict(params, _is_train=False))
    gen = torch.Generator().manual_seed(3)
    out = op.fcompute(dict(params, _generator=gen), torch.from_numpy(x))[0]
    slopes = out.numpy() / x
    assert 0.1 <= slopes.min() and slopes.max() < 0.3
    assert abs(slopes.mean() - 0.2) < 0.005


@pytest.mark.parametrize("params", [{"p": 0.5, "_is_train": True},
                                    {"p": 0.5, "mode": "always"}])
def test_dropout_draws(params):
    """At p = 0.5 over 2^16 elements: the zero share within 4 sigma of
    0.5, survivors scaled by exactly 2, the mask the ratio, one seed
    giving the same bits and another seed others."""
    n = 1 << 16
    x = torch.from_numpy(np.abs(_rand(n)) + 0.5)
    op = get_op("Dropout")
    assert op.draws(params)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return op.fcompute(dict(params, _generator=gen), x)

    out, mask = draw(7)
    zeros = float((out == 0).float().mean())
    assert abs(zeros - 0.5) < 4 * 0.5 / np.sqrt(n)
    kept = out != 0
    assert torch.equal(out[kept], x[kept] * 2)
    assert set(torch.unique(mask).tolist()) == {0.0, 2.0}
    assert torch.equal(draw(7)[0], out)
    assert not torch.equal(draw(8)[0], out)


def test_dropout_through_nd_in_train_mode_and_predict_mode():
    x = mxt.nd.array(np.ones((64, 64), np.float32), ctx=CPU)
    with mxt.autograd.train_mode():
        a = mxt.nd.Dropout(x, p=0.5)[0]
        b = mxt.nd.Dropout(x, p=0.5)[0]
    assert set(np.unique(a.asnumpy())) == {0.0, 2.0}
    assert not np.array_equal(a.asnumpy(), b.asnumpy())
    np.testing.assert_array_equal(mxt.nd.Dropout(x, p=0.5)[0].asnumpy(),
                                  x.asnumpy())


def test_op_sweep_covers_every_op_and_its_controls_fail():
    """`tools/op_sweep.py`, the card's sweep, rehearsed on the CPU: its
    cases cover every op of the four op modules and the four nn ops, a
    device against itself reads 0, and each family's control (inputs
    rounded to bf16 on one side) reads above the family's limit."""
    from mxnet_tpu_torch.ops.registry import _OPS
    port = {n for n, op in _OPS.items()
            if os.path.basename(inspect.getsourcefile(op.fcompute)) in
            ("elemwise.py", "init_ops.py", "shape_ops.py", "reduce.py")}
    assert port | set(NN_OPS) == {c.name for c in op_sweep.CASES}
    families, fails = op_sweep.sweep(CPU)
    assert not fails and all(w == 0 for _, w in families.values())
    for family in ("arith", "transcendental", "reduction", "product"):
        assert op_sweep.control(CPU, family) > op_sweep.LIMITS[family]
