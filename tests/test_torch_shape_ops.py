"""The port's shape, indexing and ordering operators against the JAX
package's, op by op.

Every op of `mxnet_tpu/ops/shape_ops.py`, aliases included, has at least
one case in the one op table, `mxnet_tpu_torch/tools/op_sweep.py`: each
case's numpy inputs go to the JAX op's ``fcompute`` and to the port's on
the CPU, f32 and bf16, at the tolerances of `tests/torch_parity.py`.
Shape, index, sort and compare results are held exactly, on distinct
values so that there are no ties; the products (``dot``, ``batch_dot``,
``khatri_rao``) to f32 rtol 1e-5, atol 1e-6. Integer dtypes are compared
by value: the JAX package runs with x64, so some of its index outputs
are int64 where the port's are too, and some wider.
"""
import numpy as np
import pytest

import mxnet_tpu
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.tools import op_sweep
from torch_parity import ATOL, RTOL, cases_of, check, jax_ops_of


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_every_jax_shape_op_is_covered():
    assert jax_ops_of("shape_ops.py") <= {c.name for c in op_sweep.CASES}


@pytest.mark.parametrize("case,dtype", cases_of("shape_ops.py"))
def test_op(case, dtype):
    check(case, dtype)


def test_split_outputs_through_nd():
    """``nd.split`` gives a list of ``num_outputs`` arrays, as the JAX
    package's does."""
    x = _rand(2, 6)
    got = mxt.nd.split(mxt.nd.array(x, ctx=mxt.cpu()), num_outputs=3)
    want = mxnet_tpu.nd.split(mxnet_tpu.nd.array(x), num_outputs=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_ops_run_on_meta_tensors():
    """Symbolic shape inference runs an op on ``meta`` tensors: the new
    ops compose in a Symbol and infer the JAX package's shapes."""
    shapes = []
    for pkg in (mxnet_tpu, mxt):
        s = pkg.sym
        x = s.var("data")
        parts = s.SliceChannel(x, num_outputs=2, axis=1)
        y = s.Concat(s.expand_dims(parts[0], axis=1),
                     s.expand_dims(parts[1], axis=1), dim=1)
        y = s.SequenceMask(s.swapaxes(y, dim1=0, dim2=2))
        y = s.topk(s.tile(y, reps=(1, 2, 1, 1)), k=2, axis=0)
        y = s.broadcast_to(s.expand_dims(y, axis=4), shape=(0, 0, 0, 0, 3))
        y = s.one_hot(s.argmax(y, axis=4), depth=5)
        _, out, _ = y.infer_shape(data=(3, 4, 2))
        shapes.append(out)
    assert shapes[0] == shapes[1]


def test_take_and_dot_gradients_match():
    x = _rand(4, 3)
    w = _rand(3, 2, seed=1)
    grads = []
    for pkg, kw in ((mxnet_tpu, {}), (mxt, {"ctx": mxt.cpu()})):
        a, b = pkg.nd.array(x, **kw), pkg.nd.array(w, **kw)
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.take(pkg.nd.dot(a, b), pkg.nd.array(
                np.array([0, 2, 2], np.float32), **kw))
            y = (y * y).sum()
        y.backward()
        grads.append((a.grad.asnumpy(), b.grad.asnumpy()))
    for g, w in zip(grads[1], grads[0]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
