"""The port's elementwise operators against the JAX package's, op by op.

Every op of `mxnet_tpu/ops/elemwise.py`, aliases included, has its cases
in the one op table, `mxnet_tpu_torch/tools/op_sweep.py`: each case's
numpy inputs go to the JAX op's ``fcompute`` and to the port's on the
CPU, f32 and bf16, at the tolerances of `tests/torch_parity.py` (exact
for the comparisons, logical ops, rounding, casts and copies). Integer
arrays keep their dtype under a scalar. ``BlockGrad`` and ``make_loss``
are also held under the tape: no gradient through the first, the
identity's through the second.
"""
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

SHAPE = (3, 4)
ELEMWISE = jax_ops_of("elemwise.py")
# scalar ops whose result is a float in both packages
FLOAT_RESULT = {"_hypot_scalar", "_rdiv_scalar", "_div_scalar"}
ON_INT32 = {c.name: c.params["scalar"] for c in op_sweep.CASES
            if c.name in ELEMWISE and c.name.endswith("_scalar")
            and c.name not in FLOAT_RESULT}


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def test_every_jax_elemwise_op_is_covered():
    assert ELEMWISE <= {c.name for c in op_sweep.CASES}


@pytest.mark.parametrize("case,dtype", cases_of("elemwise.py"))
def test_op(case, dtype):
    check(case, dtype)


@pytest.mark.parametrize("name", sorted(ON_INT32))
def test_scalar_on_int32_keeps_the_dtype(name):
    """A scalar is rounded to the array's dtype first (int32 adds 1 of
    1.5): values exact, and the port's result int32 (hypot and division
    give floats in both packages)."""
    x = np.array([[-3, 1, 4], [2, -5, 6]], dtype=np.int32)
    if name in ("_rpower_scalar", "_power_scalar"):
        x = np.abs(x)
    if name in ("_rmod_scalar",):
        x = np.where(x == 0, 1, x)
    params = {"scalar": ON_INT32[name]}
    want = np.asarray(jax_get_op(name).fcompute(dict(params),
                                                jnp.asarray(x))[0])
    got = get_op(name).fcompute(dict(params), torch.from_numpy(x))[0]
    assert got.dtype == torch.int32, (name, got.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["BlockGrad", "stop_gradient", "make_loss",
                                "MakeLoss", "_copy", "zeros_like"])
def test_gradient_under_the_tape(op):
    """``y = op(x) * 3 + x``: the gradient of ``sum(y)`` in both
    packages (1 through BlockGrad, 4 through the identity)."""
    x = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    grads = []
    for pkg, kw in ((mx, {}), (mxt, {"ctx": mxt.cpu()})):
        a = pkg.nd.array(x, **kw)
        a.attach_grad()
        with pkg.autograd.record():
            y = getattr(pkg.nd, op)(a) * 3.0 + a
        y.backward()
        grads.append(a.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=RTOL, atol=ATOL)


def test_copy_is_a_copy():
    a = mxt.nd.array(np.ones(SHAPE, np.float32), ctx=mxt.cpu())
    b = a.copy()
    b[:] = 5.0
    assert float(a.sum().asscalar()) == float(np.prod(SHAPE))
