"""Shared harness for the port's op parity tests.

The op cases are one table, ``mxnet_tpu_torch/tools/op_sweep.py``'s
``CASES``, which the card sweep runs too. Each parity test file takes the
cases of the ops that one JAX op module defines (``cases_of``) and holds
the port's op against the JAX op's ``fcompute`` from its registry, on
the same numpy inputs on the CPU (``check``). Tolerances: a case of the
``exact`` family, and any integer result, exactly (integers by value:
the JAX package runs with x64, so some of its index outputs are wider
than the port's); f32 rtol 1e-5, atol 1e-6; bf16 rtol 2^-7, atol 1e-6,
both sides rounding an f32 result once. Three bf16 ops have a measured
limit, ``BF16_COMPOSED``: the JAX package's ``log2``, ``log10`` and
``hypot`` round their intermediate steps to bf16 (``log(x) / log(2)``,
``log(x) / log(10)``; hypot's scaling), and read up to 0.0088, 0.0086
and 0.0075 from the port's, which rounds once; there the port is also
held to the exact function of its bf16 inputs within one rounding, 2^-8.
"""
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX package's ops)
from mxnet_tpu.ops.registry import _OPS as JAX_OPS
from mxnet_tpu.ops.registry import get_op as jax_get_op
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.tools import op_sweep

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 2.0 ** -7
BF16_COMPOSED = {"log2": 2.0 ** -6, "log10": 2.0 ** -6, "_hypot": 2.0 ** -6,
                 "broadcast_hypot": 2.0 ** -6}
EXACT_FN = {"log2": np.log2, "log10": np.log10, "_hypot": np.hypot,
            "broadcast_hypot": np.hypot}


def jax_ops_of(*filenames):
    """The names of the ops the JAX package defines in ``filenames``."""
    return {n for n, op in JAX_OPS.items()
            if os.path.basename(inspect.getsourcefile(op.fcompute))
            in filenames}


def cases_of(*filenames, names=(), bf16=True):
    """The table's (case, dtype) params whose op the JAX package defines
    in ``filenames`` or is named in ``names``: f32, and bf16 where the
    case runs in bf16 (unless ``bf16`` is false)."""
    ops = jax_ops_of(*filenames) | set(names)
    return [pytest.param(c, dt, id="%s-%d-%s" % (c.name, i, dt))
            for i, c in enumerate(op_sweep.CASES) if c.name in ops
            for dt in (("float32", "bfloat16") if bf16 and c.bf16
                       else ("float32",))]


def check(case, dtype):
    """The port's op against the JAX package's on ``case`` in ``dtype``,
    outside training (where neither draws)."""
    params = dict(case.params, _is_train=False)
    assert not get_op(case.name).draws(params), case
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax_get_op(case.name).fcompute(
        dict(params, _rng_key=None),
        *[jnp.asarray(a, dtype=jdt) for a in case.arrays])
    got = op_sweep.run_case(case, mxt.cpu(), dtype)
    assert len(got) == len(want), case
    if dtype == "bfloat16" and case.name in EXACT_FN:
        exact = EXACT_FN[case.name](*[
            torch.from_numpy(a).bfloat16().double().numpy()
            for a in case.arrays])
        np.testing.assert_allclose(got[0].double().numpy(), exact,
                                   rtol=2.0 ** -8)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape), case
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        if case.family == "exact" or not np.issubdtype(g.dtype,
                                                       np.floating):
            np.testing.assert_array_equal(g, w.astype(g.dtype), str(case))
        elif dtype == "bfloat16":
            np.testing.assert_allclose(
                g, w, rtol=BF16_COMPOSED.get(case.name, BF16_RTOL),
                atol=ATOL, err_msg=str(case))
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=str(case))
