"""The ``_linalg_*`` ops of the port against the JAX package's, on the CPU.

Each of the twelve ops (``gemm``, ``gemm2``, ``potrf``, ``potri``,
``trsm``, ``trmm``, ``sumlogdiag``, ``syrk``, ``gelqf``, ``syevd``,
``inverse``, ``det``), in each of its attribute variants, at batched
shapes (2 x 4 x 4 and the like) in f32 on numpy inputs from a seed, goes
through the JAX op's ``fcompute`` and ``jax.vjp`` and through the port's
``fcompute`` and the tape, with the same cotangents. The factorisations
are fed well-conditioned inputs (``A Aᵀ + n I``, triangles with a
dominant diagonal). Forward outputs at rtol 1e-5, atol 1e-5 and input
gradients at rtol 1e-4, atol 1e-4: f32 on both sides, the two LAPACK
routes (XLA's and PyTorch's) order their sums differently, and a
solve's gradient passes through a second solve. ``syevd``'s eigenvectors
are defined up to sign: rows are compared after aligning signs, and its
gradient is that of the sign-free ``sum(c_U * U**2) + sum(c_w * w)``.
``nd.linalg``/``sym.linalg`` list exactly the JAX namespaces' names, and
every ``linalg_*`` alias is the ``_linalg_*`` op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch.ops.registry import get_op as torch_op

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
OPS = ["gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "sumlogdiag",
       "syrk", "gelqf", "syevd", "inverse", "det"]


def _rng(seed):
    return np.random.RandomState(seed)


def _spd(rng, b=2, n=4):
    a = rng.randn(b, n, n)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _tri(rng, lower=True, b=2, n=4):
    a = rng.randn(b, n, n) * 0.3 + 2.0 * np.eye(n)
    return (np.tril(a) if lower else np.triu(a)).astype(np.float32)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _cases():
    r = _rng(0)
    return [
        ("gemm", {"alpha": 0.7, "beta": 1.3},
         [_rand(r, 2, 3, 4), _rand(r, 2, 4, 5), _rand(r, 2, 3, 5)]),
        ("gemm", {"transpose_a": True, "transpose_b": True},
         [_rand(r, 2, 4, 3), _rand(r, 2, 5, 4), _rand(r, 2, 3, 5)]),
        ("gemm2", {"alpha": -1.5},
         [_rand(r, 2, 3, 4), _rand(r, 2, 4, 5)]),
        ("gemm2", {"transpose_a": True},
         [_rand(r, 3, 4), _rand(r, 3, 2)]),
        ("potrf", {}, [_spd(r)]),
        ("potrf", {"lower": False}, [_spd(r)]),
        ("potri", {}, [np.linalg.cholesky(_spd(r)).astype(np.float32)]),
        ("potri", {"lower": False}, [np.linalg.cholesky(_spd(r)).transpose(
            0, 2, 1).astype(np.float32)]),
        ("trsm", {"alpha": 2.0}, [_tri(r), _rand(r, 2, 4, 3)]),
        ("trsm", {"transpose": True, "lower": False},
         [_tri(r, lower=False), _rand(r, 2, 4, 3)]),
        ("trsm", {"rightside": True}, [_tri(r), _rand(r, 2, 3, 4)]),
        ("trsm", {"rightside": True, "transpose": True, "alpha": 0.5},
         [_tri(r), _rand(r, 2, 3, 4)]),
        ("trmm", {"alpha": 1.5}, [_rand(r, 2, 4, 4), _rand(r, 2, 4, 3)]),
        ("trmm", {"lower": False, "transpose": True, "rightside": True},
         [_rand(r, 2, 4, 4), _rand(r, 2, 3, 4)]),
        ("sumlogdiag", {}, [_spd(r)]),
        ("syrk", {"alpha": 0.5}, [_rand(r, 2, 3, 5)]),
        ("syrk", {"transpose": True}, [_rand(r, 2, 3, 5)]),
        ("gelqf", {}, [_rand(r, 2, 3, 5)]),
        ("gelqf", {}, [_rand(r, 4, 4)]),
        ("syevd", {}, [_spd(r)]),
        ("inverse", {}, [_spd(r)]),
        ("det", {}, [_rand(r, 2, 4, 4) + 2 * np.eye(4, dtype=np.float32)]),
    ]


CASES = _cases()


def _sign_free(name, outs):
    """syevd's U squared: the rest as they are."""
    if name == "syevd":
        return (outs[0] * outs[0], outs[1])
    return outs


def _jax(name, params, inputs, cots):
    fn = jax_op("_linalg_" + name).fcompute

    def f(*xs):
        return _sign_free(name, fn(dict(params), *xs))
    outs, vjp = jax.vjp(f, *[jnp.asarray(x) for x in inputs])
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    raw = jax_op("_linalg_" + name).fcompute(
        dict(params), *[jnp.asarray(x) for x in inputs])
    return ([np.asarray(o) for o in raw], [np.asarray(g) for g in grads])


def _torch(name, params, inputs, cots):
    xs = [torch.from_numpy(x.copy()).requires_grad_() for x in inputs]
    raw = torch_op("_linalg_" + name).fcompute(dict(params), *xs)
    outs = _sign_free(name, raw)
    grads = torch.autograd.grad(outs, xs, [torch.from_numpy(c)
                                           for c in cots])
    return ([o.detach().numpy() for o in raw], [g.numpy() for g in grads])


def _align_rows(got, want):
    """``got``'s rows with the sign of ``want``'s (eigenvectors)."""
    sign = np.sign((got * want).sum(-1, keepdims=True))
    return got * np.where(sign == 0, 1, sign)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(CASES)])
def test_op_matches_jax(case):
    name, params, inputs = CASES[case]
    outs = torch_op("_linalg_" + name).fcompute(
        dict(params), *[torch.from_numpy(x) for x in inputs])
    rng = _rng(100 + case)
    cots = [_rand(rng, *o.shape) for o in outs]
    want, want_g = _jax(name, params, inputs, cots)
    got, got_g = _torch(name, params, inputs, cots)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        if name == "syevd" and k == 0:
            a = _align_rows(a, b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL,
                                   err_msg="%s output %d" % (name, k))
    for k, (a, b) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg="%s gradient %d" % (name, k))


def test_potrf_of_a_matrix_that_is_not_positive_definite_reads_nan():
    a = np.stack([2 * np.eye(3), [[1, 2, 0], [2, 1, 0], [0, 0, 1]]]) \
        .astype(np.float32)
    (want,) = jax_op("_linalg_potrf").fcompute({}, jnp.asarray(a))
    got = mxt.nd.linalg.potrf(mxt.nd.array(a, ctx=mxt.cpu())).asnumpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(np.asarray(want)))
    assert np.isnan(got[1]).any() and not np.isnan(got[0]).any()
    np.testing.assert_allclose(got[0], np.asarray(want)[0], rtol=RTOL)


def test_namespaces_and_aliases():
    assert sorted(mxt.nd.linalg.__all__) == sorted(mx.nd.linalg.__all__) \
        == sorted(OPS)
    assert sorted(mxt.sym.linalg.__all__) == sorted(mx.sym.linalg.__all__)
    x = mxt.nd.array(_spd(_rng(1)), ctx=mxt.cpu())
    for name in OPS:
        assert torch_op("linalg_" + name) is torch_op("_linalg_" + name)
        assert hasattr(mxt.nd, "linalg_" + name)
        assert hasattr(mxt.sym, "_linalg_" + name)
    np.testing.assert_array_equal(mxt.nd.linalg_inverse(x).asnumpy(),
                                  mxt.nd.linalg.inverse(x).asnumpy())


def test_symbol_shapes_and_executor():
    """A ``sym.linalg`` graph (a Gaussian log-likelihood's pieces) infers
    its shapes and runs in an executor on the CPU as the nd calls do."""
    a = mxt.sym.var("a")
    b = mxt.sym.var("b")
    L = mxt.sym.linalg.potrf(a)
    out = mxt.sym.Group([mxt.sym.linalg.sumlogdiag(L),
                         mxt.sym.linalg.trsm(L, b)])
    _, shapes, _ = out.infer_shape(a=(2, 4, 4), b=(2, 4, 3))
    assert shapes == [(2,), (2, 4, 3)]
    rng = _rng(2)
    av, bv = _spd(rng), _rand(rng, 2, 4, 3)
    ex = out.bind(mxt.cpu(), {"a": mxt.nd.array(av, ctx=mxt.cpu()),
                              "b": mxt.nd.array(bv, ctx=mxt.cpu())})
    got = [o.asnumpy() for o in ex.forward()]
    Lv = mxt.nd.linalg.potrf(mxt.nd.array(av, ctx=mxt.cpu()))
    np.testing.assert_array_equal(got[0],
                                  mxt.nd.linalg.sumlogdiag(Lv).asnumpy())
    np.testing.assert_allclose(got[0], np.linalg.slogdet(av)[1] / 2,
                               rtol=1e-5)
