"""The rest of `mxnet_tpu/ops/compat_ops.py` on the port, against the JAX
ops, on the CPU.

The fourteen names this slice adds (``_copyto``, ``_CrossDeviceCopy``,
``_grad_add``, ``_slice_assign``/``_crop_assign``,
``_slice_assign_scalar``/``_crop_assign_scalar``,
``_image_to_tensor``/``image_to_tensor``,
``_image_normalize``/``image_normalize``, ``_sample_negative_binomial``,
``_sample_generalized_negative_binomial``, ``IdentityAttachKLSparseReg``)
go through the JAX op's ``fcompute`` and ``jax.vjp`` and through the
port's ``fcompute`` and the tape on the same numpy inputs: outputs and
input gradients at rtol 1e-6, atol 1e-6 (f32 on both sides; the ops copy,
add, scale or select). The two samplers draw from different generators,
so they are held by their moments: over 2^16 draws per parameter the mean
and variance lie within 4 standard errors of the formulas (the
variance's standard error from the sample's fourth central moment). No
op of the JAX file is left unregistered.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch.ops.registry import _OPS, get_op
from torch_parity import jax_ops_of

TOL = 1e-6
NEW = ["_copyto", "_CrossDeviceCopy", "_grad_add", "_slice_assign",
       "_crop_assign", "_slice_assign_scalar", "_crop_assign_scalar",
       "_image_to_tensor", "image_to_tensor", "_image_normalize",
       "image_normalize", "_sample_negative_binomial",
       "_sample_generalized_negative_binomial", "IdentityAttachKLSparseReg"]


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CASES = [
    ("_copyto", {}, [_x(3, 4)]),
    ("_CrossDeviceCopy", {}, [_x(2, 5)]),
    ("_grad_add", {}, [_x(3, 4), _x(3, 4, seed=1)]),
    ("_slice_assign", {"begin": (1, 0), "end": (3, 6), "step": (1, 2)},
     [_x(4, 6), _x(2, 3, seed=1)]),
    ("_crop_assign", {"begin": (-3, None), "end": (None, -1)},
     [_x(4, 6), _x(3, 5, seed=1)]),
    ("_slice_assign", {"begin": (3, 5), "end": (0, None),
                       "step": (-1, -2)},
     [_x(4, 6), _x(3, 3, seed=1)]),
    ("_slice_assign", {"begin": (1,), "end": (3,)},
     [_x(4, 2, 3), _x(1, 3, seed=1)]),
    ("_slice_assign_scalar", {"begin": (0, 1), "end": (2, 5),
                              "scalar": 2.5}, [_x(3, 6)]),
    ("_crop_assign_scalar", {"begin": (None, -2), "end": (None, None),
                             "step": (2, 1)}, [_x(5, 4)]),
    ("_slice_assign_scalar", {"begin": (2,), "end": (0,), "step": (-1,),
                              "scalar": -1.0}, [_x(4, 3)]),
    ("_image_to_tensor", {}, [np.random.RandomState(0).randint(
        0, 256, (4, 5, 3)).astype(np.uint8)]),
    ("image_to_tensor", {}, [np.random.RandomState(1).uniform(
        0, 255, (2, 4, 5, 3)).astype(np.float32)]),
    ("_image_normalize", {"mean": (0.4, 0.5, 0.6), "std": (0.2, 0.3, 0.5)},
     [_x(3, 4, 5)]),
    ("image_normalize", {"mean": (0.1, 0.2), "std": (2.0, 0.5)},
     [_x(2, 2, 3, 3)]),
    ("IdentityAttachKLSparseReg", {"_is_train": True,
                                   "sparseness_target": 0.2,
                                   "penalty": 0.01, "momentum": 0.8},
     [np.random.RandomState(2).uniform(0.05, 0.95, (6, 5)).astype(
         np.float32), np.full(5, 0.3, np.float32)]),
    ("IdentityAttachKLSparseReg", {"_is_train": False},
     [np.random.RandomState(3).uniform(0.05, 0.95, (4, 3)).astype(
         np.float32), np.full(3, 0.5, np.float32)]),
]


def _differentiable(x):
    return x.dtype == np.float32


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(CASES)])
def test_op_matches_jax(case):
    name, params, inputs = CASES[case]
    n_out = get_op(name).n_out(params)
    xs = [torch.from_numpy(x.copy()) for x in inputs]
    # the moving average (IdentityAttachKLSparseReg's aux) takes no grad
    wrt = [k for k, x in enumerate(inputs) if _differentiable(x)
           and not (name == "IdentityAttachKLSparseReg" and k == 1)]
    for k in wrt:
        xs[k].requires_grad_()
    got = get_op(name).fcompute(dict(params), *xs)
    want = jax_op(name).fcompute(dict(params),
                                 *[jnp.asarray(x) for x in inputs])
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.shape == b.shape and str(a.dtype)[6:] == str(b.dtype), k
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=TOL,
                                   atol=TOL, err_msg="%s output %d"
                                   % (name, k))
    if not wrt:
        return
    cots = [_x(*o.shape, seed=50 + i) for i, o in enumerate(got[:n_out])]
    grads = torch.autograd.grad(got[:n_out], [xs[k] for k in wrt],
                                [torch.from_numpy(c) for c in cots])

    def f(*diff):
        full = [jnp.asarray(x) for x in inputs]
        for k, d in zip(wrt, diff):
            full[k] = d
        return tuple(jax_op(name).fcompute(dict(params), *full)[:n_out])
    _, vjp = jax.vjp(f, *[jnp.asarray(inputs[k]) for k in wrt])
    want_g = vjp(tuple(jnp.asarray(c) for c in cots))
    for k, (a, b) in enumerate(zip(grads, want_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg="%s gradient %d"
                                   % (name, k))


def _moments_ok(draws, mean, var):
    """Sample mean and variance of each row within 4 standard errors of
    ``mean`` and ``var``."""
    n = draws.shape[-1]
    m = draws.mean(-1)
    v = draws.var(-1)
    m4 = ((draws - m[..., None]) ** 4).mean(-1)
    se_m = np.sqrt(var / n)
    se_v = np.sqrt((m4 - v ** 2) / n)
    return (np.abs(m - mean) <= 4 * se_m).all() and \
        (np.abs(v - var) <= 4 * se_v).all(), (m, v, mean, var)


N_DRAWS = 1 << 16


def test_negative_binomial_sampler_moments_and_shape():
    k = np.array([1.0, 3.0, 8.0], np.float32)
    p = np.array([0.3, 0.5, 0.8], np.float32)
    mxt.random.seed(7)
    out = mxt.nd._sample_negative_binomial(
        mxt.nd.array(k, ctx=mxt.cpu()), mxt.nd.array(p, ctx=mxt.cpu()),
        shape=(N_DRAWS,))
    (want,) = jax_op("_sample_negative_binomial").fcompute(
        {"shape": (4,), "_rng_key": jax.random.PRNGKey(0)},
        jnp.asarray(k), jnp.asarray(p))
    assert out.shape == (3, N_DRAWS) and want.shape == (3, 4)
    assert out.dtype == np.asarray(want).dtype == np.float32
    d = out.asnumpy().astype(np.float64)
    ok, readings = _moments_ok(d, k * (1 - p) / p, k * (1 - p) / p ** 2)
    assert ok, readings


def test_generalized_negative_binomial_sampler_moments_and_shape():
    mu = np.array([[2.0, 5.0], [0.5, 10.0]], np.float32)
    alpha = np.array([[0.5, 0.0], [2.0, 0.1]], np.float32)
    mxt.random.seed(8)
    out = mxt.nd._sample_generalized_negative_binomial(
        mxt.nd.array(mu, ctx=mxt.cpu()), mxt.nd.array(alpha, ctx=mxt.cpu()),
        shape=N_DRAWS, dtype="float32")
    (want,) = jax_op("_sample_generalized_negative_binomial").fcompute(
        {"shape": 3, "_rng_key": jax.random.PRNGKey(0)}, jnp.asarray(mu),
        jnp.asarray(alpha))
    assert out.shape == (2, 2, N_DRAWS) and want.shape == (2, 2, 3)
    d = out.asnumpy().astype(np.float64)
    ok, readings = _moments_ok(d, mu, mu + alpha * mu ** 2)
    assert ok, readings
    # alpha = 0 is Poisson(mu): mean equals variance
    assert abs(d[0, 1].mean() - 5.0) < 4 * np.sqrt(5.0 / N_DRAWS)


def test_samplers_draw_from_the_op_generator():
    """Seeded twice, the same draws; the op declares its draws."""
    k = mxt.nd.array(np.array([2.0], np.float32), ctx=mxt.cpu())
    p = mxt.nd.array(np.array([0.4], np.float32), ctx=mxt.cpu())
    runs = []
    for _ in range(2):
        mxt.random.seed(3)
        runs.append(mxt.nd._sample_negative_binomial(
            k, p, shape=(64,)).asnumpy())
    np.testing.assert_array_equal(runs[0], runs[1])
    assert get_op("_sample_negative_binomial").need_rng
    assert get_op("_sample_generalized_negative_binomial").need_rng


def test_kl_sparse_reg_steps_its_aux_through_nd():
    """In training the moving average is written back; outside it stays."""
    data = mxt.nd.array(np.full((4, 3), 0.6, np.float32), ctx=mxt.cpu())
    avg = mxt.nd.array(np.full(3, 0.2, np.float32), ctx=mxt.cpu())
    with mxt.autograd.record(train_mode=True):
        out = mxt.nd.IdentityAttachKLSparseReg(data, avg, momentum=0.5)
    np.testing.assert_allclose(avg.asnumpy(), 0.4, rtol=1e-6)
    np.testing.assert_array_equal(out.asnumpy(), data.asnumpy())
    mxt.nd.IdentityAttachKLSparseReg(data, avg, momentum=0.5)
    np.testing.assert_allclose(avg.asnumpy(), 0.4, rtol=1e-6)


def test_every_op_of_jax_compat_ops_is_registered():
    names = jax_ops_of("compat_ops.py")
    assert sorted(names - set(_OPS)) == []
    assert set(NEW) <= names
    for a, b in (("_crop_assign", "_slice_assign"),
                 ("_crop_assign_scalar", "_slice_assign_scalar"),
                 ("image_to_tensor", "_image_to_tensor"),
                 ("image_normalize", "_image_normalize")):
        assert get_op(a) is get_op(b)
    for name in NEW:
        assert hasattr(mxt.nd, name) and hasattr(mxt.sym, name), name
