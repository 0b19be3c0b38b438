"""The port's optimizer and initializers against the JAX package's.

Optimizer: the same weights, gradients and hyperparameters (numpy, from
a seed) go through the JAX package's update ops and ``SGD`` +
``Updater`` and through the port's, for several steps. Both compute in
f32 in the same order (rescale, clip, weight decay), so the tolerance is
f32 rounding: 1e-6. Initializers: under one ``np.random`` seed both
packages draw the same numbers in the same order, so parameters must be
bit-identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ops.optimizer_ops import sgd_mom_update, sgd_update

TOL = 1e-6


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kw", [
    {"lr": 0.1},
    {"lr": 0.5, "wd": 0.01, "rescale_grad": 0.25},
    {"lr": 1.0, "clip_gradient": 0.25, "rescale_grad": 1 / 35},
    {"lr": 0.3, "wd": 0.1, "clip_gradient": 0.5, "rescale_grad": 2.0},
], ids=str)
def test_sgd_update_matches_jax(kw):
    rng = np.random.RandomState(0)
    w, g = _rand(rng, 7, 5), _rand(rng, 7, 5, scale=3.0)
    (want,) = jax_get_op("sgd_update").fcompute(dict(kw), jnp.asarray(w),
                                                jnp.asarray(g))
    got = torch.from_numpy(w.copy())
    assert sgd_update(got, torch.from_numpy(g), **kw) is got
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("kw", [
    {"lr": 0.1, "momentum": 0.9},
    {"lr": 1.0, "momentum": 0.5, "wd": 0.01, "clip_gradient": 0.25,
     "rescale_grad": 0.1},
], ids=str)
def test_sgd_mom_update_matches_jax(kw):
    rng = np.random.RandomState(1)
    w, g, m = _rand(rng, 4, 6), _rand(rng, 4, 6), _rand(rng, 4, 6)
    want_w, want_m = jax_get_op("sgd_mom_update").fcompute(
        dict(kw), jnp.asarray(w), jnp.asarray(g), jnp.asarray(m))
    got_w, got_m = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    sgd_mom_update(got_w, torch.from_numpy(g), got_m, **kw)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=TOL,
                               atol=TOL)


NAMES = ["fc1_weight", "fc1_bias", "lstm_parameters"]


def _symbol(pkg):
    """A symbol whose fc1_weight carries lr and wd multipliers."""
    data = pkg.sym.var("data")
    w = pkg.sym.var("fc1_weight", lr_mult=0.5, wd_mult=2.0)
    return pkg.sym.FullyConnected(data, w, num_hidden=3, name="fc1")


@pytest.mark.parametrize("opt_kw", [
    {"learning_rate": 0.5, "wd": 0.01},
    {"learning_rate": 1.0, "clip_gradient": 0.25, "rescale_grad": 1 / 35},
    {"learning_rate": 0.2, "momentum": 0.9, "wd": 0.05,
     "clip_gradient": 1.0, "rescale_grad": 0.5},
], ids=str)
@pytest.mark.parametrize("mults", ["none", "set", "symbol"])
def test_sgd_updater_matches_jax(opt_kw, mults):
    rng = np.random.RandomState(2)
    shapes = [(3, 4), (3,), (10,)]
    weights = [_rand(rng, *s) for s in shapes]
    grads = [[_rand(rng, *s, scale=2.0) for s in shapes] for _ in range(3)]
    idx2name = dict(enumerate(NAMES))
    finals = []
    for pkg in (mx, mxt):
        kw = dict(opt_kw, param_idx2name=idx2name)
        if mults == "symbol":
            kw["sym"] = _symbol(pkg)
        opt = pkg.optimizer.create("sgd", **kw)
        if mults == "set":
            opt.set_lr_mult({"fc1_bias": 3.0, 2: 0.1})
            opt.set_wd_mult({"lstm_parameters": 0.5})
        elif mults == "symbol":
            opt.set_lr_mult({})
            opt.set_wd_mult({})
        updater = pkg.optimizer.get_updater(opt)
        ws = [pkg.nd.array(w) for w in weights]
        for step in grads:
            for i, g in enumerate(step):
                updater(i, pkg.nd.array(g), ws[i])
        assert opt.num_update == len(grads)
        finals.append([w.asnumpy() for w in ws])
    for want, got, name in zip(*finals, NAMES):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_optimizer_registry_and_errors():
    opt = mxt.optimizer.create("SGD", learning_rate=0.3)
    assert isinstance(opt, mxt.optimizer.SGD) and opt.learning_rate == 0.3
    assert mxt.optimizer.create(opt) is opt
    with pytest.raises(ValueError):
        mxt.optimizer.create("no_such_optimizer")
    with pytest.raises(mxt.MXNetError, match="multi_precision"):
        mxt.optimizer.SGD(multi_precision=True)

    @mxt.optimizer.register
    class Halver(mxt.optimizer.Optimizer):
        def update(self, index, weight, grad, state):
            weight[:] = weight.asnumpy() / 2

    w = mxt.nd.array(np.ones(3))
    mxt.optimizer.get_updater(mxt.optimizer.create("halver"))(0, None, w)
    np.testing.assert_array_equal(w.asnumpy(), 0.5)


def test_lr_scheduler_hook():
    class Step:
        base_lr = None

        def __call__(self, num_update):
            return self.base_lr * (0.1 if num_update >= 2 else 1.0)

    opt = mxt.optimizer.SGD(learning_rate=1.0, lr_scheduler=Step())
    w = mxt.nd.array(np.zeros(2))
    upd = mxt.optimizer.get_updater(opt)
    for _ in range(2):
        upd(0, mxt.nd.array(np.ones(2)), w)
    # step 1 at lr 1, step 2 at lr 0.1 (num_update is 2 by then)
    np.testing.assert_allclose(w.asnumpy(), -1.1, rtol=TOL)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
INIT_CASES = [
    ("Xavier", {}, "fc_weight", (20, 30)),
    ("Xavier", {"rnd_type": "gaussian", "factor_type": "in",
                "magnitude": 2}, "conv_weight", (8, 3, 3, 3)),
    ("Xavier", {"factor_type": "out"}, "embed_weight", (50, 16)),
    ("Uniform", {"scale": 0.2}, "fc_weight", (7, 9)),
    ("Normal", {"sigma": 0.5}, "fc_weight", (7, 9)),
    ("Constant", {"value": 0.25}, "fc_weight", (3, 3)),
    ("One", {}, "fc_weight", (4,)),
    ("Zero", {}, "fc_weight", (4,)),
]


def _init_both(name, kwargs, pname, shape, seed):
    out = []
    for pkg in (mx, mxt):
        arr = pkg.nd.zeros(shape)
        arr[:] = 7.0       # every name must overwrite the whole array
        np.random.seed(seed)
        pkg.init.create(name.lower(), **kwargs)(
            pkg.init.InitDesc(pname), arr)
        out.append(arr.asnumpy())
    return out


@pytest.mark.parametrize("case", INIT_CASES, ids=lambda c: "%s-%s" % c[:2])
def test_initializers_are_bit_identical(case):
    want, got = _init_both(*case, seed=3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pname,shape", [
    ("fc_bias", (5,)), ("bn_gamma", (5,)), ("bn_beta", (5,)),
    ("bn_moving_mean", (5,)), ("bn_moving_var", (5,)),
    ("lstm_parameters", (96,)), ("lstm_state", (2, 3, 4)),
    ("lstm_state_cell", (2, 3, 4)), ("q_min", (1,)), ("q_max", (1,)),
])
def test_name_dispatch_is_bit_identical(pname, shape):
    want, got = _init_both("Xavier", {}, pname, shape, seed=4)
    np.testing.assert_array_equal(got, want)


def test_init_attr_and_unknown_names():
    desc = mxt.init.InitDesc("w", attrs={
        "__init__": mxt.init.Uniform(0.5).dumps()})
    arr = mxt.nd.zeros((40,))
    np.random.seed(5)
    mxt.init.Xavier()(desc, arr)
    np.random.seed(5)
    want = np.random.uniform(-0.5, 0.5, (40,)).astype(np.float32)
    np.testing.assert_array_equal(arr.asnumpy(), want)
    with pytest.raises(ValueError, match="Unknown initialization"):
        mxt.init.Xavier()(mxt.init.InitDesc("mystery"), mxt.nd.zeros((2,)))
    with pytest.raises(ValueError, match="2D"):
        mxt.init.Xavier()(mxt.init.InitDesc("v_weight"), mxt.nd.zeros((3,)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mults", ["none", "set"])
def test_sgd_momentum_updater_dtypes_match_jax(dtype, mults):
    """The ``Updater`` with SGD momentum and no clipping (the ResNet
    benchmark's optimizer, which ``Module.update`` applies weight by
    weight) against the JAX package's updater, over 3 steps, on f32 and
    on bf16 weights with f32 momenta. bf16 weights are rounded once per
    step on both sides, from f32 values that may differ in their last
    bit: one bf16 step, 2^-7 relative."""
    rng = np.random.RandomState(3)
    shapes = [(3, 4), (3,), (10,)]
    weights = [_rand(rng, *s) for s in shapes]
    grads = [[_rand(rng, *s, scale=2.0) for s in shapes] for _ in range(3)]
    opt_kw = {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01,
              "rescale_grad": 0.25, "param_idx2name": dict(enumerate(NAMES))}
    finals = []
    for pkg in (mx, mxt):
        opt = pkg.optimizer.create("sgd", **opt_kw)
        if mults == "set":
            opt.set_lr_mult({"fc1_bias": 3.0, 2: 0.1})
            opt.set_wd_mult({"lstm_parameters": 0.5})
        updater = pkg.optimizer.get_updater(opt)
        ws = [pkg.nd.array(w, dtype=dtype) for w in weights]
        for step in grads:
            for i, g in enumerate(step):
                updater(i, pkg.nd.array(g, dtype=dtype), ws[i])
        assert opt.num_update == len(grads)
        finals.append([np.asarray(w.asnumpy() if pkg is mx else
                                  w.data.float().numpy(), np.float32)
                       for w in ws])
    tol = TOL if dtype == "float32" else 2.0 ** -7
    for want, got, name in zip(*finals, NAMES):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=name)
