"""The port's optimizer layer and initializers against the JAX package's.

Optimizer: the same weights, gradients and hyperparameters (numpy, from
a seed) go through the JAX package's update ops and ``Updater`` and
through the port's, for several steps: every optimizer class (the port
through ``FusedApplier``, its one update path, here on its plain path),
bf16 weights with and without ``multi_precision``, the eleven registered
update ops through ``nd``, state files across packages, and a ``Trainer``
and a ``Module`` with Adam. Both compute in f32 in the same order
(rescale, clip, weight decay); the tolerance is f32 rounding (1e-6 for
one op, rtol 1e-5 / atol 1e-6 over three updates) and one bf16 step for
bf16 weights. The port's ``FusedApplier`` equals its own per-index
``Updater`` bit for bit. Initializers: under one ``np.random`` seed both
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
    assert set(mxt.optimizer.Optimizer.opt_registry) >= \
        set(mx.optimizer.Optimizer.opt_registry)
    # multi_precision keeps an f32 master copy of a bf16 weight
    mp = mxt.optimizer.SGD(multi_precision=True, momentum=0.9)
    master, mom = mp.create_state_multi_precision(
        0, mxt.nd.ones((3,), dtype="bfloat16"))
    assert master.data.dtype == mom.data.dtype == torch.float32

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


# ---------------------------------------------------------------------------
# every optimizer through FusedApplier, the registered ops, state files
# ---------------------------------------------------------------------------
BF16_STEP = 2.0 ** -7      # one bf16 step, relative
OPT_TOL = {"rtol": 1e-5, "atol": 1e-6}   # test_pallas.py's LSTM tolerance
SHAPES = [(3, 4), (3,), (10,)]
#: (optimizer, its hyperparameters) for every class of the JAX package
OPTIMIZERS = [
    ("sgd", {"momentum": 0.0}),
    ("sgd", {"momentum": 0.9}),
    ("nag", {"momentum": 0.9}),
    ("signum", {"momentum": 0.9, "wd_lh": 0.01}),
    ("adam", {"beta1": 0.8, "beta2": 0.99}),
    ("adagrad", {"eps": 1e-6}),
    ("adadelta", {"rho": 0.8}),
    ("rmsprop", {"gamma1": 0.8}),
    ("rmsprop", {"gamma1": 0.8, "gamma2": 0.7, "centered": True}),
    ("ftrl", {"lamda1": 0.02, "beta": 0.5}),
    ("ftml", {"beta1": 0.5}),
    ("dcasgd", {"momentum": 0.9, "lamda": 0.1}),
    ("sgld", {}),
    ("lbsgd", {"momentum": 0.9}),
    ("test", {}),
]


def _weights_grads(seed, dtype="float32"):
    rng = np.random.RandomState(seed)
    weights = [_rand(rng, *s) for s in SHAPES]
    grads = [[_rand(rng, *s, scale=2.0) for s in SHAPES] for _ in range(3)]
    return weights, grads


def _values(pkg, arr):
    """f32 numpy values of an NDArray of either package (bf16 widened)."""
    if pkg is mxt:
        return arr.data.float().numpy()
    return np.asarray(arr.asnumpy(), np.float32)


def _no_noise(monkeypatch):
    """SGLD's noise in both packages as zeros: the two draw from different
    generators, so the deterministic part is what can be compared."""
    for mod in (mx.nd.random, mxt.nd.random):
        pkg = mxt if mod is mxt.nd.random else mx
        monkeypatch.setattr(mod, "normal", lambda loc, scale, shape, ctx,
                            dtype, _pkg=pkg: _pkg.nd.zeros(shape))


def _train(pkg, name, kw, weights, grads, dtype="float32", fused=True,
           mults=True):
    """3 steps of every index; the port through its FusedApplier (or its
    per-index Updater), the JAX package through its Updater."""
    opt = pkg.optimizer.create(name, param_idx2name=dict(enumerate(NAMES)),
                               **kw)
    if mults:
        opt.set_lr_mult({"fc1_bias": 3.0, 2: 0.1})
        opt.set_wd_mult({"lstm_parameters": 0.5, 0: 2.0})
    updater = pkg.optimizer.get_updater(opt)
    ws = [pkg.nd.array(w, dtype=dtype) for w in weights]
    apply = pkg.optimizer.FusedApplier.resolve(updater) \
        if pkg is mxt and fused else None
    for step in grads:
        gs = [pkg.nd.array(g, dtype=dtype) for g in step]
        if apply is not None:
            apply(list(range(len(ws))), ws, gs)
        else:
            for i, g in enumerate(gs):
                updater(i, g, ws[i])
    return [_values(pkg, w) for w in ws], updater


@pytest.mark.parametrize("clip", [None, 0.6], ids=["noclip", "clip"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=lambda v: str(v))
def test_every_optimizer_matches_jax(monkeypatch, name, kw, clip):
    """Each optimizer class, 3 updates from the same weights and
    gradients, ``lr_mult``/``wd_mult`` by name and by index, ``wd``,
    ``rescale_grad`` != 1, clipping on and off: the JAX ``Updater``
    against the port's ``FusedApplier`` (on the CPU its plain path)."""
    _no_noise(monkeypatch)
    weights, grads = _weights_grads(7)
    kw = dict(kw, learning_rate=0.05, wd=0.01, rescale_grad=0.5,
              clip_gradient=clip)
    want, _ = _train(mx, name, kw, weights, grads)
    got, _ = _train(mxt, name, kw, weights, grads)
    for a, b, n in zip(got, want, NAMES):
        np.testing.assert_allclose(a, b, err_msg=n, **OPT_TOL)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"momentum": 0.0, "multi_precision": True}),
    ("sgd", {"momentum": 0.9, "multi_precision": True}),
    ("sgd", {"momentum": 0.0}),
    ("sgd", {"momentum": 0.9}),
    ("adam", {}),
    ("adam", {"multi_precision": True}),
], ids=str)
def test_bf16_weights_match_jax(name, kw):
    """bf16 weights: SGD with and without momentum under
    ``multi_precision`` (an f32 master copy; the JAX package's per-index
    ``mp_sgd*``) and without it (on the bf16 weight itself), Adam on the
    bf16 weight and over a master copy. Both round one f32 value to bf16
    a step, from f32 values that may differ in the last bit: one bf16 step
    apart at most."""
    weights, grads = _weights_grads(8)
    kw = dict(kw, learning_rate=0.05, wd=0.01, rescale_grad=0.5,
              clip_gradient=1.0)
    want, jax_upd = _train(mx, name, kw, weights, grads, dtype="bfloat16")
    got, upd = _train(mxt, name, kw, weights, grads, dtype="bfloat16")
    for a, b, n in zip(got, want, NAMES):
        np.testing.assert_allclose(a, b, rtol=BF16_STEP, atol=1e-6,
                                   err_msg=n)
    if kw.get("multi_precision"):
        for i in range(len(SHAPES)):      # the f32 master copies
            master = upd.states[i][0]
            assert master.data.dtype == torch.float32
            np.testing.assert_allclose(master.asnumpy(),
                                       jax_upd.states[i][0].asnumpy(),
                                       **OPT_TOL)


@pytest.mark.parametrize("mults", [False, True])
@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9, "clip_gradient": 0.5}),
    ("adam", {"clip_gradient": 0.5}), ("rmsprop", {}),
], ids=str)
def test_fused_applier_equals_its_updater(name, kw, mults):
    """The port's FusedApplier against its own per-index Updater, bit for
    bit, with the update counts moved once a call."""
    weights, grads = _weights_grads(9)
    kw = dict(kw, learning_rate=0.05, wd=0.01, rescale_grad=0.5)
    fused, upd = _train(mxt, name, kw, weights, grads, mults=mults)
    plain, ref = _train(mxt, name, kw, weights, grads, fused=False,
                        mults=mults)
    for a, b, n in zip(fused, plain, NAMES):
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert upd.optimizer._index_update_count == \
        ref.optimizer._index_update_count == {0: 3, 1: 3, 2: 3}
    assert upd.optimizer.num_update == 3


def test_fused_applier_groups_and_surface():
    """Formulas by state and dtype; one plain call a (formula, dtype)
    group; ``update_op`` and ``commit_states``; ``resolve`` refuses what
    is not an Updater."""
    opt = mxt.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                            multi_precision=True)
    upd = mxt.optimizer.get_updater(opt)
    fused = mxt.optimizer.FusedApplier.resolve(upd)
    assert mxt.optimizer.FusedApplier.supports(opt)
    assert not mxt.optimizer.FusedApplier.supports(
        mxt.optimizer.NAG(momentum=0.9))
    ws = [mxt.nd.ones((4,), dtype="float32"),
          mxt.nd.ones((4,), dtype="bfloat16")]
    gs = [mxt.nd.ones((4,), dtype=w.data.dtype) for w in ws]
    fused([0, 1], ws, gs)
    assert [fused.formula(w, upd.states[i]) for i, w in enumerate(ws)] == \
        ["sgd_mom", "mp_sgd_mom"]
    name, fcompute, static = fused.update_op()
    assert name == "sgd_mom_update" and static["momentum"] == 0.9
    assert fcompute is mxt.ops.registry.get_op(name).fcompute
    fused.commit_states([0], [(torch.full((4,), 2.0),)])
    np.testing.assert_array_equal(upd.states[0].asnumpy(), 2.0)
    with pytest.raises(mxt.MXNetError, match="Updater"):
        mxt.optimizer.FusedApplier.resolve(opt)


def test_sgld_noise_has_the_right_scale():
    """SGLD adds N(0, lr) noise (the comparison above zeroes it)."""
    mxt.random.seed(3)
    opt = mxt.optimizer.SGLD(learning_rate=0.04)
    w = mxt.nd.zeros((20000,))
    mxt.optimizer.get_updater(opt)(0, mxt.nd.zeros((20000,)), w)
    assert abs(float(w.asnumpy().std()) - 0.2) < 0.01


# the registered update ops: inputs (weight, grad, states) and attributes
OPS = [
    ("sgd_update", 0, {"lr": 0.1, "wd": 0.01}),
    ("sgd_mom_update", 1, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("mp_sgd_update", 1, {"lr": 0.1, "wd": 0.01}),
    ("mp_sgd_mom_update", 2, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam_update", 2, {"lr": 0.01, "beta1": 0.8, "beta2": 0.9,
                        "wd": 0.01}),
    ("rmsprop_update", 1, {"lr": 0.01, "gamma1": 0.8}),
    ("rmspropalex_update", 3, {"lr": 0.01, "gamma1": 0.8, "gamma2": 0.7}),
    ("ftrl_update", 2, {"lr": 0.1, "lamda1": 0.05, "beta": 0.5,
                        "wd": 0.01}),
    ("signsgd_update", 0, {"lr": 0.1, "wd": 0.01}),
    ("signum_update", 1, {"lr": 0.1, "momentum": 0.9, "wd_lh": 0.01}),
    ("ftml_update", 3, {"lr": 0.1, "beta1": 0.6, "t": 2, "wd": 0.01}),
]


@pytest.mark.parametrize("name,n_states,attrs", OPS, ids=lambda v: str(v))
def test_registered_update_op_matches_jax(name, n_states, attrs):
    """``nd.<op>(w, g, *states, out=w, **attrs)`` in both packages, with
    clipping and rescale: the weight and every state. States are
    positive where an op takes their square root."""
    rng = np.random.RandomState(10)
    w, g = _rand(rng, 5, 6), _rand(rng, 5, 6, scale=3.0)
    states = [np.abs(_rand(rng, 5, 6)) + 0.5 for _ in range(n_states)]
    attrs = dict(attrs, rescale_grad=0.5, clip_gradient=1.0)
    out = []
    for pkg in (mx, mxt):
        arrs = [pkg.nd.array(v) for v in [w, g] + states]
        res = getattr(pkg.nd, name)(*arrs, out=arrs[0], **attrs)
        assert res is arrs[0]
        out.append([a.asnumpy() for a in arrs[:1] + arrs[2:]])
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, **OPT_TOL)
    # without out= the op returns the new weight and leaves w alone
    arrs = [mxt.nd.array(v) for v in [w, g] + states]
    new = getattr(mxt.nd, name)(*arrs, **attrs)
    np.testing.assert_array_equal(arrs[0].asnumpy(), w)
    np.testing.assert_allclose(new.asnumpy(), out[0][0], **OPT_TOL)


def _trained_updater(pkg, name="adam", mp=False):
    weights, grads = _weights_grads(11)
    kw = {"learning_rate": 0.05, "momentum": 0.9} if name == "sgd" else \
        {"learning_rate": 0.05}
    _, upd = _train(pkg, name, dict(kw, multi_precision=mp), weights,
                    grads, dtype="bfloat16" if mp else "float32")
    return upd


@pytest.mark.parametrize("name,mp", [("adam", False), ("sgd", False),
                                     ("sgd", True)])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_states_cross_packages(name, mp, direction):
    """``get_states()`` of one package read by the other's
    ``set_states``: the same arrays, tuples and Nones."""
    src, dst = (mx, mxt) if direction == "jax_to_torch" else (mxt, mx)
    blob = _trained_updater(src, name, mp).get_states()
    upd = dst.optimizer.get_updater(dst.optimizer.create(name))
    upd.set_states(blob)
    want = _trained_updater(src, name, mp).states
    assert sorted(upd.states) == sorted(want)
    for i in want:
        a = want[i] if isinstance(want[i], tuple) else (want[i],)
        b = upd.states[i] if isinstance(upd.states[i], tuple) \
            else (upd.states[i],)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())


@pytest.mark.parametrize("pkg", [mx, mxt], ids=["jax", "torch"])
def test_states_round_trip_with_the_optimizer(pkg):
    """Each package reads its own ``dump_optimizer=True`` file back: the
    states and the optimizer with its update counts."""
    upd = _trained_updater(pkg)
    other = pkg.optimizer.get_updater(pkg.optimizer.create("sgd"))
    other.set_states(upd.get_states(dump_optimizer=True))
    assert type(other.optimizer).__name__ == "Adam"
    assert other.optimizer._index_update_count == {0: 3, 1: 3, 2: 3}
    for i, (m, v) in upd.states.items():
        np.testing.assert_array_equal(other.states[i][0].asnumpy(),
                                      m.asnumpy())
        np.testing.assert_array_equal(other.states[i][1].asnumpy(),
                                      v.asnumpy())


# ---------------------------------------------------------------------------
# Trainer and Module through the one update path, and their state files
# ---------------------------------------------------------------------------
@pytest.fixture
def _plain_jit(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=4),
                pkg.gluon.nn.Dense(3, in_units=8))
    with pkg.cpu():
        net.initialize(pkg.init.Xavier())
    return net


def _copy_params(src, dst):
    for (_, a), (_, b) in zip(sorted(src.collect_params().items()),
                              sorted(dst.collect_params().items())):
        b.set_data(mxt.nd.array(a.data().asnumpy(), ctx=mxt.cpu()))


def _gluon_data():
    rng = np.random.RandomState(0)
    return [(rng.randn(6, 4).astype("f"), rng.randint(0, 3, 6).astype("f"))
            for _ in range(3)]


def _gluon_steps(pkg, net, trainer):
    """The three batches of ``_gluon_data``, one step each."""
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in _gluon_data():
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x, ctx=pkg.cpu())),
                           pkg.nd.array(y, ctx=pkg.cpu()))
        loss.backward()
        trainer.step(6)
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


ADAM = {"learning_rate": 0.01, "wd": 1e-4}


def test_trainer_adam_and_its_state_file(tmp_path, _plain_jit):
    """2 + 1 Adam steps of a small MLP: the JAX Trainer against the
    port's (uninterrupted, 1e-5); and in the port, 2 steps, save_states,
    a fresh Trainer that loads them, and a third step bit-identical to the
    uninterrupted one (the file carries the optimizer's update counts,
    which Adam's bias correction reads; the JAX package's ``load_states``
    keeps the Trainer's own optimizer instead, reference trainer.py
    adopts the loaded one)."""
    jnet, tnet, tnet2 = _mlp(mx), _mlp(mxt), _mlp(mxt)
    _copy_params(jnet, tnet)
    _copy_params(jnet, tnet2)
    want = _gluon_steps(mx, jnet, mx.gluon.Trainer(
        jnet.collect_params(), "adam", dict(ADAM)))
    got = _gluon_steps(mxt, tnet, mxt.gluon.Trainer(
        tnet.collect_params(), "adam", dict(ADAM)))
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **OPT_TOL)
    first = mxt.gluon.Trainer(tnet2.collect_params(), "adam", dict(ADAM))
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    data = _gluon_data()
    fname = str(tmp_path / "mlp.states")

    def step(trainer, x, y):
        with mxt.autograd.record():
            loss = loss_fn(tnet2(mxt.nd.array(x, ctx=mxt.cpu())),
                           mxt.nd.array(y, ctx=mxt.cpu()))
        loss.backward()
        trainer.step(6)

    for x, y in data[:2]:
        step(first, x, y)
    first.save_states(fname)
    fresh = mxt.gluon.Trainer(tnet2.collect_params(), "adam", dict(ADAM))
    fresh.load_states(fname)
    assert fresh._optimizer._index_update_count == {i: 2 for i in range(4)}
    assert fresh._optimizer.param_dict[0] is tnet2.collect_params()[
        "mlp_dense0_weight"]
    step(fresh, *data[2])
    for n, p in tnet2.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), got[n], err_msg=n)


def _mod(pkg, arg_params, opt="adam", prefix=None, epoch=None):
    data = pkg.sym.var("data")
    fc1 = pkg.sym.Activation(pkg.sym.FullyConnected(
        data, num_hidden=8, name="fc1"), act_type="relu")
    out = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        fc1, num_hidden=3, name="fc2"), name="softmax")
    if prefix is None:
        mod = pkg.mod.Module(out, context=pkg.cpu())
    else:
        mod = pkg.mod.Module.load(prefix, epoch, load_optimizer_states=True,
                                  context=pkg.cpu())
    mod.bind([("data", (6, 4))], [("softmax_label", (6,))])
    if prefix is None:
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in arg_params.items()})
    mod.init_optimizer(optimizer=opt, optimizer_params=(
        ("learning_rate", 0.01), ("wd", 1e-4)))
    return mod


def _mod_steps(pkg, mod, batches):
    for x, y in batches:
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                     [pkg.nd.array(y, ctx=pkg.cpu())]),
                    is_train=True)
        mod.backward()
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_adam_and_optimizer_states(tmp_path, _plain_jit):
    """``Module.update`` with Adam on a small MLP against the JAX Module
    (2 steps, 1e-5); ``save_checkpoint(save_optimizer_states=True)`` and
    ``Module.load(load_optimizer_states=True)`` in both packages, the
    loaded states equal to the saved ones and a step after the load
    matching the JAX package's same step; the port reads the JAX
    package's ``.states`` file too."""
    rng = np.random.RandomState(4)
    params = {"fc1_weight": rng.randn(8, 4).astype("f") * 0.5,
              "fc1_bias": np.zeros(8, "f"),
              "fc2_weight": rng.randn(3, 8).astype("f") * 0.5,
              "fc2_bias": np.zeros(3, "f")}
    batches = [(rng.randn(6, 4).astype("f"),
                rng.randint(0, 3, 6).astype("f")) for _ in range(3)]
    mods = {pkg: _mod(pkg, params) for pkg in (mx, mxt)}
    out = {pkg: _mod_steps(pkg, m, batches[:2]) for pkg, m in mods.items()}
    for k in out[mx]:
        np.testing.assert_allclose(out[mxt][k], out[mx][k], err_msg=k,
                                   **OPT_TOL)
    prefix = {pkg: str(tmp_path / name) for pkg, name in
              ((mx, "jax"), (mxt, "torch"))}
    for pkg, m in mods.items():
        m.save_checkpoint(prefix[pkg], 2, save_optimizer_states=True)
    loaded = {pkg: _mod(pkg, None, prefix=prefix[pkg], epoch=2)
              for pkg in (mx, mxt)}
    saved = mods[mxt]._updater.states
    for i, (m, v) in loaded[mxt]._updater.states.items():
        np.testing.assert_array_equal(m.asnumpy(), saved[i][0].asnumpy())
        np.testing.assert_array_equal(v.asnumpy(), saved[i][1].asnumpy())
    after = {pkg: _mod_steps(pkg, m, batches[2:]) for pkg, m in
             loaded.items()}
    for k in after[mx]:
        np.testing.assert_allclose(after[mxt][k], after[mx][k], err_msg=k,
                                   **OPT_TOL)
    mods[mxt].load_optimizer_states(prefix[mx] + "-0002.states")
    for i, (m, v) in mods[mxt]._updater.states.items():
        np.testing.assert_allclose(m.asnumpy(), saved[i][0].asnumpy(),
                                   **OPT_TOL)


def test_u1_table_and_chunk_pairs():
    """The multi-tensor kernel's device table, built on the host: six
    int64s a tensor (weight, gradient, three states, size) and one
    (tensor, chunk) pair for every CHUNK elements."""
    from mxnet_tpu_torch.ops.multi_tensor import CHUNK, UpdateBuffers
    ws = [torch.zeros(5), torch.zeros(CHUNK + 1), torch.zeros(CHUNK)]
    gs = [torch.zeros_like(w) for w in ws]
    states = [(torch.zeros_like(w), torch.zeros_like(w)) for w in ws]
    table, pairs = UpdateBuffers.pack(ws, gs, states)
    assert table.tolist() == [
        [w.data_ptr(), g.data_ptr(), s[0].data_ptr(), s[1].data_ptr(), 0,
         w.numel()] for w, g, s in zip(ws, gs, states)]
    assert pairs.tolist() == [[0, 0], [1, 0], [1, 1], [2, 0]]
    assert pairs.dtype == torch.int32


def test_u1_wrapper_on_the_cpu_and_elsewhere():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; on a device without a kernel it raises."""
    from mxnet_tpu_torch.ops.multi_tensor import multi_tensor_update
    w, g = torch.ones(4), torch.full((4,), 2.0)
    before = multi_tensor_update.launches
    multi_tensor_update("sgd", [w], [g], [()], [0.5], [0.0],
                        rescale_grad=0.5)
    assert multi_tensor_update.launches == before
    np.testing.assert_array_equal(w.numpy(), 0.5)
    meta = torch.empty(4, device="meta")
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        multi_tensor_update("sgd", [meta], [meta], [()], [0.1], [0.0])
    with pytest.raises(mxt.MXNetError, match="unknown formula"):
        multi_tensor_update("nag", [w], [g], [()], [0.1], [0.0])
