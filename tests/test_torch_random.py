"""``nd.random`` and the random ops of the port on the CPU.

The port's samplers draw from ``torch.Generator``s and the JAX package's
from threefry keys, so the two agree in distribution only: each sampler's
moments are held to the tolerances of the JAX package's own
``tests/test_random.py`` (40000 draws), while the ``_sample_*``
multisample family and ``multinomial`` are held to the JAX ops' output
shapes and dtypes on the same parameter arrays. One seed reproduces a
draw bit for bit and two draws without a reseed differ. Without a CUDA
device, ``nd.random`` without ``ctx`` raises (its default is ``gpu(0)``)
outside a ``with ctx:`` scope.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

N = 40000
CPU = mxt.cpu()

# sampler -> (port call, check(x) on the numpy draws)
SAMPLERS = {
    "uniform": (lambda: mxt.nd.random.uniform(low=2.0, high=4.0, shape=(N,),
                                              ctx=CPU),
                lambda x: (2.0 <= x.min() and x.max() <= 4.0
                           and abs(x.mean() - 3.0) <= 0.05
                           and abs(x.var() - 4.0 / 12.0) <= 0.05)),
    "normal": (lambda: mxt.nd.random.normal(loc=1.5, scale=2.0, shape=(N,),
                                            ctx=CPU),
               lambda x: (abs(x.mean() - 1.5) <= 0.06
                          and abs(x.std() - 2.0) <= 0.06)),
    "gamma": (lambda: mxt.nd.random.gamma(alpha=4.0, beta=0.5, shape=(N,),
                                          ctx=CPU),
              lambda x: abs(x.mean() - 2.0) <= 0.05 * 2.0),
    "poisson": (lambda: mxt.nd.random.poisson(lam=3.0, shape=(N,), ctx=CPU),
                lambda x: abs(x.mean() - 3.0) <= 0.05 * 3.0),
    "exponential": (lambda: mxt.nd.random.exponential(scale=2.0, shape=(N,),
                                                      ctx=CPU),
                    lambda x: abs(x.mean() - 2.0) <= 0.05 * 2.0),
    # mean k (1 - p) / p = 4
    "negative_binomial": (
        lambda: mxt.nd.random.negative_binomial(k=4, p=0.5, shape=(N,),
                                                ctx=CPU),
        lambda x: abs(x.mean() - 4.0) <= 0.05 * 4.0),
    # mean mu, variance mu + alpha mu^2
    "generalized_negative_binomial": (
        lambda: mxt.nd.random.generalized_negative_binomial(
            mu=3.0, alpha=0.5, shape=(N,), ctx=CPU),
        lambda x: (abs(x.mean() - 3.0) <= 0.05 * 3.0
                   and abs(x.var() - 7.5) <= 0.1 * 7.5)),
    "randint": (lambda: mxt.nd.random.randint(low=0, high=10, shape=(N,),
                                              ctx=CPU),
                lambda x: (x.min() == 0 and x.max() == 9
                           and x.dtype == np.int32)),
    "multinomial": (
        lambda: mxt.nd.random.multinomial(
            mxt.nd.array(np.array([[0.1, 0.2, 0.7]], "f"), ctx=CPU),
            shape=(N,)),
        lambda x: np.allclose(np.bincount(x.ravel(), minlength=3) / x.size,
                              [0.1, 0.2, 0.7], atol=0.02)),
    "shuffle": (lambda: mxt.nd.random.shuffle(
        mxt.nd.array(np.arange(50, dtype="f"), ctx=CPU)),
        lambda x: (sorted(x.tolist()) == list(range(50))
                   and not np.allclose(x, np.arange(50)))),
}


@pytest.fixture(scope="module")
def samples():
    """Every sampler's draws after ``seed(0)``, and again after
    ``seed(0)`` and after a second draw without a reseed."""
    out = {}
    for name, (draw, _) in SAMPLERS.items():
        mxt.random.seed(0)
        first = draw().asnumpy()
        mxt.random.seed(0)
        again = draw().asnumpy()
        out[name] = (first, again, draw().asnumpy())
    return out


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_moments(samples, name):
    assert SAMPLERS[name][1](samples[name][0])


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_seed_reproduces_the_draw(samples, name):
    first, again, third = samples[name]
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, third)


def _pair(x):
    return mx.nd.array(x), mxt.nd.array(x, ctx=CPU)


@pytest.mark.parametrize("dist,shape", [
    ("uniform", None), ("uniform", (3,)), ("uniform", (2, 3)),
    ("normal", (4,)), ("gamma", (3,)), ("exponential", (2,)),
    ("poisson", (5,))])
def test_multisample_shapes_match_jax(dist, shape):
    """``nd.random.<dist>`` with NDArray parameters runs ``_sample_<dist>``
    in both packages: the same output shape and dtype."""
    rng = np.random.RandomState(1)
    a = (rng.rand(2, 3) + 0.5).astype(np.float32)
    b = (rng.rand(2, 3) + 2.0).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    kw = {} if shape is None else {"shape": shape}
    if dist in ("exponential", "poisson"):
        want = getattr(mx.nd.random, dist)(ja, **kw)
        got = getattr(mxt.nd.random, dist)(ta, **kw)
    else:
        want = getattr(mx.nd.random, dist)(ja, jb, **kw)
        got = getattr(mxt.nd.random, dist)(ta, tb, **kw)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert got.context == CPU
    x = got.asnumpy()
    assert np.isfinite(x).all()
    if dist == "uniform":
        lo = a.reshape(a.shape + (1,) * (x.ndim - 2))
        hi = b.reshape(b.shape + (1,) * (x.ndim - 2))
        assert (x >= lo).all() and (x <= hi).all()


@pytest.mark.parametrize("rows,n", [(1, 1), (1, 4), (2, 1), (2, 4)])
def test_multinomial_shapes_match_jax(rows, n):
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], "f")[:rows]
    if rows == 1:
        probs = probs[0]
    jp, tp = _pair(probs)
    want = mx.nd.random.multinomial(jp, shape=n)
    got = mxt.nd.random.multinomial(tp, shape=n)
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("rows", [1, 2])
def test_multinomial_log_probabilities(rows):
    """``get_prob``: the log-probability of each draw under the
    normalised weights (the JAX op's ``log_softmax(log(data))``; its own
    ``get_prob`` path fails at n > 1 under the installed JAX, so this is
    held to numpy)."""
    probs = np.array([[1.0, 2.0, 7.0], [5.0, 2.5, 2.5]], "f")[:rows]
    if rows == 1:
        probs = probs[0]
    draws, logp = (g.asnumpy() for g in mxt.nd.random.multinomial(
        mxt.nd.array(probs, ctx=CPU), shape=6, get_prob=True))
    assert draws.shape == logp.shape == probs.shape[:-1] + (6,)
    p = (probs / probs.sum(-1, keepdims=True)).reshape(-1, 3)
    want = np.log(np.take_along_axis(p, draws.reshape(p.shape[0], -1), -1))
    np.testing.assert_allclose(logp, want.reshape(draws.shape), rtol=1e-5,
                               atol=1e-6)


def test_default_context_is_the_card():
    with pytest.raises(mxt.MXNetError, match="CUDA device"):
        mxt.nd.random.uniform(shape=(2,))
    with pytest.raises(mxt.MXNetError, match="CUDA device"):
        mxt.nd.random.randint(0, 5, shape=(2,))
    x = mxt.nd.random.uniform(shape=(2, 3), ctx=CPU)
    assert x.shape == (2, 3) and x.context == CPU
    assert x.dtype == np.float32


def test_default_context_is_the_enclosing_scope():
    """Inside ``with ctx:`` a draw without ``ctx`` lands on the scope's
    context, as a ctx-less ``nd.array`` and ``initialize`` do
    (``examples/vae/train_vae.py`` draws its noise so)."""
    with mxt.cpu():
        draws = [mxt.nd.random.normal(shape=(2, 3)),
                 mxt.nd.random.randint(0, 5, shape=(4,))]
    assert all(d.context == CPU and d.data.device.type == "cpu"
               for d in draws)


def test_seed_of_one_device():
    """``seed(n, ctx)`` reseeds that device's sequence only: its draws
    repeat, and a later ``seed(m)`` (every device) restarts the shared
    sequence."""
    mxt.random.seed(7)
    shared = mxt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    mxt.random.seed(3, ctx=CPU)
    a = mxt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    mxt.random.seed(3, ctx=CPU)
    b = mxt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, shared)
    mxt.random.seed(7)
    np.testing.assert_array_equal(
        mxt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy(), shared)


def test_random_op_in_symbol_draws_per_forward():
    """The port's counterpart of ``test_symbolic_random_in_executor``:
    a random symbol infers its shape and draws afresh every forward."""
    x = mxt.sym.random_uniform(shape=(64,), name="r")
    assert x.infer_shape()[1] == [(64,)]
    ex = x.bind(CPU, {})
    a = ex.forward()[0].asnumpy()
    b = ex.forward()[0].asnumpy()
    assert a.shape == (64,) and not np.allclose(a, b)
    assert ((0 <= a) & (a < 1)).all()
