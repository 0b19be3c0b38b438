"""`mx.nd.random`: the sampling front end (reference
`python/mxnet/ndarray/random.py`).

Counterpart of `mxnet_tpu/ndarray/random.py` over the ops of
`ops/random_ops.py`. A scalar-parameter draw runs the ``_random_*`` op on
``ctx``, which is the enclosing ``with ctx:`` scope's context, else
``gpu(0)``, unless the caller passes another (``cpu()`` on a host
without CUDA), as every entry point of the port;
NDArray parameters run the ``_sample_*`` op on their own device. The
draws come from the seed sequence of `random.py`: ``mx.random.seed(n)``
reproduces them bit for bit.
"""
from __future__ import annotations

from ..context import gpu, scope_context
from ..ops.invoke import invoke
from .ndarray import NDArray

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randint", "randn"]


def _default(ctx):
    return ctx if ctx is not None else (scope_context() or gpu(0))


def _store(res, out):
    if out is None:
        return res
    out[:] = res
    return out


def _sample(dist, scalar_params, tensor_params, shape, dtype, ctx, out,
            **extra):
    if any(isinstance(p, NDArray) for p in tensor_params.values()):
        params = {"shape": shape if shape is not None else (),
                  "dtype": dtype}
        params.update(extra)
        return _store(invoke("_sample_" + dist, list(tensor_params.values()),
                             params), out)
    params = dict(scalar_params)
    params.update({"shape": shape if shape is not None else (1,),
                   "dtype": dtype})
    params.update(extra)
    return _store(invoke("_random_" + dist, [], params,
                         ctx=_default(ctx)), out)


def uniform(low=0, high=1, shape=None, dtype=None, ctx=None, out=None,
            **kwargs):
    return _sample("uniform", {"low": low, "high": high},
                   {"low": low, "high": high}
                   if isinstance(low, NDArray) else {},
                   shape, dtype, ctx, out)


def normal(loc=0, scale=1, shape=None, dtype=None, ctx=None, out=None,
           **kwargs):
    return _sample("normal", {"loc": loc, "scale": scale},
                   {"loc": loc, "scale": scale}
                   if isinstance(loc, NDArray) else {},
                   shape, dtype, ctx, out)


def randn(*shape, **kwargs):
    return normal(kwargs.pop("loc", 0), kwargs.pop("scale", 1),
                  shape=shape or None, **kwargs)


def gamma(alpha=1, beta=1, shape=None, dtype=None, ctx=None, out=None,
          **kwargs):
    return _sample("gamma", {"alpha": alpha, "beta": beta},
                   {"alpha": alpha, "beta": beta}
                   if isinstance(alpha, NDArray) else {},
                   shape, dtype, ctx, out)


def exponential(scale=1, shape=None, dtype=None, ctx=None, out=None,
                **kwargs):
    lam = 1.0 / scale
    if isinstance(scale, NDArray):
        return _sample("exponential", {}, {"lam": lam}, shape, dtype, ctx,
                       out)
    return _sample("exponential", {"lam": lam}, {}, shape, dtype, ctx, out)


def poisson(lam=1, shape=None, dtype=None, ctx=None, out=None, **kwargs):
    if isinstance(lam, NDArray):
        return _sample("poisson", {}, {"lam": lam}, shape, dtype, ctx, out)
    return _sample("poisson", {"lam": lam}, {}, shape, dtype, ctx, out)


def negative_binomial(k=1, p=1, shape=None, dtype=None, ctx=None, out=None,
                      **kwargs):
    return _sample("negative_binomial", {"k": k, "p": p}, {}, shape, dtype,
                   ctx, out)


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype=None,
                                  ctx=None, out=None, **kwargs):
    return _sample("generalized_negative_binomial",
                   {"mu": mu, "alpha": alpha}, {}, shape, dtype, ctx, out)


def multinomial(data, shape=1, get_prob=False, out=None, dtype="int32",
                **kwargs):
    return _store(invoke("_sample_multinomial", [data],
                         {"shape": shape, "get_prob": get_prob,
                          "dtype": dtype}), out)


def shuffle(data, out=None, **kwargs):
    return _store(invoke("_shuffle", [data]), out)


def randint(low, high, shape=None, dtype=None, ctx=None, out=None,
            **kwargs):
    return _store(invoke("_random_randint", [],
                         {"low": low, "high": high, "shape": shape or (1,),
                          "dtype": dtype or "int32"},
                         ctx=_default(ctx)), out)
