"""Random sampling operators.

Counterpart of `mxnet_tpu/ops/random_ops.py` (reference
`src/operator/random/sample_op.cc`, `random/multisample_op.cc`): uniform,
normal, gamma, exponential, poisson, negative_binomial,
generalized_negative_binomial and randint with scalar parameters; the
multisample ``_sample_*`` family with per-element parameter tensors;
``_sample_multinomial`` and ``_shuffle``. The names and aliases are the
JAX package's.

Each op declares ``need_rng`` and draws only from ``params["_generator"]``,
the ``torch.Generator`` that the caller hands it on the device of the
draw (`ops/invoke.py`, `executor.py`), never from torch's global
generator. Symbolic shape inference passes no generator: the op then
returns an empty ``meta`` tensor of the draw's shape and dtype. The
distributions are the JAX package's; the bits are torch's.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _shape(params, default):
    shape = params.get("shape", default)
    if shape is None:
        shape = default
    if isinstance(shape, int):
        shape = (shape,)
    return tuple(int(s) for s in shape)


def _dtype(params, default="float32"):
    return torch_dtype(params.get("dtype") or default)


def _draw(params, shape, dtype, sample):
    """``sample(generator, device)`` on the generator's device, or an
    empty meta tensor of ``shape`` and ``dtype`` for shape inference."""
    gen = params.get("_generator")
    if gen is None:
        return (torch.empty(shape, dtype=dtype, device="meta"),)
    return (sample(gen, gen.device).to(dtype),)


def _gamma(alpha, shape, gen, device):
    """Gamma(alpha, 1) draws of ``shape`` in f32; ``alpha`` a scalar or a
    tensor broadcast to ``shape``."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    return torch._standard_gamma(alpha.expand(shape).contiguous(),
                                 generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam.float().contiguous(), generator=gen)


@register("_random_uniform", aliases=("uniform", "random_uniform"),
          need_rng=True)
def _uniform(params, *args):
    shape, dt = _shape(params, (1,)), _dtype(params)
    lo, hi = float(params.get("low", 0.0)), float(params.get("high", 1.0))
    return _draw(params, shape, dt, lambda g, d: lo + (hi - lo) * torch.rand(
        shape, generator=g, device=d, dtype=torch.float32))


@register("_random_normal", aliases=("normal", "random_normal"),
          need_rng=True)
def _normal(params, *args):
    shape, dt = _shape(params, (1,)), _dtype(params)
    mu, sigma = float(params.get("loc", 0.0)), float(params.get("scale", 1.0))
    return _draw(params, shape, dt, lambda g, d: mu + sigma * torch.randn(
        shape, generator=g, device=d, dtype=torch.float32))


@register("_random_gamma", aliases=("gamma_sample", "random_gamma"),
          need_rng=True)
def _gamma_op(params, *args):
    shape, dt = _shape(params, (1,)), _dtype(params)
    alpha = float(params.get("alpha", 1.0))
    beta = float(params.get("beta", 1.0))
    return _draw(params, shape, dt,
                 lambda g, d: beta * _gamma(alpha, shape, g, d))


@register("_random_exponential",
          aliases=("exponential", "random_exponential"), need_rng=True)
def _exponential(params, *args):
    shape, dt = _shape(params, (1,)), _dtype(params)
    lam = float(params.get("lam", 1.0))
    return _draw(params, shape, dt, lambda g, d: torch.empty(
        shape, device=d).exponential_(lam, generator=g))


@register("_random_poisson", aliases=("poisson", "random_poisson"),
          need_rng=True)
def _poisson_op(params, *args):
    shape, dt = _shape(params, (1,)), _dtype(params)
    lam = float(params.get("lam", 1.0))
    return _draw(params, shape, dt, lambda g, d: _poisson(
        torch.full(shape, lam, device=d), g))


def _gamma_poisson(shape, k, p, g, d):
    """Poisson(Gamma(k) * (1 - p) / p): the negative binomial."""
    return _poisson(_gamma(k, shape, g, d) * ((1 - p) / p), g)


@register("_random_negative_binomial", aliases=("negative_binomial",),
          need_rng=True)
def _negbin(params, *args):
    shape, dt = _shape(params, (1,)), _dtype(params)
    k, p = float(params.get("k", 1)), float(params.get("p", 1.0))
    return _draw(params, shape, dt,
                 lambda g, d: _gamma_poisson(shape, k, p, g, d))


@register("_random_generalized_negative_binomial",
          aliases=("generalized_negative_binomial",), need_rng=True)
def _gen_negbin(params, *args):
    shape, dt = _shape(params, (1,)), _dtype(params)
    mu = float(params.get("mu", 1.0))
    alpha = float(params.get("alpha", 1.0))
    if alpha <= 0:
        return _draw(params, shape, dt, lambda g, d: _poisson(
            torch.full(shape, mu, device=d), g))
    r = 1.0 / alpha
    return _draw(params, shape, dt,
                 lambda g, d: _gamma_poisson(shape, r, r / (r + mu), g, d))


@register("_random_randint", aliases=("randint",), need_rng=True)
def _randint(params, *args):
    shape, dt = _shape(params, (1,)), _dtype(params, "int32")
    lo, hi = int(params["low"]), int(params["high"])
    return _draw(params, shape, dt, lambda g, d: torch.randint(
        lo, hi, shape, generator=g, device=d, dtype=torch.int64))


def _multinomial_nout(params):
    return 2 if params.get("get_prob") else 1


@register("_sample_multinomial", aliases=("sample_multinomial",
                                          "multinomial"),
          need_rng=True, num_outputs=_multinomial_nout)
def _multinomial(params, data):
    """``shape`` draws per row of category weights ``data`` (1-D or 2-D),
    with replacement; one draw drops the trailing axis. With
    ``get_prob``, also the log-probability of each draw."""
    n = params.get("shape", 1)
    if isinstance(n, (tuple, list)):
        n = int(n[0]) if n else 1
    n = int(n)
    dt = _dtype(params, "int32")
    out_shape = ((n,) if data.dim() == 1 else (data.shape[0], n))
    if n == 1:
        out_shape = out_shape[:-1]
    gen = params.get("_generator")
    if gen is None:
        meta = torch.empty(out_shape, dtype=dt, device="meta")
        if params.get("get_prob"):
            return (meta, torch.empty(out_shape, dtype=data.dtype,
                                      device="meta"))
        return (meta,)
    weights = data.float().clamp_min(1e-30)
    draws = torch.multinomial(weights.reshape(-1, data.shape[-1]), n,
                              replacement=True, generator=gen)
    draws = draws.reshape(out_shape)
    out = draws.to(dt)
    if params.get("get_prob"):
        logp = torch.log_softmax(torch.log(weights), -1)
        if data.dim() == 1:
            lp = logp[draws]
        else:
            lp = torch.gather(logp, 1, draws.reshape(data.shape[0], -1))
            lp = lp.reshape(out_shape)
        return (out, lp.to(data.dtype))
    return (out,)


@register("_shuffle", aliases=("shuffle",), need_rng=True)
def _shuffle(params, data):
    """A random permutation of ``data`` along its first axis."""
    gen = params.get("_generator")
    if gen is None:
        return (torch.empty_like(data),)
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return (data.index_select(0, perm),)


# multisample: per-element distribution parameters as tensors; the draw
# has the parameters' shape followed by ``shape``
def _multisample(name, sampler):
    @register(name, need_rng=True)
    def _op(params, *dist_args):
        lead = tuple(dist_args[0].shape)
        shape = lead + _shape(params, ())
        dt = _dtype(params)
        gen = params.get("_generator")
        if gen is None:
            return (torch.empty(shape, dtype=dt, device="meta"),)

        def per_element(a):
            """A parameter tensor broadcast over the trailing draw axes."""
            return a.float().reshape(lead + (1,) * (len(shape) - len(lead)))
        args = [per_element(a) for a in dist_args]
        return (sampler(gen, args, shape, dist_args[0].device).to(dt),)
    return _op


_multisample("_sample_uniform", lambda g, a, s, d: a[0] + (a[1] - a[0])
             * torch.rand(s, generator=g, device=d))
_multisample("_sample_normal", lambda g, a, s, d: a[0] + a[1]
             * torch.randn(s, generator=g, device=d))
_multisample("_sample_gamma", lambda g, a, s, d: a[1]
             * _gamma(a[0], s, g, d))
_multisample("_sample_exponential", lambda g, a, s, d: torch.empty(
    s, device=d).exponential_(1.0, generator=g) / a[0])
_multisample("_sample_poisson", lambda g, a, s, d: _poisson(
    a[0].expand(s), g))
