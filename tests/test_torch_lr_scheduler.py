"""The port's learning-rate schedulers against the JAX package's.

Every scheduler of `lr_scheduler.py` and the deprecated ones of
`misc.py`, called at update counts 0-200 in order (some keep state from
call to call), must give the JAX package's value to 1e-12: both are the
same double-precision Python. An optimizer driven by a scheduler through
the port's one update path (``FusedApplier``) must reach the JAX
``Updater``'s weights.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

STEPS = range(201)

SCHEDULERS = [
    ("FactorScheduler", {"step": 20, "factor": 0.7}),
    ("FactorScheduler", {"step": 5, "factor": 0.5, "stop_factor_lr": 1e-4}),
    ("MultiFactorScheduler", {"step": [10, 50, 120], "factor": 0.3}),
    ("PolyScheduler", {"max_update": 150, "base_lr": 0.5, "pwr": 2}),
    ("CosineScheduler", {"max_update": 180, "base_lr": 0.2,
                         "final_lr": 0.01}),
]


def _make(pkg, name, kw, warmup):
    sched = getattr(pkg.lr_scheduler, name)(**kw)
    if warmup:
        sched = pkg.lr_scheduler.WarmupScheduler(sched, 30, 0.001)
    return sched


@pytest.mark.parametrize("warmup", [False, True], ids=["plain", "warmup"])
@pytest.mark.parametrize("name,kw", SCHEDULERS, ids=lambda v: str(v))
def test_scheduler_values_match_jax(name, kw, warmup):
    want, got = (_make(pkg, name, kw, warmup) for pkg in (mx, mxt))
    a = np.array([got(t) for t in STEPS])
    b = np.array([want(t) for t in STEPS])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw", [{"step": 7, "factor": 0.5},
                                {"step": 2.5, "factor": 0.9}], ids=str)
def test_deprecated_misc_scheduler_matches_jax(kw):
    want, got = mx.misc.FactorScheduler(**kw), mxt.misc.FactorScheduler(**kw)
    for s in (want, got):
        s.base_lr = 0.3
    np.testing.assert_allclose([got(t) for t in STEPS],
                               [want(t) for t in STEPS], rtol=0, atol=1e-12)
    assert issubclass(mxt.misc.FactorScheduler,
                      mxt.misc.LearningRateScheduler)


def test_schedulers_refuse_what_jax_refuses():
    for pkg in (mx, mxt):
        with pytest.raises(ValueError):
            pkg.lr_scheduler.FactorScheduler(step=0)
        with pytest.raises(ValueError):
            pkg.lr_scheduler.MultiFactorScheduler(step=[5, 3])
        with pytest.raises(ValueError):
            pkg.misc.FactorScheduler(step=3, factor=1.0)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_scheduled_updates_match_jax(name):
    """12 updates at a FactorScheduler's rates: the JAX Updater against
    the port's FusedApplier, and the optimizer's learning_rate after."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 5).astype(np.float32)
    grads = [rng.randn(4, 5).astype(np.float32) for _ in range(12)]
    out = []
    for pkg in (mx, mxt):
        opt = pkg.optimizer.create(
            name, learning_rate=0.1, momentum=0.9,
            lr_scheduler=pkg.lr_scheduler.FactorScheduler(3, 0.5)) \
            if name == "sgd" else pkg.optimizer.create(
                name, learning_rate=0.1,
                lr_scheduler=pkg.lr_scheduler.FactorScheduler(3, 0.5))
        upd = pkg.optimizer.get_updater(opt)
        w = pkg.nd.array(w0)
        apply = pkg.optimizer.FusedApplier.resolve(upd) if pkg is mxt \
            else None
        for g in grads:
            if apply is None:
                upd(0, pkg.nd.array(g), w)
            else:
                apply([0], [w], [pkg.nd.array(g)])
        out.append((w.asnumpy(), opt.learning_rate))
    (jw, jlr), (tw, tlr) = out
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
    assert tlr == jlr == 0.1 * 0.5 ** 3
