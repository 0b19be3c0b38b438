"""The port's compiled Gluon call (``hybridize``) and `compiled.py` on the
CPU, against the JAX package.

On the CPU a hybridized block runs its function eagerly behind the same
signature cache, keys and counters that capture CUDA graphs on the card
(`mxnet_tpu_torch/compiled.py`), so here:

- a small ResNet v1 (``[1, 1, 1, 1]``, ``[16, 128, 256, 384, 512]``, 10
  classes, 2 images of 64x64, the spec of `test_torch_gluon_resnet.py`)
  in NCHW and NHWC, built in both packages with the same seeded weights:
  the port's hybridized call against the JAX package's hybridized call
  (plain ``jax.jit`` under ``MXNET_XLA_STATS=0``) at that file's
  tolerances (f32 both sides, only summation order differs: rtol 1e-4,
  atol 1e-5 on logits of magnitude ~4), and the port's hybridized output
  equal to its eager output bit for bit;
- BatchNorm's moving statistics in train mode step once per call: a
  hybridized ``HybridSequential`` BatchNorm against the JAX package's
  hybridized one (its ``test_gluon.py`` cases), and a deferred-init
  BatchNorm child called inside a hybridized parent against the eager
  update of both packages (the JAX package's hybridized call steps that
  child twice on its first call: once in its deferred-init pass and once
  in the compiled call), at rtol 1e-5, atol 1e-6;
- the counters and the cache: ``compile_counts()`` and
  ``last_retrace()`` on a shape change, the program dropped by ``cast``,
  ``register_child`` and setting a child attribute, ``set_data`` seen by
  the next call without a recompile, moved storage recompiled as a
  retrace naming the parameter, the TF32 switches in the signature,
  ``warmup()`` changing no moving
  statistic, two threads against one, a Python scalar argument reaching
  every call (``remat`` is tested with training, in
  `test_torch_gluon_train.py`);
- the retrace explainer's text against the JAX package's.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import compiled as jcompiled
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import compiled
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

SPEC = ([1, 1, 1, 1], [16, 128, 256, 384, 512])
SHAPES = {"NCHW": (2, 3, 64, 64), "NHWC": (2, 64, 64, 3)}
OUT_TOL, TOL = 1e-5, 1e-4
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6
CPU = mxt.cpu()


def _weights(params):
    """Seeded weights at sane scales, by name."""
    rng = np.random.RandomState(0)
    out = {}
    for name, p in params.items():
        s = p.shape
        if name.endswith("weight"):
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif name.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, s)
        elif name.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, s)
        else:
            v = rng.randn(*s) * 0.1
        out[name] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module", autouse=True)
def nets():
    """Both packages' small ResNets per layout, materialised, with the
    same weights; plain jit for the JAX package throughout the file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_XLA_STATS", "0")
        out = {}
        for layout, shape in SHAPES.items():
            tnet = tvision.ResNetV1(tvision.BottleneckV1, *SPEC, classes=10,
                                    layout=layout, prefix="net_")
            tnet.initialize(mxt.init.Xavier(), ctx=CPU)
            tnet(mxt.nd.zeros(shape, ctx=CPU))
            jnet = jresnet.ResNetV1(jresnet.BottleneckV1, *SPEC, classes=10,
                                    layout=layout, prefix="net_")
            jnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
            jnet(mx.nd.zeros(shape))
            weights = _weights(tnet.collect_params())
            for name, param in jnet.collect_params().items():
                param.set_data(mx.nd.array(weights[name]))
            mxt.set_block_params(tnet, weights)
            jnet.hybridize()
            tnet.hybridize()
            out[layout] = {"jnet": jnet, "tnet": tnet, "weights": weights}
        yield out


def _x(shape, seed=1):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _stats(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()
            if "running" in n}


@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_hybridized_resnet_matches_jax(nets, layout):
    x = _x(SHAPES[layout])
    want = nets[layout]["jnet"](mx.nd.array(x)).asnumpy()
    got = nets[layout]["tnet"](mxt.nd.array(x, ctx=CPU))
    assert got.context == CPU and got.shape == (2, 10)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=TOL, atol=OUT_TOL)


@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_hybridized_equals_eager_bitwise(nets, layout):
    tnet = nets[layout]["tnet"]
    x = mxt.nd.array(_x(SHAPES[layout], 2), ctx=CPU)
    hybrid = tnet(x).asnumpy()
    assert tnet._cached_jit is not None
    eager = tnet._forward_impl(x).asnumpy()
    np.testing.assert_array_equal(hybrid, eager)


@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_train_mode_steps_moving_statistics_once(nets, layout):
    """A hybridized call in train mode moves every moving statistic once,
    exactly as the eager call does from the same state."""
    tnet, weights = nets[layout]["tnet"], nets[layout]["weights"]
    x = mxt.nd.array(_x(SHAPES[layout], 3), ctx=CPU)
    try:
        with mxt.autograd.train_mode():
            hybrid_out = tnet(x).asnumpy()
        hybrid = _stats(tnet)
        mxt.set_block_params(tnet, weights)
        with mxt.autograd.train_mode():
            eager_out = tnet._forward_impl(x).asnumpy()
        eager = _stats(tnet)
    finally:
        mxt.set_block_params(tnet, weights)
    np.testing.assert_array_equal(hybrid_out, eager_out)
    assert len(hybrid) == 2 * 17
    for name, v in eager.items():
        assert not np.allclose(v, weights[name]), name
        np.testing.assert_array_equal(hybrid[name], v, err_msg=name)


def _bn_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.BatchNorm())
    return net


def _wrapper(pkg):
    class Wrapper(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.bn = pkg.gluon.nn.BatchNorm()   # in_channels deferred

        def hybrid_forward(self, F, x):
            return self.bn(x)
    return Wrapper()


def _bn_stats_after(pkg, net, x, ctx, calls, hybridize):
    net.initialize(ctx=ctx)
    if hybridize:
        net.hybridize()
    out = []
    for _ in range(calls):
        with pkg.autograd.record():
            net(x)
        bn = net.bn if hasattr(net, "bn") else list(net._children.values())[0]
        out.append((bn.running_mean.data().asnumpy(),
                    bn.running_var.data().asnumpy()))
    return out


@pytest.mark.parametrize("nested", [False, True])
def test_batchnorm_stats_once_per_call(nested):
    """The port's counterparts of the JAX package's
    ``test_hybridized_batchnorm_updates_moving_stats`` and
    ``test_hybridized_nested_deferred_bn_updates_stats``, over two calls
    under ``autograd.record()``."""
    x = np.random.RandomState(0).rand(16, 4).astype(np.float32) * 5 + 10
    make = _wrapper if nested else _bn_net
    got = _bn_stats_after(mxt, make(mxt), mxt.nd.array(x, ctx=CPU), CPU, 2,
                          True)
    eager = _bn_stats_after(mxt, make(mxt), mxt.nd.array(x, ctx=CPU), CPU,
                            2, False)
    # flat: the JAX hybridized call; nested: the JAX eager call (its
    # hybridized one steps the deferred child twice on the first call)
    want = _bn_stats_after(mx, make(mx), mx.nd.array(x), mx.cpu(), 2,
                           not nested)
    for g, e, w in zip(got, eager, want):
        for a, b, c in zip(g, e, w):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, c, rtol=STAT_RTOL, atol=STAT_ATOL)
    # one momentum-0.9 step from (0, 1) toward the batch mean per call
    np.testing.assert_allclose(got[0][0], 0.1 * x.mean(0), rtol=1e-5)
    np.testing.assert_allclose(got[1][0], 0.19 * x.mean(0), rtol=1e-5)


def _dense_net(prefix):
    net = tnn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(tnn.Dense(5, in_units=4), tnn.Activation("relu"),
                tnn.Dense(3, in_units=5))
    net.initialize(mxt.init.Xavier(), ctx=CPU)
    net.hybridize()
    return net


def test_compile_counts_and_retrace():
    net = _dense_net("cc_")
    compiled.reset()
    x2 = mxt.nd.array(_x((2, 4)), ctx=CPU)
    net(x2)
    net(x2)
    assert compiled.compile_counts() == {"compiles": 1, "cache_hits": 1,
                                         "retraces": 0, "uncaptured": 0}
    assert compiled.last_retrace() is None
    net(mxt.nd.array(_x((3, 4)), ctx=CPU))
    assert compiled.compile_counts() == {"compiles": 2, "cache_hits": 1,
                                         "retraces": 1, "uncaptured": 0}
    retrace = compiled.last_retrace()
    assert retrace["site"] == "gluon.hybrid_forward"
    assert retrace["compiles"] == 2
    assert retrace["reason"] == \
        "arg3: shape (2, 4) -> (3, 4) (dim 0: 2 -> 3)"
    with mxt.autograd.train_mode():     # is_train is static: a new program
        net(x2)
    assert "arg2(static): static value False -> True" in \
        compiled.last_retrace()["reason"]
    compiled.reset()
    assert compiled.compile_counts() == {"compiles": 0, "cache_hits": 0,
                                         "retraces": 0, "uncaptured": 0}
    assert net._cached_jit._cache == {}


def test_a_new_block_is_no_retrace_of_a_collected_one():
    """Each net's first compile is a compile, never a retrace of an
    earlier net whose id() the new one happens to reuse (the port's
    bench builds and drops one net per run)."""
    import gc
    compiled.reset()
    x = mxt.nd.array(_x((2, 4)), ctx=CPU)
    for _ in range(8):
        net = _dense_net("nb_")
        net(x)
        del net
        gc.collect()
    assert compiled.compile_counts() == {"compiles": 8, "cache_hits": 0,
                                         "retraces": 0, "uncaptured": 0}


def test_tf32_switch_is_part_of_the_signature():
    """A capture bakes cuDNN's and cuBLAS's TF32 choice into the graph,
    so flipping either switch is a new signature: one retrace naming it."""
    import torch
    net = _dense_net("tf32_")
    x = mxt.nd.array(_x((2, 4)), ctx=CPU)
    net(x)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = not saved
    try:
        net(x)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert compiled.last_retrace()["reason"] == \
        "tf32 (cudnn, matmul): static value (%s, %s) -> (%s, %s)" % (
            saved, torch.backends.cuda.matmul.allow_tf32, not saved,
            torch.backends.cuda.matmul.allow_tf32)
    counts = compiled.compile_counts()
    net(x)
    assert compiled.compile_counts()["cache_hits"] == \
        counts["cache_hits"] + 1


def test_program_dropped_by_cast_and_children():
    net = _dense_net("drop_")
    x = mxt.nd.array(_x((2, 4)), ctx=CPU)
    want = net(x).asnumpy()
    assert net._cached_jit is not None
    net.cast("float64")
    assert net._cached_jit is None
    compiled.reset()
    got = net(mxt.nd.array(_x((2, 4)), ctx=CPU, dtype="float64"))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6, atol=1e-6)
    net.cast("float32")
    net(x)
    reason = compiled.last_retrace()["reason"]
    assert "arg0[drop_dense0_weight]: dtype float64 -> float32" in reason
    assert net._cached_jit is not None
    net.add(tnn.Activation("relu"))               # register_child
    assert net._cached_jit is None
    net(x)
    net.extra = tnn.Dense(2, in_units=3)          # a child attribute
    assert net._cached_jit is None


def test_set_data_is_seen_and_moved_storage_retraces():
    """``set_data`` copies into the parameter's tensor, so the next call
    reads the new value from the same storage: a cache hit. A
    re-initialisation gives the parameters new tensors: one recompile,
    reported as a retrace that names them."""
    net = _dense_net("sd_")
    x = mxt.nd.array(_x((2, 4)), ctx=CPU)
    net(x)
    w = net.collect_params()["sd_dense0_weight"]
    w.set_data(np.full((5, 4), 0.5, np.float32))
    counts = compiled.compile_counts()
    got = net(x).asnumpy()
    after = compiled.compile_counts()
    assert after["compiles"] == counts["compiles"]
    assert after["cache_hits"] == counts["cache_hits"] + 1
    np.testing.assert_array_equal(got, net._forward_impl(x).asnumpy())
    net.collect_params().initialize(mxt.init.Xavier(), ctx=CPU,
                                    force_reinit=True)
    net(x)
    assert compiled.compile_counts()["retraces"] == after["retraces"] + 1
    reason = compiled.last_retrace()["reason"]
    assert "arg0[sd_dense0_weight]: storage moved" in reason


def test_warmup_changes_no_moving_statistic(nets):
    tnet, weights = nets["NHWC"]["tnet"], nets["NHWC"]["weights"]
    x = mxt.nd.array(_x(SHAPES["NHWC"], 4), ctx=CPU)
    tnet(x)
    params = [tnet.collect_params()[n].data().data
              for n in tnet._param_order]
    before = _stats(tnet)
    counts = compiled.compile_counts()
    try:
        assert tnet._cached_jit.warmup(params, 0, True, x.data) \
            is tnet._cached_jit
        after = compiled.compile_counts()
        assert after["compiles"] == counts["compiles"] + 1
        for name, v in _stats(tnet).items():
            np.testing.assert_array_equal(v, before[name], err_msg=name)
        with mxt.autograd.train_mode():
            tnet(x)
        assert compiled.compile_counts()["compiles"] == after["compiles"]
        assert compiled.compile_counts()["cache_hits"] == \
            after["cache_hits"] + 1
        assert all(not np.array_equal(v, before[n])
                   for n, v in _stats(tnet).items())
    finally:
        mxt.set_block_params(tnet, weights)


def test_two_threads_match_one():
    net = _dense_net("thr_")
    inputs = [mxt.nd.array(_x((2 + i % 3, 4), i), ctx=CPU)
              for i in range(24)]
    want = [net(x).asnumpy() for x in inputs]
    got = [None] * len(inputs)

    def worker(k):
        for i in range(k, len(inputs), 2):
            got[i] = net(inputs[i]).asnumpy()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


class _Noisy(mxt.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return x + F.random.normal(shape=x.shape, ctx=x.context)


def test_random_draws_differ_per_call_and_follow_the_seed():
    """Each hybridized call draws from its own key: two calls differ, and
    one seed reproduces them."""
    net = _Noisy()
    net.hybridize()
    x = mxt.nd.zeros((64,), ctx=CPU)
    mxt.random.seed(5)
    a, b = net(x).asnumpy(), net(x).asnumpy()
    mxt.random.seed(5)
    np.testing.assert_array_equal(net(x).asnumpy(), a)
    assert not np.array_equal(a, b)
    assert abs(a.std() - 1.0) < 0.5


class _Scale(mxt.gluon.HybridBlock):
    def hybrid_forward(self, F, x, s):
        return x * s


def test_scalar_argument_reaches_every_call():
    """On the CPU a Python scalar argument is keyed by type, as in the JAX
    package: a new value is a cache hit, and each call computes with its
    own value, as the eager call does."""
    net = _Scale()
    x = mxt.nd.array(_x((2, 4)), ctx=CPU)
    want = {s: net(x, s).asnumpy() for s in (0.5, 2.0)}
    net.hybridize()
    compiled.reset()
    for s in (0.5, 2.0, 0.5):
        np.testing.assert_array_equal(net(x, s).asnumpy(), want[s])
    assert compiled.compile_counts() == {"compiles": 1, "cache_hits": 2,
                                         "retraces": 0, "uncaptured": 0}


@pytest.mark.parametrize("by_value,reason", [
    (frozenset(), "no signature change detected (new function or closure)"),
    (frozenset({1}), "arg1: python float 0.5 -> python float 2.0")])
def test_scalars_keyed_by_value_only_where_asked(by_value, reason):
    """A CUDA program keys its scalars by value (a graph keeps the value
    it was captured with); the key and the retrace explanation come from
    one classifier, so they agree."""
    import torch
    t = torch.zeros(2)
    old, new = (t, 0.5), (t, 2.0)
    keys = [tuple(compiled._key_of(a, False, i in by_value)
                  for i, a in enumerate(args)) for args in (old, new)]
    assert (keys[0] != keys[1]) == bool(by_value)
    assert compiled.explain_signature_change(
        compiled._describe_args(old, frozenset(), by_value=by_value),
        compiled._describe_args(new, frozenset(), by_value=by_value)) \
        == reason


@pytest.mark.parametrize("old,new", [
    ((np.zeros((2, 3), "f"),), (np.zeros((4, 3), "f"),)),
    ((np.zeros((2, 3), "f"), 1), (np.zeros((2, 3), "f"), 2.0)),
    ((np.zeros((2,), "f"), [np.zeros(3, "f")]),
     (np.zeros((2, 1), "f"), [np.zeros(3, "f"), np.zeros(1, "f")]))])
def test_retrace_explanation_matches_jax(old, new):
    """The same signature change reads the same in both packages (tensors
    on one device; numpy arrays on the JAX side)."""
    import torch

    def torch_args(args):
        return [torch.from_numpy(a) if isinstance(a, np.ndarray)
                else [torch.from_numpy(v) for v in a]
                if isinstance(a, list) else a for a in args]
    want = jcompiled.explain_signature_change(
        jcompiled._describe_args(old, frozenset()),
        jcompiled._describe_args(new, frozenset()))
    got = compiled.explain_signature_change(
        compiled._describe_args(torch_args(old), frozenset()),
        compiled._describe_args(torch_args(new), frozenset()))
    assert got == want


def test_kernel_launches_count_at_each_graph_replay(monkeypatch):
    """A hand kernel launched while its stream captures is counted at no
    capture, and once at each replay of the graph that recorded it
    (`ops/launch_count.py`, ``compiled._Graph.run``)."""
    from mxnet_tpu_torch.ops import launch_count

    def kernel():
        pass
    kernel.launches, kernel.launches_by_route = 0, {"persistent": 0}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    launch_count.count(kernel, "persistent")    # captured elsewhere
    with launch_count.recording() as held:
        launch_count.count(kernel, "persistent")
        launch_count.count(kernel, "persistent")
    assert (kernel.launches, len(held)) == (0, 2)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    launch_count.count(kernel)
    assert kernel.launches == 1

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1
    program = compiled.CompiledProgram(lambda x: x, "test.replay")
    graph = compiled._Graph(Graph(), [torch.zeros(2)], torch.zeros(2), held)
    for _ in range(3):
        graph.run(program, (torch.ones(2),))
    assert graph.graph.replays == 3
    assert kernel.launches == 1 + 3 * 2
    assert kernel.launches_by_route == {"persistent": 6}
