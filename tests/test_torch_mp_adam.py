"""Adam with ``multi_precision`` on bf16 weights: the port's ``mp_adam``
formula of the multi-tensor update against the JAX package.

The JAX ``Adam(multi_precision=True)`` keeps an f32 master copy of a bf16
weight and Adam's f32 moments, updates the master from the gradient in
f32, and rounds it back into the weight (`mxnet_tpu/optimizer.py`,
``update_multi_precision``). The port's ``FusedApplier`` applies the same
update as one ``mp_adam`` call of ``multi_tensor_update`` a step (on the
CPU its plain version, the function the CUDA kernel is held to on the
card). Both compute in f32 in the same order (rescale, clip, weight
decay, moments, the bias-corrected lr folded in in double precision), so
masters and moments agree to f32 rounding over 3 steps (rtol 1e-6, atol
1e-7); the bf16 weights are each one rounding of those masters, one bf16
step apart at most. ``Trainer`` state files keep the JAX format.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops.multi_tensor import FORMULAS, multi_tensor_update
from mxnet_tpu_torch.ops.optimizer_ops import adam_update, mp_adam_update

F32 = {"rtol": 1e-6, "atol": 1e-7}
BF16_STEP = 2.0 ** -7
SHAPES = [(5, 7), (7,), (33,), (2, 3, 4)]


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _data(seed):
    rng = np.random.RandomState(seed)
    weights = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.randn(*s) * 2).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    return weights, grads


def _values(arr):
    return np.asarray(arr.asnumpy(), np.float32)


def _train(pkg, kw, weights, grads):
    opt = pkg.optimizer.create("adam", multi_precision=True, **kw)
    updater = pkg.optimizer.get_updater(opt)
    ws = [pkg.nd.array(w, dtype="bfloat16") for w in weights]
    apply = pkg.optimizer.FusedApplier.resolve(updater) if pkg is mxt \
        else None
    for step in grads:
        gs = [pkg.nd.array(g, dtype="bfloat16") for g in step]
        if apply is not None:
            apply(list(range(len(ws))), ws, gs)
        else:
            for i, g in enumerate(gs):
                updater(i, g, ws[i])
    return ws, updater


@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["wd0", "wd"])
@pytest.mark.parametrize("clip", [None, 0.8], ids=["noclip", "clip"])
def test_mp_adam_matches_jax(wd, clip):
    weights, grads = _data(11)
    kw = dict(learning_rate=0.01, beta1=0.8, beta2=0.99, wd=wd,
              rescale_grad=0.25, clip_gradient=clip)
    want_w, want = _train(mx, kw, weights, grads)
    got_w, got = _train(mxt, kw, weights, grads)
    for i in range(len(SHAPES)):
        master, (mean, var) = got.states[i]
        j_master, (j_mean, j_var) = want.states[i]
        assert master.data.dtype == mean.data.dtype == torch.float32
        for a, b, what in ((master, j_master, "master"),
                           (mean, j_mean, "mean"), (var, j_var, "var")):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(),
                                       err_msg="%d %s" % (i, what), **F32)
        assert got_w[i].data.dtype == torch.bfloat16
        np.testing.assert_allclose(_values(got_w[i]), _values(want_w[i]),
                                   rtol=BF16_STEP, atol=1e-7)
        # the weight is one rounding of its master
        np.testing.assert_array_equal(
            got_w[i].data.float().numpy(),
            master.data.to(torch.bfloat16).float().numpy())
    assert got.optimizer._index_update_count == \
        {i: 3 for i in range(len(SHAPES))}


def test_fused_applier_takes_mp_adam_in_one_call(monkeypatch):
    """A master-copy Adam index is the ``mp_adam`` formula, its states in
    the kernel's order (mean, var, master), one ``multi_tensor_update``
    call a (formula, dtype) group: bf16 weights by ``mp_adam``, an f32
    weight beside them by ``adam``."""
    calls = []
    import mxnet_tpu_torch.optimizer as opt_mod

    def spy(formula, weights, grads, states, *a, **k):
        calls.append((formula, [tuple(s.dtype for s in st)
                                for st in states]))
        return multi_tensor_update(formula, weights, grads, states, *a, **k)
    monkeypatch.setattr(opt_mod, "multi_tensor_update", spy)
    opt = mxt.optimizer.Adam(learning_rate=0.01, multi_precision=True)
    upd = mxt.optimizer.get_updater(opt)
    fused = mxt.optimizer.FusedApplier.resolve(upd)
    ws = [mxt.nd.ones((4,), dtype="bfloat16"), mxt.nd.ones((3,)),
          mxt.nd.ones((2, 2), dtype="bfloat16")]
    gs = [mxt.nd.ones(w.shape, dtype=w.data.dtype) for w in ws]
    fused([0, 1, 2], ws, gs)
    assert sorted(f for f, _ in calls) == ["adam", "mp_adam"]
    assert [fused.formula(w, upd.states[i]) for i, w in enumerate(ws)] == \
        ["mp_adam", "adam", "mp_adam"]
    master, (mean, var) = upd.states[0]
    assert [s.data for s in fused._kernel_states(0)] == \
        [mean.data, var.data, master.data]
    assert FORMULAS["mp_adam"][:3] == (5, mp_adam_update, 3)


def test_mp_adam_plain_is_adam_on_the_master():
    """The plain function: Adam's update of the master from the gradient
    in f32, the weight its rounding."""
    rng = np.random.RandomState(3)
    w32 = torch.from_numpy(rng.randn(50).astype(np.float32))
    g = torch.from_numpy(rng.randn(50).astype(np.float32)).bfloat16()
    states = [torch.rand(50) for _ in range(2)]
    kw = dict(lr=0.02, beta1=0.7, beta2=0.9, epsilon=1e-6, wd=0.1,
              rescale_grad=0.5, clip_gradient=0.3)
    master, ref = w32.clone(), w32.clone()
    mean, var = (s.clone() for s in states)
    weight = w32.bfloat16()
    mp_adam_update(weight, g, mean, var, master, **kw)
    adam_update(ref, g.float(), *states, **kw)
    assert torch.equal(master, ref)
    assert torch.equal(mean, states[0]) and torch.equal(var, states[1])
    assert torch.equal(weight, ref.bfloat16())


def _bf16_mlp(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=4),
                pkg.gluon.nn.Dense(3, in_units=8))
    with pkg.cpu():
        net.initialize(pkg.init.Xavier())
    net.cast("bfloat16")
    return net


def _steps(pkg, net, trainer, batches):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in batches:
        with pkg.autograd.record():
            out = net(pkg.nd.array(x, ctx=pkg.cpu(), dtype="bfloat16"))
            loss = loss_fn(out.astype("float32"),
                           pkg.nd.array(y, ctx=pkg.cpu()))
        loss.backward()
        trainer.step(6)


def test_trainer_state_file(tmp_path):
    """A bf16 MLP under ``Adam(multi_precision=True)``: 2 steps,
    ``save_states``, a fresh ``Trainer`` that loads the file and a third
    step equal bit for bit to 3 steps without a break. The file holds,
    per index, ``(master, (mean, var))`` as numpy arrays, the JAX
    package's format: the JAX ``Updater`` reads it."""
    rng = np.random.RandomState(0)
    batches = [(rng.randn(6, 4).astype("f"),
                rng.randint(0, 3, 6).astype("f")) for _ in range(3)]
    opt = {"learning_rate": 0.01, "wd": 1e-4, "multi_precision": True}
    nets = [_bf16_mlp(mxt) for _ in range(2)]
    host = {n: p.data().data.clone()
            for n, p in nets[0].collect_params().items()}
    for n, p in nets[1].collect_params().items():
        p.set_data(mxt.nd.NDArray(host[n].clone(), mxt.cpu()))
    whole = mxt.gluon.Trainer(nets[0].collect_params(), "adam", dict(opt))
    _steps(mxt, nets[0], whole, batches)
    first = mxt.gluon.Trainer(nets[1].collect_params(), "adam", dict(opt))
    _steps(mxt, nets[1], first, batches[:2])
    fname = str(tmp_path / "mlp.states")
    first.save_states(fname)
    fresh = mxt.gluon.Trainer(nets[1].collect_params(), "adam", dict(opt))
    fresh.load_states(fname)
    _steps(mxt, nets[1], fresh, batches[2:])
    for (n, a), (_, b) in zip(sorted(nets[0].collect_params().items()),
                              sorted(nets[1].collect_params().items())):
        assert torch.equal(a.data().data, b.data().data), n
    with open(fname, "rb") as f:
        blob = f.read()
    states = pickle.loads(blob)
    states = states[0] if isinstance(states, tuple) else states
    for master, (mean, var) in states.values():
        assert master.dtype == mean.dtype == var.dtype == np.float32
    upd = mx.optimizer.get_updater(mx.optimizer.create(
        "adam", multi_precision=True))
    upd.set_states(blob)
    for i, (master, (mean, var)) in states.items():
        j_master, (j_mean, j_var) = upd.states[i]
        np.testing.assert_array_equal(j_master.asnumpy(), master)
        np.testing.assert_array_equal(j_var.asnumpy(), var)
