"""The port's single-process KVStore against the JAX package's, and
``Module`` and ``gluon.Trainer`` with a KVStore object.

Every test of `tests/test_kvstore.py` runs as a parity case: the same
pushes, pulls and updaters through ``mxnet_tpu.kv`` and
``mxnet_tpu_torch.kv`` on the CPU, their pulled values compared (rtol
1e-6), and the same errors raised. A ``Module`` and a Gluon ``Trainer``
handed a ``kv.create("local")`` object update on the store (a list push
and pull for the Module, a push and pull a parameter for the Trainer) for
3 steps in both packages (rtol 1e-5, atol 1e-6, the optimizer tests'
tolerance over several updates). The JAX executor runs with
``MXNET_XLA_STATS=0`` (ROADMAP's facts about the reference).
"""
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

TOL = {"rtol": 1e-6, "atol": 1e-7}
STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}
SHAPE = (4, 4)
KEYS = [5, 7, 11]


@pytest.fixture
def _plain_jit(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _init_kv(pkg, kv_type="local"):
    kv = pkg.kv.create(kv_type)
    kv.init(3, pkg.nd.zeros(SHAPE))
    kv.init(KEYS, [pkg.nd.zeros(SHAPE)] * len(KEYS))
    return kv


def _single_kv_pair(pkg):
    kv = _init_kv(pkg)
    kv.push(3, pkg.nd.ones(SHAPE))
    val = pkg.nd.empty(SHAPE)
    kv.pull(3, out=val)
    return [val.asnumpy()]


def _list_kv_pair(pkg):
    kv = _init_kv(pkg)
    kv.push(KEYS, [pkg.nd.ones(SHAPE) * 4] * len(KEYS))
    val = [pkg.nd.empty(SHAPE)] * len(KEYS)
    kv.pull(KEYS, out=val)
    return [v.asnumpy() for v in val]


def _aggregator_device_list(pkg):
    kv = _init_kv(pkg)
    devs = [pkg.cpu(0)] * 4
    kv.push(3, [pkg.nd.ones(SHAPE, ctx=d) for d in devs])
    out = pkg.nd.empty(SHAPE)
    kv.pull(3, out=out)
    kv.push(KEYS, [[pkg.nd.ones(SHAPE, ctx=d) * 2.0 for d in devs]]
            * len(KEYS))
    outs = [pkg.nd.empty(SHAPE) for _ in KEYS]
    kv.pull(KEYS, out=outs)
    return [out.asnumpy()] + [o.asnumpy() for o in outs]


def _updater(pkg):
    kv = _init_kv(pkg)

    def updater(key, recv, local):
        local += recv
    kv._set_updater(updater)
    kv.push(3, pkg.nd.ones(SHAPE))
    kv.push(3, pkg.nd.ones(SHAPE))
    out = pkg.nd.empty(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _string_keys(pkg):
    kv = pkg.kv.create("local")
    kv.init("w0", pkg.nd.ones(SHAPE))
    kv.push("w0", pkg.nd.ones(SHAPE) * 3)
    out = pkg.nd.empty(SHAPE)
    kv.pull("w0", out=out)
    with pytest.raises(pkg.MXNetError):
        kv.init(9, pkg.nd.ones(SHAPE))
    return [out.asnumpy()]


def _row_sparse_pull(pkg):
    kv = pkg.kv.create("local")
    w = pkg.nd.array(np.arange(12, dtype="f").reshape(6, 2))
    kv.init("emb", w)
    kv.push("emb", w)
    out = pkg.nd.zeros((6, 2))
    kv.row_sparse_pull("emb", out=out,
                       row_ids=pkg.nd.array(np.array([1, 4], "f")))
    return [out.asnumpy()]


def _set_optimizer_and_states_roundtrip(pkg, tmp_path):
    kv = _init_kv(pkg)
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    kv.push(3, pkg.nd.ones(SHAPE))
    fname = str(tmp_path / ("states_" + pkg.__name__))
    kv.save_optimizer_states(fname)
    kv.load_optimizer_states(fname)
    kv.push(3, pkg.nd.ones(SHAPE) * 0.5)
    out = pkg.nd.empty(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _invalid_kvstore_type(pkg):
    with pytest.raises(pkg.MXNetError):
        pkg.kv.create("no_such_store")
    return []


def _double_init_errors(pkg):
    kv = _init_kv(pkg)
    with pytest.raises(pkg.MXNetError):
        kv.init(3, pkg.nd.zeros(SHAPE))
    return []


CASES = {
    "single_kv_pair": _single_kv_pair,
    "list_kv_pair": _list_kv_pair,
    "aggregator_device_list": _aggregator_device_list,
    "updater": _updater,
    "string_keys": _string_keys,
    "row_sparse_pull": _row_sparse_pull,
    "set_optimizer_and_states_roundtrip": _set_optimizer_and_states_roundtrip,
    "invalid_kvstore_type": _invalid_kvstore_type,
    "double_init_errors": _double_init_errors,
}


def test_every_jax_kvstore_test_is_a_case():
    src = (Path(__file__).parent / "test_kvstore.py").read_text()
    names = {line[len("def test_"):line.index("(")]
             for line in src.splitlines() if line.startswith("def test_")}
    assert names == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_kvstore_case(name, tmp_path):
    case = CASES[name]
    args = (tmp_path,) if name == "set_optimizer_and_states_roundtrip" else ()
    want, got = (case(pkg, *args) for pkg in (mx, mxt))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, **TOL)


def test_store_types_and_identity():
    for name in ("local", "device", "nccl", "tpu", "local_allreduce_cpu",
                 "local_allreduce_device"):
        kv = mxt.kv.create(name)
        assert (kv.type, kv.rank, kv.num_workers) == (name, 0, 1)
        kv.barrier()
    assert mxt.kvstore_create is mxt.kv.create and mxt.kvstore is mxt.kv
    for name in ("dist_sync", "dist_async", "dist_sync_device", "dist"):
        with pytest.raises(mxt.MXNetError, match="A.10"):
            mxt.kv.create(name)
    with pytest.raises(mxt.MXNetError, match="A.10"):
        mxt.kv.create("local").set_gradient_compression({"type": "2bit"})
    with pytest.raises(mxt.MXNetError, match="A.10"):
        mxt.kvstore.AsyncKVStore()
    with pytest.raises(TypeError):
        mxt.kv.create(3)


def test_dense_list_push_updates_in_one_fused_call(monkeypatch):
    """A list push with the standard Updater goes through FusedApplier
    once; a custom updater function is called key by key."""
    calls = []
    orig = mxt.optimizer.FusedApplier.__call__

    def spy(self, idx, ws, gs):
        calls.append(list(idx))
        return orig(self, idx, ws, gs)
    monkeypatch.setattr(mxt.optimizer.FusedApplier, "__call__", spy)
    kv = _init_kv(mxt)
    kv.set_optimizer(mxt.optimizer.SGD(learning_rate=0.1))
    kv.push(KEYS, [mxt.nd.ones(SHAPE)] * len(KEYS))
    assert calls == [KEYS]
    out = mxt.nd.empty(SHAPE)
    kv.pull(7, out=out)
    np.testing.assert_allclose(out.asnumpy(), -0.1, **TOL)


# -- Module and Trainer with a KVStore object --------------------------------
def _batches():
    rng = np.random.RandomState(7)
    return [(rng.randn(6, 4).astype("f"), rng.randint(0, 3, 6).astype("f"))
            for _ in range(3)]


def _module(pkg, params, kv):
    data = pkg.sym.var("data")
    fc1 = pkg.sym.Activation(pkg.sym.FullyConnected(
        data, num_hidden=8, name="fc1"), act_type="relu")
    out = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        fc1, num_hidden=3, name="fc2"), name="softmax")
    mod = pkg.mod.Module(out, context=pkg.cpu())
    mod.bind([("data", (6, 4))], [("softmax_label", (6,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in params.items()})
    mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4)))
    return mod


def test_module_with_a_kvstore_object_matches_jax(_plain_jit, tmp_path):
    rng = np.random.RandomState(4)
    params = {"fc1_weight": rng.randn(8, 4).astype("f") * 0.5,
              "fc1_bias": np.zeros(8, "f"),
              "fc2_weight": rng.randn(3, 8).astype("f") * 0.5,
              "fc2_bias": np.zeros(3, "f")}
    out = {}
    for pkg in (mx, mxt):
        kv = pkg.kv.create("local")
        mod = _module(pkg, params, kv)
        assert mod._update_on_kvstore and mod._kvstore is kv
        assert sorted(kv._store) == list(range(4))
        for x, y in _batches():
            mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                         [pkg.nd.array(y, ctx=pkg.cpu())]),
                        is_train=True)
            mod.backward()
            mod.update()
        out[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        mod.save_optimizer_states(str(tmp_path / pkg.__name__))
    for k in out[mx]:
        np.testing.assert_allclose(out[mxt][k], out[mx][k], err_msg=k,
                                   **STEP_TOL)
    # the port reads the JAX store's state file
    kv = mxt.kv.create("local")
    mod = _module(mxt, params, kv)
    mod.load_optimizer_states(str(tmp_path / "mxnet_tpu"))
    assert sorted(kv._updater.states) == list(range(4))
    # a local name on one device is no kvstore, as before
    assert _module(mxt, params, "local")._kvstore is None


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=4),
                pkg.gluon.nn.Dense(3, in_units=8))
    with pkg.cpu():
        net.initialize(pkg.init.Xavier())
    return net


@pytest.mark.parametrize("update_on_kvstore", [None, False])
def test_trainer_with_a_kvstore_object_matches_jax(_plain_jit,
                                                   update_on_kvstore):
    """3 Adam steps of a small MLP with a ``kv.create("local")`` store:
    updating on the store (the default) and reducing on it
    (``update_on_kvstore=False``, then ``FusedApplier``)."""
    jnet, tnet = _mlp(mx), _mlp(mxt)
    for (_, a), (_, b) in zip(sorted(jnet.collect_params().items()),
                              sorted(tnet.collect_params().items())):
        b.set_data(mxt.nd.array(a.data().asnumpy(), ctx=mxt.cpu()))
    out = {}
    for pkg, net in ((mx, jnet), (mxt, tnet)):
        kv = pkg.kv.create("local")
        trainer = pkg.gluon.Trainer(
            net.collect_params(), "adam", {"learning_rate": 0.01,
                                           "wd": 1e-4},
            kvstore=kv, update_on_kvstore=update_on_kvstore)
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for x, y in _batches():
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.nd.array(x, ctx=pkg.cpu())),
                               pkg.nd.array(y, ctx=pkg.cpu()))
            loss.backward()
            trainer.step(6)
        assert trainer._kvstore is kv
        assert bool(trainer._update_on_kvstore) == (update_on_kvstore is None)
        out[pkg] = {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}
    for n in out[mx]:
        np.testing.assert_allclose(out[mxt][n], out[mx][n], err_msg=n,
                                   **STEP_TOL)


def test_trainer_update_on_kvstore_with_a_local_name(_plain_jit):
    """``update_on_kvstore=True`` with a single-process name is accepted
    and updates directly (no store), as in the JAX package; ``update()``
    refuses a store that updates."""
    net = _mlp(mxt)
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}, kvstore="local",
                                update_on_kvstore=True)
    trainer.allreduce_grads()
    assert trainer._kvstore is None and trainer._update_on_kvstore is False
    other = mxt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1},
                              kvstore=mxt.kv.create("local"))
    with pytest.raises(mxt.MXNetError, match="update_on_kvstore"):
        other.update(6)
