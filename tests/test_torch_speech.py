"""The CTC speech model of `examples/speech_recognition/train_am.py` on the
port, against the JAX package, on the CPU.

The example's graph (``am_symbol``: FullyConnected + relu -> RNN(lstm) ->
FullyConnected -> CTCLoss, blank first) at narrow widths (8 features, 6
classes with the blank, 16 hidden units, batch 4), bucketed over two
utterance lengths by ``BucketingModule`` as the example binds it: from the
same parameters, 2 steps over the two buckets in both packages (SGD lr 0.1,
and Adam at the example's lr 0.02), the per-sample CTC losses after each
step and every parameter after each update at rtol 1e-5, atol 1e-6 (f32
both sides, differing in summation order only); then the example's
scores-only decode ``Module`` at batch 1 from the trained parameters, its
softmax scores at the same tolerance. The JAX package runs with
``MXNET_XLA_STATS=0`` (see `test_torch_module.py`).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

F, C, H, BATCH, L = 8, 6, 16, 4, 5
BUCKETS = (12, 20)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _plain_jit(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _symbol(pkg, t, decode=False):
    data = pkg.sym.Variable("data")
    proj = pkg.sym.FullyConnected(pkg.sym.Reshape(data, shape=(-1, F)),
                                  num_hidden=H, name="proj")
    proj = pkg.sym.Activation(proj, act_type="relu")
    proj = pkg.sym.Reshape(proj, shape=(-1, t, H))
    rnn = pkg.sym.RNN(pkg.sym.transpose(proj, axes=(1, 0, 2)), state_size=H,
                      num_layers=1, mode="lstm", name="lstm")
    scores = pkg.sym.FullyConnected(pkg.sym.Reshape(rnn, shape=(-1, H)),
                                    num_hidden=C, name="cls")
    scores = pkg.sym.Reshape(scores, shape=(t, -1, C))
    if decode:
        return pkg.sym.softmax(scores, axis=-1)
    return pkg.sym.CTCLoss(scores, pkg.sym.Variable("ctc_label"), name="ctc")


def _batches(seed=0):
    """One batch a bucket: frames from templates of each symbol, 2-3
    frames a symbol, zero-padded; labels 0-padded (0 is the blank)."""
    rng = np.random.RandomState(seed)
    templates = rng.randn(C, F).astype(np.float32) * 2
    out = []
    for t in BUCKETS:
        x = np.zeros((BATCH, t, F), np.float32)
        y = np.zeros((BATCH, L), np.float32)
        for j in range(BATCH):
            n = rng.randint(2, min(L, t // 3) + 1)
            lab = rng.randint(1, C, n)
            frames = np.concatenate([np.tile(templates[p], (rng.randint(2, 4),
                                                            1))
                                     for p in lab])[:t]
            x[j, :len(frames)] = frames + 0.15 * rng.randn(len(frames), F)
            y[j, :n] = lab
        out.append((t, x, y))
    return out


def _weights():
    rng = np.random.RandomState(1)
    n = 4 * H * (H + H) + 8 * H
    return {"proj_weight": rng.randn(H, F) * 0.3, "proj_bias": np.zeros(H),
            "lstm_parameters": rng.uniform(-0.2, 0.2, n),
            "lstm_state": np.zeros((1, BATCH, H)),
            "lstm_state_cell": np.zeros((1, BATCH, H)),
            "cls_weight": rng.randn(C, H) * 0.3, "cls_bias": np.zeros(C)}


def _train(pkg, optimizer, opt_params):
    def sym_gen(t):
        return _symbol(pkg, t), ("data",), ("ctc_label",)
    key = max(BUCKETS)
    mod = pkg.mod.BucketingModule(sym_gen, default_bucket_key=key,
                                  context=pkg.cpu())
    mod.bind(data_shapes=[("data", (BATCH, key, F))],
             label_shapes=[("ctc_label", (BATCH, L))])
    mod.init_params(arg_params={
        n: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
        for n, v in _weights().items()})
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    steps = []
    for t, x, y in _batches():
        batch = pkg.io.DataBatch(
            [pkg.nd.array(x, ctx=pkg.cpu())], [pkg.nd.array(y, ctx=pkg.cpu())],
            bucket_key=t, provide_data=[("data", (BATCH, t, F))],
            provide_label=[("ctc_label", (BATCH, L))])
        mod.forward_backward(batch)
        loss = mod.get_outputs()[0].asnumpy()
        mod.update()
        steps.append((loss, {n: a.asnumpy()
                             for n, a in mod.get_params()[0].items()}))
    return mod, steps


def _decode(pkg, mod):
    arg, aux = mod.get_params()
    arg = {k: v for k, v in arg.items()
           if not k.endswith("state") and not k.endswith("state_cell")}
    t, x, _ = _batches()[0]
    infer = pkg.mod.Module(_symbol(pkg, t, decode=True), data_names=("data",),
                           label_names=None, context=pkg.cpu())
    infer.bind(data_shapes=[("data", (1, t, F))], for_training=False)
    infer.set_params(arg, aux, allow_missing=True)
    infer.forward(pkg.io.DataBatch([pkg.nd.array(x[:1], ctx=pkg.cpu())]),
                  is_train=False)
    return infer.get_outputs()[0].asnumpy()


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.1}), ("adam", {"learning_rate": 0.02})])
def test_bucketed_speech_steps_and_decode_match_jax(optimizer, opt_params):
    jmod, want = _train(mx, optimizer, opt_params)
    tmod, got = _train(mxt, optimizer, opt_params)
    assert len(got) == len(want) == len(BUCKETS)
    for (gl, gp), (wl, wp) in zip(got, want):
        assert gl.shape == wl.shape == (BATCH,)
        np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=ATOL)
        assert sorted(gp) == sorted(wp)
        for name in wp:
            np.testing.assert_allclose(gp[name], wp[name], rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    default = tmod._buckets[max(BUCKETS)]
    other = tmod._buckets[min(BUCKETS)]
    for name in default._param_names:
        assert other._exec.arg_dict[name] is default._exec.arg_dict[name]
    got_p, want_p = _decode(mxt, tmod), _decode(mx, jmod)
    assert got_p.shape == (BUCKETS[0], 1, C)
    np.testing.assert_allclose(got_p, want_p, rtol=RTOL, atol=ATOL)
