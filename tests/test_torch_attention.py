"""The attention slice of the port on the CPU, against the JAX package.

- ``flash_attention`` (K4's plain version on a CPU tensor) against the
  Pallas ``flash_attention`` in interpret mode, f32 and bf16, causal or
  not, ragged T, Tq != Tk both ways (the causal mask is aligned at the
  top left in both) and a given scale; its gradients through
  ``FlashAttention`` (the dense recompute) against ``jax.vjp``;
- ``_contrib_flash_attention`` through ``nd.contrib`` and, bound by an
  executor, through ``sym.contrib`` (forward and backward);
- ``LayerNorm`` forward and gradients in f32 and bf16;
- a causal attention LM (the long-context example's block structure at
  E=32, 4 heads of 8, T=24, vocab 50, 2 layers) trained for two
  SGD-momentum ``Module`` steps in both packages from the same weights.

The JAX package runs with ``MXNET_XLA_STATS=0`` (see
`test_torch_module.py`), the Pallas kernel with ``block_q = block_k =
16`` as `tests/test_pallas.py` runs it. Tolerances are the reference's
own in f32: 2e-5 for the attention forward, 1e-4 for gradients and for
parameters after two steps. In bf16 both packages compute in f32 and
round once to bf16, so a value may land one bf16 step (2^-7 relative)
apart where the two f32 results straddle a rounding boundary: the bf16
forward is held to ``rtol = 2^-7`` (plus 1e-6 absolute for values near
zero). LayerNorm's bf16 path rounds twice more (the normalised value,
then the affine product), so its forward is held to two bf16 steps; its
bf16 gradients reduce bf16 products over the rows in another order than
XLA and are held to 2^-5 relative and absolute.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops.attention_kernel import (
    FlashAttention, dense_attention_plain, flash_attention,
    flash_attention_plain, tma_operands)

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-6
BLOCK = 16

# (B, Tq, Tk, H, D): ragged against the 16-blocks; Tq != Tk both ways
SHAPES = [(2, 40, 40, 2, 16), (1, 24, 40, 2, 8), (2, 40, 24, 3, 8)]


@pytest.fixture(autouse=True)
def _plain_jit(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _qkv(b, tq, tk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32)
            for t in (tq, tk, tk)]


def _jax_flash(arrays, dtype, **kw):
    args = [jnp.asarray(a).astype(dtype) for a in arrays]
    out = jflash(*args, block_q=BLOCK, block_k=BLOCK, **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_pallas(shape, causal, dtype):
    arrays = _qkv(*shape)
    want = _jax_flash(arrays, dtype, causal=causal)
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    before = flash_attention.launches
    got = flash_attention(*[torch.from_numpy(a).to(tdtype) for a in arrays],
                          causal=causal, block_q=BLOCK, block_k=BLOCK)
    assert flash_attention.launches == before    # CPU: the plain version
    assert got.dtype == tdtype and tuple(got.shape) == arrays[0].shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL,
                                   atol=FWD_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_RTOL, atol=BF16_ATOL)


# head dims above 128 (ROADMAP C.15: the card's kernel now takes D up to
# 256; its plain version is held here, the kernel on the card). Above 128
# the Pallas kernel takes multiples of 128 only: D = 160 raises there.
WIDE_SHAPES = [(1, 24, 40, 2, 256), (2, 40, 24, 1, 256)]


@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_pallas_above_head_dim_128(shape, causal, dtype):
    test_forward_matches_pallas(shape, causal, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_160_the_pallas_kernel_refuses(causal):
    """The JAX kernel refuses D = 160; the port's plain version computes
    it, equal to the dense f32 attention (the card's kernel takes it too,
    `tests/test_torch_cuda.py`)."""
    arrays = _qkv(2, 40, 24, 1, 160)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        _jax_flash(arrays, "float32", causal=causal)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = flash_attention(q, k, v, causal=causal)
    want = dense_attention_plain(q.double(), k.double(), v.double(),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_given_scale_matches_pallas(causal):
    arrays = _qkv(*SHAPES[1], seed=1)
    want = _jax_flash(arrays, "float32", causal=causal, scale=0.3)
    got = flash_attention_plain(*[torch.from_numpy(a) for a in arrays],
                                scale=0.3, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


def test_causal_rows_slice():
    """``q_start`` gives the rows of the whole at absolute positions (how
    the card compares long sequences on a sample of rows)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 40, 40, 2, 8, seed=2))
    whole = flash_attention_plain(q, k, v, causal=True)
    tail = flash_attention_plain(q[:, 29:], k, v, causal=True, q_start=29)
    torch.testing.assert_close(tail, whole[:, 29:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_vjp(shape, causal):
    arrays = _qkv(*shape, seed=3)
    cot = np.random.RandomState(4).randn(*arrays[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jflash(q, k, v, causal=causal,
                                            block_q=BLOCK, block_k=BLOCK),
                     *[jnp.asarray(a) for a in arrays])
    want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = FlashAttention.apply(*leaves, None, causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_dense_attention_matches_flash_in_f32():
    arrays = [torch.from_numpy(a) for a in _qkv(*SHAPES[2], seed=5)]
    torch.testing.assert_close(dense_attention_plain(*arrays, causal=True),
                               flash_attention_plain(*arrays, causal=True),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_meta_tensors_give_the_shape_only():
    q = torch.empty((2, 7, 3, 8), device="meta")
    k = torch.empty((2, 5, 3, 8), device="meta")
    before = flash_attention.launches
    out = flash_attention(q, k, k, causal=True)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 7, 3, 8)
    assert flash_attention.launches == before


def test_rejects_bad_shapes():
    q = torch.zeros((2, 7, 3, 8))
    with pytest.raises(mxt.MXNetError, match="flash_attention"):
        kv = torch.zeros((2, 5, 3, 4))
        flash_attention(q, kv, kv)


# ------------------------------------- the bf16 kernel's TMA preparation
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _unaligned(t):
    """``t``'s values in a contiguous view one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    off = -buf.data_ptr() % 16 // t.element_size() + 1
    view = buf[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("d", [7, 37])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tma_operands_pad_head_dim(d, causal, dtype):
    """D zero-padded to a multiple of 8: the first D columns of the padded
    inputs' attention, at the original D's scale, are the original
    inputs' attention, exactly."""
    q, k, v = (torch.from_numpy(a).to(TORCH_DTYPES[dtype])
               for a in _qkv(2, 24, 40, 3, d, seed=13))
    ready = tma_operands(q, k, v)
    for t, orig in zip(ready, (q, k, v)):
        assert t.is_contiguous() and t.shape[-1] % 8 == 0
        assert t.data_ptr() % 16 == 0 and t.dtype == orig.dtype
        torch.testing.assert_close(t[..., :d], orig, rtol=0, atol=0)
        assert not t[..., d:].any()
    got = flash_attention_plain(*ready, scale=1.0 / d ** 0.5,
                                causal=causal)[..., :d]
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tma_operands_pad_tiny_head_dim():
    """At D = 3 the CPU's einsum sums the 3 and the 8 columns in another
    order, so the padded result is held to f32 rounding, not exactly."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 24, 40, 3, 3, seed=14))
    got = flash_attention_plain(*tma_operands(q, k, v),
                                scale=1.0 / 3 ** 0.5, causal=True)[..., :3]
    want = flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tma_operands_copy_unaligned(causal, dtype):
    """Views that start off a 16-byte boundary are copied to aligned
    tensors with the same values; the attention is the same, exactly."""
    q, k, v = (torch.from_numpy(a).to(TORCH_DTYPES[dtype])
               for a in _qkv(1, 30, 20, 2, 16, seed=15))
    views = [_unaligned(t) for t in (q, k, v)]
    assert all(t.data_ptr() % 16 for t in views)
    ready = tma_operands(*views)
    for t, orig in zip(ready, (q, k, v)):
        assert t.data_ptr() % 16 == 0 and t.shape == orig.shape
        torch.testing.assert_close(t, orig, rtol=0, atol=0)
    torch.testing.assert_close(flash_attention_plain(*ready, causal=causal),
                               flash_attention_plain(q, k, v, causal=causal),
                               rtol=0, atol=0)


def test_tma_operands_keep_ready_inputs():
    """Contiguous, aligned inputs with D a multiple of 8 are passed as they
    are: no copy on the main path."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 8, 8, 2, 16))
    assert all(a is b for a, b in zip(tma_operands(q, k, v), (q, k, v)))


# ---------------------------------------------------------------- the op
def test_nd_contrib_matches_jax():
    arrays = _qkv(*SHAPES[1], seed=6)
    want = mx.nd.contrib.flash_attention(
        *[mx.nd.array(a) for a in arrays], causal=True, block_q=BLOCK,
        block_k=BLOCK).asnumpy()
    got = mxt.nd.contrib.flash_attention(
        *[mxt.nd.array(a, ctx=mxt.cpu()) for a in arrays], causal=True,
        block_q=BLOCK, block_k=BLOCK).asnumpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    assert mxt.nd.flash_attention is not None     # the alias


def _attention_sym(pkg, **attrs):
    q, k, v = (pkg.sym.var(n) for n in ("q", "k", "v"))
    return pkg.sym.contrib.flash_attention(q, k, v, name="att", **attrs)


@pytest.mark.parametrize("attrs", [{"causal": True},
                                   {"causal": False, "scale": 0.25},
                                   {"causal": True, "scale": None}])
def test_sym_contrib_executor_matches_jax(attrs):
    b, tq, tk, h, d = SHAPES[1]
    arrays = _qkv(*SHAPES[1], seed=7)
    cot = np.random.RandomState(8).randn(b, tq, h, d).astype(np.float32)
    tsym = mxt.sym.load_json(_attention_sym(mxt, **attrs).tojson())
    results = []
    for pkg, sym in ((mx, _attention_sym(mx, block_q=BLOCK, block_k=BLOCK,
                                         **attrs)), (mxt, tsym)):
        assert sym.list_arguments() == ["q", "k", "v"]
        shapes = dict(zip("qkv", (a.shape for a in arrays)))
        assert sym.infer_shape(**shapes)[1] == [(b, tq, h, d)]
        ex = sym.simple_bind(pkg.cpu(), grad_req="write", **shapes)
        for name, a in zip("qkv", arrays):
            ex.arg_dict[name][:] = a
        ex.forward(is_train=True)
        ex.backward(pkg.nd.array(cot))
        results.append([ex.outputs[0].asnumpy()]
                       + [ex.grad_dict[n].asnumpy() for n in "qkv"])
    want, got = results
    np.testing.assert_allclose(got[0], want[0], rtol=FWD_TOL, atol=FWD_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


# --------------------------------------------------------------- LayerNorm
def _layer_norm_run(pkg, x, gamma, beta, cot, dtype):
    data = pkg.sym.var("data")
    sym = pkg.sym.LayerNorm(data, name="ln")
    assert sym.list_arguments() == ["data", "ln_gamma", "ln_beta"]
    assert sym.list_outputs() == ["ln0_output"]     # one visible output
    ex = sym.simple_bind(pkg.cpu(), grad_req="write", data=x.shape,
                         type_dict={n: dtype for n in
                                    ("data", "ln_gamma", "ln_beta")})
    for name, a in (("data", x), ("ln_gamma", gamma), ("ln_beta", beta)):
        ex.arg_dict[name][:] = pkg.nd.array(a, dtype=dtype)
    ex.forward(is_train=True)
    ex.backward(pkg.nd.array(cot, dtype=dtype))
    to32 = (lambda a: a.astype("float32").asnumpy()) if pkg is mx \
        else (lambda a: a.data.float().numpy())
    return [to32(ex.outputs[0])] + [to32(ex.grad_dict[n]) for n in
                                    ("data", "ln_gamma", "ln_beta")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.RandomState(9)
    x = (rng.randn(2, 6, 24) * 3 + 1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    beta = (rng.randn(24) * 0.1).astype(np.float32)
    cot = rng.randn(2, 6, 24).astype(np.float32)
    if dtype == "bfloat16":      # both packages start from the same bits
        x, gamma, beta, cot = (a.astype(ml_dtypes.bfloat16).astype(
            np.float32) for a in (x, gamma, beta, cot))
    want = _layer_norm_run(mx, x, gamma, beta, cot, dtype)
    got = _layer_norm_run(mxt, x, gamma, beta, cot, dtype)
    if dtype == "float32":
        tols = [(FWD_TOL, FWD_TOL)] + [(GRAD_TOL, GRAD_TOL)] * 3
    else:
        tols = [(2 * BF16_RTOL, 2 * BF16_RTOL)] + [(2 ** -5, 2 ** -5)] * 3
    for g, w, (rtol, atol) in zip(got, want, tols):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_layer_norm_hidden_outputs():
    x = np.random.RandomState(10).randn(3, 5).astype(np.float32)
    cpu = mxt.cpu()
    out, mean, std = mxt.nd.LayerNorm(
        mxt.nd.array(x, ctx=cpu), mxt.nd.array(np.ones(5), ctx=cpu),
        mxt.nd.array(np.zeros(5), ctx=cpu))
    np.testing.assert_allclose(mean.asnumpy(), x.mean(-1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(std.asnumpy(), np.sqrt(x.var(-1) + 1e-5),
                               rtol=1e-6)
    np.testing.assert_allclose(out.asnumpy(), (x - x.mean(-1, keepdims=True))
                               / np.sqrt(x.var(-1, keepdims=True) + 1e-5),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ attention LM
VOCAB, EMBED, HEADS, LAYERS, SEQ, BATCH = 50, 32, 4, 2, 24, 2
OPT = {"learning_rate": 0.05, "momentum": 0.9}


def attention_lm(pkg, vocab, embed, heads, layers):
    """The long-context example's causal LM as a graph: pre-norm blocks of
    attention and a relu MLP with residual adds, no biases (LayerNorm and
    relu stand in for the example's RMS norm and gelu), data (B, T),
    labels (B*T,)."""
    sym = pkg.sym
    x = sym.Embedding(sym.var("data"), input_dim=vocab, output_dim=embed,
                      name="embed")
    for i in range(layers):
        h = sym.LayerNorm(x, name="ln%d_att" % i)
        q, k, v = (sym.Reshape(sym.FullyConnected(
            h, num_hidden=embed, flatten=False, no_bias=True,
            name="%s%d" % (n, i)),
            shape=(0, 0, heads, embed // heads)) for n in "qkv")
        att = sym.contrib.flash_attention(q, k, v, causal=True,
                                          name="att%d" % i)
        att = sym.FullyConnected(sym.Reshape(att, shape=(0, 0, -1)),
                                 num_hidden=embed, flatten=False,
                                 no_bias=True, name="proj%d" % i)
        x = sym.elemwise_add(x, att, name="res%d_att" % i)
        h = sym.LayerNorm(x, name="ln%d_mlp" % i)
        h = sym.Activation(sym.FullyConnected(
            h, num_hidden=4 * embed, flatten=False, no_bias=True,
            name="mlp%d_in" % i), act_type="relu", name="relu%d" % i)
        h = sym.FullyConnected(h, num_hidden=embed, flatten=False,
                               no_bias=True, name="mlp%d_out" % i)
        x = sym.elemwise_add(x, h, name="res%d_mlp" % i)
    logits = sym.FullyConnected(x, num_hidden=vocab, flatten=False,
                                no_bias=True, name="head")
    return sym.SoftmaxOutput(sym.Reshape(logits, shape=(-1, vocab)),
                             normalization="valid", name="softmax")


def _lm_weights(sym):
    shapes = sym.infer_shape(data=(BATCH, SEQ))[0]
    rng = np.random.RandomState(11)
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("weight"):
            a = rng.randn(*shape) / np.sqrt(shape[-1])
        elif name.endswith("gamma"):
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.randn(*shape) * 0.05
        out[name] = a.astype(np.float32)
    return out


def _lm_module(pkg, weights):
    mod = pkg.mod.Module(attention_lm(pkg, VOCAB, EMBED, HEADS, LAYERS),
                         context=pkg.cpu())
    mod.bind(data_shapes=[("data", (BATCH, SEQ))],
             label_shapes=[("softmax_label", (BATCH * SEQ,))])
    mod.init_params(arg_params={k: pkg.nd.array(v)
                                for k, v in weights.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    return mod


def test_attention_lm_symbol_matches_jax():
    jsym = attention_lm(mx, VOCAB, EMBED, HEADS, LAYERS)
    tsym = attention_lm(mxt, VOCAB, EMBED, HEADS, LAYERS)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    got = tsym.infer_shape(data=(BATCH, SEQ))
    want = jsym.infer_shape(data=(BATCH, SEQ))
    for g, w in zip(got, want):
        assert [tuple(s) for s in g] == [tuple(s) for s in w]


def test_attention_lm_two_module_steps_match():
    weights = _lm_weights(attention_lm(mxt, VOCAB, EMBED, HEADS, LAYERS))
    jmod, tmod = _lm_module(mx, weights), _lm_module(mxt, weights)
    rng = np.random.RandomState(12)
    for _ in range(2):
        data = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32)
        label = rng.randint(0, VOCAB, BATCH * SEQ).astype(np.float32)
        jmod._step(mx.io.DataBatch(data=[mx.nd.array(data)],
                                   label=[mx.nd.array(label)]))
        tmod._step(mxt.io.DataBatch(data=[mxt.nd.array(data)],
                                    label=[mxt.nd.array(label)]))
        got, want = (m.get_outputs()[0].asnumpy() for m in (tmod, jmod))
        assert got.shape == (BATCH * SEQ, VOCAB)
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=1e-6)
    got = mxt.params_to_numpy(tmod.get_params()[0])
    want = mxt.params_to_numpy(jmod.get_params()[0])
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
        assert not np.array_equal(got[name], weights[name]), name


@pytest.mark.parametrize("init", ["Xavier", "Uniform", "Normal"])
def test_initializer_draws_bf16_parameters_as_jax(init):
    """The bf16 attention LM is initialised in place on bf16 parameters:
    the draws match the JAX package's bit for bit."""
    want, got = mx.nd.zeros((40, 50), dtype="bfloat16"), \
        mxt.nd.zeros((40, 50), ctx=mxt.cpu(), dtype="bfloat16")
    for pkg, arr in ((mx, want), (mxt, got)):
        np.random.seed(3)
        getattr(pkg.init, init)()(pkg.init.InitDesc("w_weight"), arr)
    assert got.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.data.float().numpy(),
                                  want.astype("float32").asnumpy())
