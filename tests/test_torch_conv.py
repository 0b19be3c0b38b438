"""The ResNet slice's operators on the CPU, against the JAX package.

K5's plain version (``conv1x1_s2_dgrad_plain``, which a CPU tensor takes)
is held against the Pallas kernel ``mxnet_tpu.ops.conv_kernels.
conv1x1_s2_dgrad`` in interpret mode, at the shapes and tolerances of
`tests/test_conv_dgrad_kernel.py` (1e-4 in f32, 2e-2 in bf16). The
``Convolution``, ``BatchNorm``, ``Pooling``, ``Activation`` and
elementwise ops are held against the JAX ops: forward outputs through
each package's ``fcompute``, gradients through ``torch.autograd`` against
``jax.vjp`` with the same cotangent. Inputs are numpy draws from a seed.
Tolerances: f32 1e-4 relative and absolute (both sides f32; only the
summation order differs, over at most a few hundred terms); bf16 2e-2
(bf16 keeps 8 significant bits, 2^-8 = 3.9e-3 relative, and the two
frameworks round intermediates at different places).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import elemwise as _jelemwise  # noqa: F401  (registers)
from mxnet_tpu.ops.conv_kernels import conv1x1_s2_dgrad as pallas_dgrad
from mxnet_tpu.ops.registry import get_op as jget_op
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops.conv_kernel import (conv1x1_s2_dgrad,
                                             conv1x1_s2_dgrad_plain)
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops.registry import get_op

F32_TOL, BF16_TOL = 1e-4, 2e-2
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    _, jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(arr, jdt), torch.from_numpy(np.asarray(arr)).to(tdt)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# K5's plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [
    (4, 4, 4, 256, 128),      # (N, Ho, Wo, K, C), as test_conv_dgrad_kernel
    (2, 7, 7, 256, 128),
    (8, 2, 2, 128, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_matches_pallas(shape, dtype):
    n, ho, wo, k, c = shape
    rng = np.random.RandomState(0)
    jdy, tdy = _pair(rng.randn(n, ho, wo, k).astype(np.float32), dtype)
    jw, tw = _pair(rng.randn(k, c).astype(np.float32), dtype)
    before = conv1x1_s2_dgrad.launches
    got = conv1x1_s2_dgrad(tdy, tw, 2 * ho, 2 * wo)   # CPU: plain version
    assert conv1x1_s2_dgrad.launches == before
    want = pallas_dgrad(jdy, jw, 2 * ho, 2 * wo)
    assert got.dtype == tdy.dtype and tuple(got.shape) == want.shape
    _close(got, want, DTYPES[dtype][3])
    g = got.float().numpy()
    assert np.all(g[:, 1::2] == 0) and np.all(g[:, :, 1::2] == 0)


def test_k5_rejects_bad_shapes():
    dy = torch.zeros(1, 2, 2, 8)
    with pytest.raises(mxt.MXNetError, match="H==2\\*Ho"):
        conv1x1_s2_dgrad_plain(dy, torch.zeros(8, 4), 5, 4)
    with pytest.raises(mxt.MXNetError, match="no kernel for device"):
        conv1x1_s2_dgrad(dy.to("meta"), torch.zeros(8, 4, device="meta"),
                         4, 4)


# ---------------------------------------------------------------------------
# op-level parity helpers
# ---------------------------------------------------------------------------
def _run_both(op_name, params, arrays, dtype="float32", cot_seed=9,
              grad_inputs=None, n_outs=1):
    """Forward both packages' op and, for the first output, the gradients
    of ``grad_inputs`` (indices) under one random cotangent. Returns
    (torch outs, jax outs, torch grads, jax grads)."""
    grad_inputs = list(range(len(arrays))) if grad_inputs is None \
        else grad_inputs
    pairs = [_pair(a, dtype) for a in arrays]
    jins = [p[0] for p in pairs]
    tins = [p[1].requires_grad_(i in grad_inputs)
            for i, p in enumerate(pairs)]
    tp = dict(params)
    touts = get_op(op_name).fcompute(tp, *tins)
    jop = jget_op(op_name)

    def f(*xs):
        return tuple(jop.fcompute(dict(params), *xs))[:n_outs]
    jouts, vjp = jax.vjp(f, *jins)
    if not grad_inputs:
        return touts, jouts, [], []
    ct = np.random.RandomState(cot_seed).randn(*jouts[0].shape) \
        .astype(np.float32)
    jct, tct = _pair(ct, dtype)
    jgrads = vjp((jct,) + tuple(jnp.zeros_like(o) for o in jouts[1:]))
    tgrads = torch.autograd.grad(touts[0], [tins[i] for i in grad_inputs],
                                 tct)
    return touts, jouts, tgrads, [jgrads[i] for i in grad_inputs]


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------
CONV_CASES = {
    # name: (layout, data shape, weight shape, attrs)
    "nchw_3x3": ("NCHW", (2, 8, 9, 9), (6, 8, 3, 3),
                 {"kernel": (3, 3), "pad": (1, 1), "stride": (2, 2)}),
    "nhwc_3x3": ("NHWC", (2, 9, 9, 8), (6, 3, 3, 8),
                 {"kernel": (3, 3), "pad": (1, 1), "stride": (1, 1)}),
    "nchw_1x1_s2": ("NCHW", (2, 128, 6, 6), (16, 128, 1, 1),
                    {"kernel": (1, 1), "stride": (2, 2)}),
    "nhwc_1x1_s2": ("NHWC", (2, 6, 6, 128), (16, 1, 1, 128),
                    {"kernel": (1, 1), "stride": (2, 2)}),
    "nhwc_7x7_s2": ("NHWC", (2, 12, 12, 3), (8, 7, 7, 3),
                    {"kernel": (7, 7), "pad": (3, 3), "stride": (2, 2)}),
}


@pytest.mark.parametrize("gate", ["0", "1"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_jax(monkeypatch, case, gate):
    monkeypatch.setenv("MXNET_CONV1X1_PALLAS", gate)
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return conv1x1_s2_dgrad(*args)
    monkeypatch.setattr(tnn, "conv1x1_s2_dgrad", counted)
    layout, dshape, wshape, attrs = CONV_CASES[case]
    rng = np.random.RandomState(1)
    arrays = [rng.randn(*dshape), rng.randn(*wshape) * 0.2,
              rng.randn(wshape[0])]
    params = dict(attrs, num_filter=wshape[0], layout=layout)
    touts, jouts, tgrads, jgrads = _run_both(
        "Convolution", params, [a.astype(np.float32) for a in arrays])
    _close(touts[0], jouts[0], F32_TOL, "out")
    for name, g, w in zip(("data", "weight", "bias"), tgrads, jgrads):
        _close(g, w, F32_TOL, name)
    # the gate routes exactly the NHWC strided 1x1 conv's dgrad to K5
    want = gate == "1" and case == "nhwc_1x1_s2"
    assert len(calls) == int(want)


def test_convolution_gate_eligibility(monkeypatch):
    """K5 needs input channels a multiple of 128 and even H and W."""
    from mxnet_tpu_torch.ops.nn import _conv1x1_pallas_wanted
    monkeypatch.setenv("MXNET_CONV1X1_PALLAS", "1")
    args = ((1, 1), (2, 2), (0, 0), (1, 1), 1, True, 2)
    assert _conv1x1_pallas_wanted(*args, (2, 6, 6, 128))
    assert not _conv1x1_pallas_wanted(*args, (2, 6, 6, 96))
    assert not _conv1x1_pallas_wanted(*args, (2, 5, 6, 128))
    assert not _conv1x1_pallas_wanted((1, 1), (1, 1), (0, 0), (1, 1), 1,
                                      True, 2, (2, 6, 6, 128))
    monkeypatch.setenv("MXNET_CONV1X1_PALLAS", "0")
    assert not _conv1x1_pallas_wanted(*args, (2, 6, 6, 128))


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "train_fix_gamma", "train_fold",
                                  "eval", "eval_fold", "global_stats"])
def test_batchnorm_matches_jax(mode, dtype):
    tol = DTYPES[dtype][3]
    rng = np.random.RandomState(2)
    c = 6
    x = (rng.randn(4, 5, 5, c) * 2 + 1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    mm = rng.randn(c).astype(np.float32) * 0.1
    mv = rng.uniform(0.5, 2, c).astype(np.float32)
    params = {"axis": 3, "eps": 1e-5, "momentum": 0.9,
              "fix_gamma": mode == "train_fix_gamma",
              "use_global_stats": mode == "global_stats",
              "_is_train": mode.startswith("train") or mode == "global_stats"}
    fold = rng.randn(c).astype(np.float32) if mode.endswith("fold") else None
    # moving statistics stay f32 under bf16 data, as Module binds them
    pairs = [_pair(a, dtype) for a in (x, gamma, beta)]
    jins = [p[0] for p in pairs] + [jnp.asarray(mm), jnp.asarray(mv)]
    tins = [p[1].requires_grad_(True) for p in pairs] + \
        [torch.from_numpy(mm), torch.from_numpy(mv)]
    tp, jp = dict(params), dict(params)
    if fold is not None:
        jp["_fold_bias"], tp["_fold_bias"] = _pair(fold, dtype)
    touts = get_op("BatchNorm").fcompute(tp, *tins)
    jop = jget_op("BatchNorm")
    jouts, vjp = jax.vjp(
        lambda *xs: tuple(jop.fcompute(dict(jp), *xs, *jins[3:]))[:3],
        *jins[:3])
    jall = jop.fcompute(dict(jp), *jins)
    assert len(touts) == 5
    for k, what in enumerate(("out", "mean", "var", "moving_mean",
                              "moving_var")):
        _close(touts[k], jall[k], tol, what)
        if k:
            assert touts[k].dtype == torch.float32, what
    assert touts[0].dtype == tins[0].dtype
    ct = rng.randn(*x.shape).astype(np.float32)
    jct, tct = _pair(ct, dtype)
    jgrads = vjp((jct, jnp.zeros_like(jouts[1]), jnp.zeros_like(jouts[2])))
    tgrads = torch.autograd.grad(touts[0], tins[:3], tct, allow_unused=True)
    for name, g, w in zip(("data", "gamma", "beta"), tgrads, jgrads):
        if g is None:          # fix_gamma: gamma is not used
            assert name == "gamma" and mode == "train_fix_gamma"
            assert not np.asarray(w, np.float32).any()
            continue
        # gradients sum 100 terms: bf16 scales its tolerance by 4
        _close(g, w, tol * (4 if dtype == "bfloat16" else 1), name)


# ---------------------------------------------------------------------------
# Pooling and Activation
# ---------------------------------------------------------------------------
POOL_CASES = {
    "max_nhwc": ("NHWC", {"kernel": (3, 3), "stride": (2, 2),
                          "pad": (1, 1), "pool_type": "max"}),
    "max_nchw_full": ("NCHW", {"kernel": (3, 3), "stride": (2, 2),
                               "pool_type": "max",
                               "pooling_convention": "full"}),
    "max_fold_relu": ("NHWC", {"kernel": (3, 3), "stride": (2, 2),
                               "pad": (1, 1), "pool_type": "max",
                               "_fold_relu": True}),
    "avg_nchw": ("NCHW", {"kernel": (2, 2), "stride": (2, 2),
                          "pool_type": "avg"}),
    "avg_pad_exclude": ("NHWC", {"kernel": (3, 3), "stride": (1, 1),
                                 "pad": (1, 1), "pool_type": "avg",
                                 "count_include_pad": False}),
    "global_avg_nhwc": ("NHWC", {"kernel": (1, 1), "global_pool": True,
                                 "pool_type": "avg"}),
    "global_max_nchw": ("NCHW", {"kernel": (1, 1), "global_pool": True,
                                 "pool_type": "max"}),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    layout, attrs = POOL_CASES[case]
    shape = (2, 7, 7, 3) if layout == "NHWC" else (2, 3, 7, 7)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    touts, jouts, tgrads, jgrads = _run_both("Pooling",
                                             dict(attrs, layout=layout), [x])
    assert tuple(touts[0].shape) == jouts[0].shape
    _close(touts[0], jouts[0], F32_TOL, "out")
    _close(tgrads[0], jgrads[0], F32_TOL, "grad")


@pytest.mark.parametrize("layout", ["NCDHW", "NDHWC"])
@pytest.mark.parametrize("pool_type", ["avg", "sum"])
def test_pooling_3d_bf16_matches_jax(pool_type, layout):
    # torch's CPU avg_pool3d has no bf16 kernel: the port pools in f32 and
    # rounds once, the JAX op reduces in bf16; they may differ by one bf16
    # step (2^-7 relative) at the output's largest magnitude
    x = np.random.RandomState(3).randn(1, 2, 5, 5, 5).astype(np.float32)
    if layout == "NDHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 4, 1))
    attrs = {"kernel": (2, 2, 2), "stride": (2, 2, 2), "layout": layout,
             "pool_type": pool_type, "count_include_pad": False}
    jx, tx = _pair(x, "bfloat16")
    got = get_op("Pooling").fcompute(dict(attrs), tx)[0]
    want = np.asarray(jget_op("Pooling").fcompute(dict(attrs), jx)[0],
                      np.float32)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("act",["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_jax(act):
    x = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    touts, jouts, tgrads, jgrads = _run_both("Activation",
                                             {"act_type": act}, [x])
    _close(touts[0], jouts[0], F32_TOL)
    _close(tgrads[0], jgrads[0], F32_TOL)


@pytest.mark.parametrize("op,scalar", [
    ("broadcast_add", None), ("elemwise_add", None), ("_plus", None),
    ("broadcast_sub", None), ("broadcast_mul", None), ("broadcast_div", None),
    ("_plus_scalar", 1.5), ("_minus_scalar", 1.5), ("_rminus_scalar", 1.5),
    ("_mul_scalar", -2.0), ("_div_scalar", 4.0), ("_rdiv_scalar", 4.0),
    ("Flatten", None)])
def test_elementwise_matches_jax(op, scalar):
    rng = np.random.RandomState(5)
    a = rng.uniform(0.5, 2, (2, 3, 4)).astype(np.float32)
    arrays = [a] if scalar is not None or op == "Flatten" \
        else [a, rng.uniform(0.5, 2, (2, 3, 4)).astype(np.float32)]
    params = {} if scalar is None else {"scalar": scalar}
    touts, jouts, tgrads, jgrads = _run_both(op, params, arrays)
    _close(touts[0], jouts[0], F32_TOL)
    for g, w in zip(tgrads, jgrads):
        _close(g, w, F32_TOL)


def test_ndarray_arithmetic_and_imperative_ops():
    rng = np.random.RandomState(6)
    a, b = (rng.randn(2, 3).astype(np.float32) for _ in range(2))
    x, y = mxt.nd.array(a, ctx=mxt.cpu()), mxt.nd.array(b, ctx=mxt.cpu())
    for got, want in ((x + y, a + b), (x - y, a - b), (x * y, a * b),
                      (x / 2, a / 2), (2 - x, 2 - a), (1 / (x * x + 1),
                                                      1 / (a * a + 1)),
                      (-x, -a), (x + 1, a + 1)):
        np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6)
    out = mxt.nd.Activation(x, act_type="relu")
    np.testing.assert_array_equal(out.asnumpy(), np.maximum(a, 0))
    assert mxt.nd.Flatten(mxt.nd.zeros((2, 3, 4), ctx=mxt.cpu())).shape \
        == (2, 12)


def test_executor_bind_with_aux_states():
    """``Executor.bind`` takes the moving statistics as ``aux_states``; a
    training forward writes their new values into those arrays in place
    and matches ``simple_bind`` fed the same arrays."""
    data = mxt.sym.var("data")
    net = mxt.sym.BatchNorm(mxt.sym.Convolution(
        data, kernel=(3, 3), pad=(1, 1), num_filter=4, layout="NHWC",
        name="c"), axis=3, fix_gamma=False, name="bn")
    assert net.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]
    arg_shapes, _, aux_shapes = net.infer_shape(data=(2, 5, 5, 3))
    rng = np.random.RandomState(8)
    args = {n: mxt.nd.array(rng.randn(*s), ctx=mxt.cpu())
            for n, s in zip(net.list_arguments(), arg_shapes)}
    aux = [mxt.nd.array(np.zeros(aux_shapes[0]), ctx=mxt.cpu()),
           mxt.nd.array(np.ones(aux_shapes[1]), ctx=mxt.cpu())]
    ex = net.bind(mxt.cpu(), args, aux_states=aux)
    out = ex.forward(is_train=True)[0].asnumpy()
    mean = out.reshape(-1, 4).mean(0)
    np.testing.assert_allclose(mean, args["bn_beta"].asnumpy(), atol=1e-5)
    assert ex.aux_dict["bn_moving_mean"] is aux[0]
    assert not np.allclose(aux[0].asnumpy(), 0)     # updated in place
    ref = net.simple_bind(mxt.cpu(), grad_req="null", data=(2, 5, 5, 3))
    ref.copy_params_from(args, {"bn_moving_mean": np.zeros(4),
                                "bn_moving_var": np.ones(4)})
    np.testing.assert_allclose(ref.forward(is_train=True)[0].asnumpy(), out,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ref.aux_dict["bn_moving_mean"].asnumpy(),
                               aux[0].asnumpy(), rtol=1e-6, atol=1e-6)
