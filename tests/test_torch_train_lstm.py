"""The port's LSTM training layer against the JAX package's.

``FusedLSTM`` on the CPU runs the plain versions of K2 and K3; the JAX
package's ``fused_lstm`` runs its custom VJP, whose Pallas kernels
(``_lstm_fwd_train_kernel``, ``_lstm_bwd_kernel``) run in interpret mode
on the CPU, as `test_pallas.py` runs them. Both get the same inputs and
cotangents, made with numpy from a seed. Tolerances are the ones
`test_pallas.py` holds the Pallas kernels to: 1e-5 for forward values
and residuals, 1e-4 for gradients. The same file holds the RNN op's
routing (a layer that needs a gradient goes through ``FusedLSTM``; K1
refuses such inputs) and the ``SoftmaxOutput`` loss head against the JAX
op through ``jax.vjp``. `test_torch_cuda.py` holds the CUDA kernels
against the plain versions on the card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.ops.pallas_kernels import _lstm_vjp_fwd
from mxnet_tpu.ops.pallas_kernels import fused_lstm as jax_fused_lstm
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import lstm_kernel as lk
from mxnet_tpu_torch.ops.nn import rnn_param_size
from mxnet_tpu_torch.ops.registry import get_op

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# (T, B, I, H): as test_torch_lstm_kernel.py: a plain case, B=1, H and B
# off every tile size
SHAPES = [(5, 4, 6, 8), (4, 1, 5, 13), (3, 3, 7, 13), (6, 2, 16, 16)]


def _inputs(t, b, i, h, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(t, b, i).astype(np.float32),
            rng.randn(b, h).astype(np.float32),
            rng.randn(b, h).astype(np.float32),
            (rng.randn(i, 4 * h) * 0.1).astype(np.float32),
            (rng.randn(h, 4 * h) * 0.1).astype(np.float32),
            (rng.randn(4 * h) * 0.1).astype(np.float32)]


def _cotangents(t, b, h, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((t, b, h), (b, h), (b, h))]


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.detach()), np.asarray(w),
                                   rtol=tol, atol=tol)


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_lstm_matches_jax_vjp(shape):
    t, b, _, h = shape
    arrays = _inputs(*shape)
    cots = _cotangents(t, b, h, seed=1)
    want_out, vjp = jax.vjp(jax_fused_lstm, *[jnp.asarray(a) for a in arrays])
    want_grads = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = _leaves(arrays)
    got_out = lk.FusedLSTM.apply(*leaves)
    got_grads = torch.autograd.grad(got_out, leaves,
                                    [torch.from_numpy(c) for c in cots])
    _close(got_out, want_out, GRAD_TOL)
    _close(got_grads, want_grads, GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_train_forward_residuals_match_jax(shape):
    arrays = _inputs(*shape, seed=2)
    (hseq, hn, cn), res = _lstm_vjp_fwd(*[jnp.asarray(a) for a in arrays])
    _, jcseq, jgates = res[-1]
    got = lk.fused_lstm_train_plain(*[torch.from_numpy(a) for a in arrays])
    _close(got, (hseq, jcseq, jgates), FWD_TOL)
    _close((got[0][-1], got[1][-1]), (hn, cn), FWD_TOL)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_fused_lstm_matches_autograd_of_the_plain_loop(shape):
    # an independent reference: PyTorch's own gradient of K1's plain loop
    t, b, _, h = shape
    arrays = _inputs(*shape, seed=3)
    cots = [torch.from_numpy(c) for c in _cotangents(t, b, h, seed=4)]
    leaves = _leaves(arrays)
    got = torch.autograd.grad(lk.FusedLSTM.apply(*leaves), leaves, cots)
    ref = _leaves(arrays)
    want = torch.autograd.grad(lk.fused_lstm_plain(*ref), ref, cots)
    _close(got, [w.numpy() for w in want], GRAD_TOL)


def test_cpu_wrappers_take_the_plain_versions():
    arrays = [torch.from_numpy(a) for a in _inputs(3, 2, 4, 5, seed=5)]
    before = (lk.fused_lstm_train.launches, lk.lstm_bwd_recurrence.launches)
    hseq, cseq, gates = lk.fused_lstm_train(*arrays)
    _close((hseq, cseq, gates),
           [a.numpy() for a in lk.fused_lstm_train_plain(*arrays)], 0)
    cots = [torch.from_numpy(c) for c in _cotangents(3, 2, 5, seed=6)]
    args = (*cots, gates, cseq, arrays[2], arrays[4])
    _close(lk.lstm_bwd_recurrence(*args),
           [a.numpy() for a in lk.lstm_bwd_recurrence_plain(*args)], 0)
    assert (lk.fused_lstm_train.launches,
            lk.lstm_bwd_recurrence.launches) == before


def test_training_wrappers_never_take_the_plain_version_off_the_cpu():
    meta = [torch.empty(a.shape, device="meta")
            for a in _inputs(2, 2, 3, 4)]
    with pytest.raises(MXNetError, match="no kernel"):
        lk.fused_lstm_train(*meta)
    g = torch.empty((2, 2, 16), device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        lk.lstm_bwd_recurrence(meta[1][None].expand(2, 2, 4), meta[1],
                               meta[2], g, meta[1][None].expand(2, 2, 4),
                               meta[2], meta[4])


def test_output_dtype_follows_x():
    arrays = _leaves(_inputs(3, 2, 4, 5, seed=7))
    x64 = arrays[0].detach().double().requires_grad_(True)
    hseq, hn, cn = lk.FusedLSTM.apply(x64, *arrays[1:])
    assert hseq.dtype == hn.dtype == cn.dtype == torch.float64
    grads = torch.autograd.grad(hseq.sum(), [x64] + arrays[1:])
    assert grads[0].dtype == torch.float64
    assert all(g.dtype == torch.float32 for g in grads[1:])


# ---------------------------------------------------------------------------
# the RNN op: which layer runs where
# ---------------------------------------------------------------------------
def test_k1_refuses_inputs_that_need_a_gradient():
    arrays = [torch.from_numpy(a) for a in _inputs(2, 2, 3, 4)]
    arrays[3].requires_grad_(True)
    with pytest.raises(MXNetError, match="FusedLSTM"):
        lk.fused_lstm(*arrays)
    with torch.no_grad():       # no gradient wanted: K1 runs
        lk.fused_lstm(*arrays)


def _rnn_inputs(t, b, i, h, layers, d, seed):
    rng = np.random.RandomState(seed)
    n = rnn_param_size(layers, i, h, d == 2, "lstm")
    return [rng.randn(t, b, i).astype(np.float32),
            (rng.randn(n) * 0.3).astype(np.float32),
            rng.randn(layers * d, b, h).astype(np.float32),
            rng.randn(layers * d, b, h).astype(np.float32)]


@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_gradients_go_through_fused_lstm_and_match_jax(
        bidirectional):
    t, b, i, h, layers = 4, 3, 5, 6, 2
    d = 2 if bidirectional else 1
    arrays = _rnn_inputs(t, b, i, h, layers, d, seed=8)
    params = {"mode": "lstm", "state_size": h, "num_layers": layers,
              "bidirectional": bidirectional, "state_outputs": True}
    jop = jax_get_op("RNN").fcompute
    jparams = dict(params, _is_train=True, _rng_key=jax.random.PRNGKey(0))
    want_out, vjp = jax.vjp(lambda *a: jop(jparams, *a),
                            *[jnp.asarray(a) for a in arrays])
    cots = [np.random.RandomState(9).randn(*np.shape(o)).astype(np.float32)
            for o in want_out]
    want_grads = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = _leaves(arrays)
    got_out = get_op("RNN").fcompute(
        dict(params, _is_train=True, _generator=None), *leaves)
    assert "FusedLSTM" in got_out[0].grad_fn.name() or bidirectional
    got_grads = torch.autograd.grad(got_out, leaves,
                                    [torch.from_numpy(c) for c in cots])
    _close(got_out, want_out, GRAD_TOL)
    _close(got_grads, want_grads, GRAD_TOL)
    assert all(float(g.abs().max()) > 0 for g in got_grads)


def test_rnn_op_without_grad_takes_the_plain_loop():
    arrays = [torch.from_numpy(a)
              for a in _rnn_inputs(3, 2, 4, 5, 1, 1, seed=10)]
    params = {"mode": "lstm", "state_size": 5, "num_layers": 1,
              "_is_train": False, "_generator": None}
    before = lk.fused_lstm_train.launches
    out = get_op("RNN").fcompute(params, *arrays)[0]
    assert out.grad_fn is None and lk.fused_lstm_train.launches == before


# ---------------------------------------------------------------------------
# SoftmaxOutput
# ---------------------------------------------------------------------------
SOFTMAX_CASES = [
    {},
    {"normalization": "batch"},
    {"normalization": "valid", "use_ignore": True, "ignore_label": 2},
    {"normalization": "valid"},
    {"use_ignore": True, "ignore_label": 0, "grad_scale": 0.5},
    {"grad_scale": "2.0", "use_ignore": "true", "ignore_label": "1"},
    {"multi_output": True},
    {"multi_output": True, "normalization": "batch", "use_ignore": True,
     "ignore_label": 3},
]


def _softmax_inputs(params, seed):
    rng = np.random.RandomState(seed)
    if params.get("multi_output"):
        data = rng.randn(3, 4, 2, 5).astype(np.float32)   # (N, C, d...)
        label = rng.randint(0, 4, (3, 2, 5)).astype(np.float32)
    else:
        data = rng.randn(6, 5).astype(np.float32)
        label = rng.randint(0, 5, 6).astype(np.float32)
    return data, label


@pytest.mark.parametrize("params", SOFTMAX_CASES, ids=str)
def test_softmax_output_matches_jax(params):
    data, label = _softmax_inputs(params, seed=11)
    jop = jax_get_op("SoftmaxOutput").fcompute
    want, vjp = jax.vjp(lambda d: jop(dict(params), d, jnp.asarray(label)),
                        jnp.asarray(data))
    cot = np.random.RandomState(12).randn(*data.shape).astype(np.float32)
    (want_grad,) = vjp((jnp.asarray(cot),))
    x = torch.from_numpy(data).requires_grad_(True)
    got = get_op("SoftmaxOutput").fcompute(dict(params), x,
                                           torch.from_numpy(label))
    (got_grad,) = torch.autograd.grad(got, [x], [torch.from_numpy(cot)])
    _close(got, want, FWD_TOL)
    _close([got_grad], [want_grad], FWD_TOL)


def test_softmax_output_flattens_higher_rank_data():
    rng = np.random.RandomState(13)
    data = rng.randn(2, 3, 5).astype(np.float32)
    label = rng.randint(0, 5, (2, 3)).astype(np.float32)
    x = torch.from_numpy(data).requires_grad_(True)
    out = get_op("Softmax").fcompute({}, x, torch.from_numpy(label))[0]
    assert out.shape == (2, 3, 5)
    (grad,) = torch.autograd.grad(out.sum(), [x])
    onehot = np.eye(5, dtype=np.float32)[label.astype(int)]
    np.testing.assert_allclose(grad.numpy(), out.detach().numpy() - onehot,
                               rtol=FWD_TOL, atol=FWD_TOL)


def _label_shapes(pkg, shape, attrs):
    sym = pkg.sym.SoftmaxOutput(pkg.sym.var("data"), name="softmax", **attrs)
    args, outs, _ = sym.infer_shape(data=shape)
    return [tuple(s) for s in args], [tuple(s) for s in outs]


@pytest.mark.parametrize("shape,attrs", [
    ((6, 5), {}), ((2, 3, 5), {}), ((3, 4, 2, 5), {"multi_output": True}),
], ids=str)
def test_softmax_output_label_shape_matches_jax(shape, attrs):
    assert _label_shapes(mxt, shape, attrs) == _label_shapes(mx, shape, attrs)


def test_softmax_output_label_shape_reads_string_attributes():
    # a graph read from JSON carries "False": the op and shape inference
    # must agree that it is off
    args, _ = _label_shapes(mxt, (3, 4, 5), {"multi_output": "False"})
    assert args == [(3, 4, 5), (3, 4)]
