"""The rest of the JAX package's ``ops/nn.py`` on the port, op by op.

Every case of `mxnet_tpu_torch/tools/nn_rest_sweep.py` (the four output
heads with their ``normalization``, ``grad_scale`` and SVM options;
``Deconvolution`` in 1-3 dimensions with ``stride``, ``dilate``, ``pad``,
``adj``, ``num_group`` and ``no_bias``; ``CTCLoss`` and ``ctc_loss`` with
both blank conventions, the length inputs, repeated labels and an empty
label; ``InstanceNorm``, ``LRN``, ``UpSampling`` and the two resize ops,
enlarging and shrinking) goes through the JAX op's ``fcompute`` and the
port's on the CPU from the same numpy inputs. Forward outputs are held
at rtol 1e-5, atol 1e-6 (f32 both sides), and the gradients of the
inputs the case names against ``jax.vjp`` of the JAX op under the same
cotangents at rtol 1e-4, atol 1e-5, the tolerances of the reference's
own `tests/test_pallas.py` for gradients.

Where the port leaves the JAX op on purpose (ROADMAP C's facts), the
test says what it holds instead: a label that stops at its first pad
(the JAX op counts every non-pad entry but builds the path from the
whole row), an infeasible alignment that reads ``inf`` with no gradient
(the JAX op reads about 1e10), a head whose label broadcasts against
the output raising (as the JAX head's VJP does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops.registry import get_op as jax_get_op
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import _OPS, get_op
from mxnet_tpu_torch.tools import nn_rest_sweep as sweep
from mxnet_tpu_torch.tools.detection_sweep import _cotangent
from torch_parity import jax_ops_of

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
CPU = mxt.cpu()


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _jax_vjp(name, params, arrays, grad):
    """The JAX op's outputs (numpy) and the gradients of the inputs
    ``grad`` under ``cots(outputs)``, jitted."""
    fn = jax_get_op(name).fcompute
    params = dict(params, _is_train=False, _rng_key=jax.random.PRNGKey(0))
    ins = [jnp.asarray(a) for a in arrays]

    def f(*diff):
        full = list(ins)
        for i, d in zip(grad, diff):
            full[i] = d
        return tuple(fn(params, *full))
    outs, vjp = jax.vjp(jax.jit(f), *[ins[i] for i in grad])
    return [np.asarray(o) for o in outs], vjp


@pytest.mark.parametrize("case", [pytest.param(c, id="%s-%d" % (c.name, i))
                                  for i, c in enumerate(sweep.CASES)])
def test_op(case):
    got, grads = sweep.run_case(case, CPU)
    want, vjp = _jax_vjp(case.name, case.params, case.arrays, case.grad)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape, case
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=str(case))
    cots = tuple(jnp.asarray(_cotangent(case, k, g.shape).numpy())
                 for k, g in enumerate(got))
    want_g = vjp(cots)
    assert len(grads) == len(want_g)
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=str(case))


def test_every_op_of_jax_nn_and_the_compat_aliases_is_registered():
    names = jax_ops_of("nn.py") | {"Convolution_v1", "CuDNNBatchNorm"}
    assert sorted(names - set(_OPS)) == []
    assert get_op("Convolution_v1") is get_op("Convolution")
    assert get_op("CuDNNBatchNorm") is get_op("BatchNorm")
    for alias in ("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"):
        assert get_op(alias) is get_op("CTCLoss")


def test_ops_reach_nd_sym_and_contrib():
    for name in ("Deconvolution", "CTCLoss", "ctc_loss", "InstanceNorm",
                 "LRN", "UpSampling", "SVMOutput", "LinearRegressionOutput",
                 "LogisticRegressionOutput", "MAERegressionOutput",
                 "Convolution_v1", "CuDNNBatchNorm"):
        assert hasattr(mxt.nd, name) and hasattr(mxt.sym, name), name
    for name in ("AdaptiveAvgPooling2D", "BilinearResize2D", "CTCLoss",
                 "ctc_loss"):
        assert hasattr(mxt.nd.contrib, name) and \
            hasattr(mxt.sym.contrib, name), name


def _ctc(pkg_op, data, label, **params):
    return pkg_op(params, data, label)[0]


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_label_ends_at_its_first_pad(blank):
    """A pad inside a label row ends the label: the port's loss and
    gradient equal the JAX op's on the row with everything after the
    first pad set to the pad."""
    rng = np.random.RandomState(3)
    pad = 0.0 if blank == "first" else -1.0
    lo = 1 if blank == "first" else 0
    data = rng.randn(10, 3, 5).astype(np.float32)
    label = rng.randint(lo, lo + 4, (3, 5)).astype(np.float32)
    label[0, 2] = pad                  # an inner pad: the label is 2 long
    label[1, 4] = pad
    label[2, 0] = pad                  # empty
    cut = label.copy()
    for row in cut:
        first = np.flatnonzero(row == pad)
        if first.size:
            row[first[0]:] = pad
    x = torch.from_numpy(data).requires_grad_(True)
    got = _ctc(get_op("CTCLoss").fcompute, x, torch.from_numpy(label),
               blank_label=blank)
    cot = rng.randn(3).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    want, vjp = _jax_vjp("CTCLoss", {"blank_label": blank}, [data, cut], (0,))
    np.testing.assert_allclose(got.detach().numpy(), want[0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp((jnp.asarray(cot),))[0]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_infeasible_alignment_reads_inf_without_gradient(lengths):
    """Sample 1 has a label of 4 symbols with a repeat (5 frames needed)
    in 4 frames: the port reads inf and gives it no gradient, where the
    JAX op reads about 1e10; the feasible samples match the JAX op."""
    rng = np.random.RandomState(4)
    data = rng.randn(6, 3, 5).astype(np.float32)
    label = np.array([[1, 2, 0, 0], [3, 3, 1, 2], [4, 1, 2, 0]], np.float32)
    params, extra = {}, []
    if lengths:
        params["use_data_lengths"] = True
        extra = [np.array([6, 4, 6], np.float32)]
    else:
        data = data[:4]
    x = torch.from_numpy(data).requires_grad_(True)
    got = get_op("CTCLoss").fcompute(params, x, torch.from_numpy(label),
                                     *[torch.from_numpy(e) for e in extra])[0]
    cot = np.ones(3, np.float32)
    got.backward(torch.from_numpy(cot))
    want, vjp = _jax_vjp("CTCLoss", params, [data, label] + extra, (0,))
    assert np.isinf(got[1].item()) and 1e9 < want[0][1] < 1e11
    ok = [0, 2]
    np.testing.assert_allclose(got.detach().numpy()[ok], want[0][ok],
                               rtol=RTOL, atol=ATOL)
    assert np.all(x.grad.numpy()[:, 1] == 0)
    jg = np.asarray(vjp((jnp.asarray(np.array([1, 0, 1], np.float32)),))[0])
    np.testing.assert_allclose(x.grad.numpy()[:, ok], jg[:, ok],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_ctc_bf16_data_gives_a_bf16_loss_from_an_f32_log_softmax():
    rng = np.random.RandomState(5)
    data = rng.randn(8, 2, 5).astype(np.float32)
    label = np.array([[1, 2, 2], [3, 0, 0]], np.float32)
    got = get_op("CTCLoss").fcompute({}, torch.from_numpy(data).bfloat16(),
                                     torch.from_numpy(label))[0]
    want = jax_get_op("CTCLoss").fcompute(
        {}, jnp.asarray(data, jnp.bfloat16), jnp.asarray(label))[0]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=ATOL)


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "LogisticRegressionOutput",
                                  "MAERegressionOutput"])
def test_regression_head_with_a_broadcasting_label_raises(name):
    """A (B,) label against a (B, 1) output: ``out - label`` broadcasts
    to (B, B) in both packages, and both refuse that gradient."""
    x = np.random.RandomState(6).randn(4, 1).astype(np.float32)
    lab = np.random.RandomState(7).randn(4).astype(np.float32)
    with pytest.raises(ValueError):
        _jax_vjp(name, {}, [x, lab], (0,))[1]((jnp.ones((4, 1)),))
    t = torch.from_numpy(x).requires_grad_(True)
    out = get_op(name).fcompute({}, t, torch.from_numpy(lab))[0]
    with pytest.raises(MXNetError, match="label of shape"):
        out.sum().backward()


def test_deconvolution_refuses_a_channel_last_layout():
    x = torch.zeros(1, 4, 4, 3)
    w = torch.zeros(3, 2, 3, 3)
    with pytest.raises(MXNetError, match="channel-first"):
        get_op("Deconvolution").fcompute(
            {"kernel": (3, 3), "num_filter": 2, "layout": "NHWC"}, x, w)


def _graphs(pkg):
    s = pkg.sym
    data = s.Variable("data")
    return {
        "deconv": s.Deconvolution(data, kernel=(4, 4), stride=(2, 2),
                                  pad=(1, 1), num_filter=6, num_group=2,
                                  name="up"),
        "deconv_nobias": s.Deconvolution(data, kernel=(3, 3), num_filter=5,
                                         no_bias=True, name="up"),
        "instance_norm": s.InstanceNorm(data, name="inorm"),
        "prelu": s.LeakyReLU(data, act_type="prelu", name="act"),
        "linear_head": s.LinearRegressionOutput(
            s.FullyConnected(data, num_hidden=3, name="fc"), name="lin"),
        "svm_head": s.SVMOutput(s.FullyConnected(data, num_hidden=3,
                                                 name="fc"), name="svm"),
        "ctc": s.CTCLoss(s.Reshape(data, shape=(4, 2, -1)),
                         s.Variable("label"), name="ctc"),
    }


@pytest.mark.parametrize("key", sorted(_graphs(mx)))
def test_symbol_shape_inference_matches_jax(key):
    shapes = {"data": (2, 4, 5, 5)} if key != "ctc" else \
        {"data": (4, 2, 6), "label": (2, 3)}
    want = _graphs(mx)[key].infer_shape(**shapes)
    got = _graphs(mxt)[key].infer_shape(**shapes)
    assert [tuple(s) for s in got[0]] == [tuple(s) for s in want[0]]
    assert [tuple(s) for s in got[1]] == [tuple(s) for s in want[1]]
    assert _graphs(mxt)[key].list_arguments() == \
        _graphs(mx)[key].list_arguments()


def test_svm_module_step_matches_jax():
    """A Module over ``SVMOutput`` (the svm_mnist example's head), two SGD
    steps from the same weights: outputs and parameters."""
    rng = np.random.RandomState(8)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.float32)
    results = []
    for pkg in (mx, mxt):
        data = pkg.sym.Variable("data")
        net = pkg.sym.SVMOutput(pkg.sym.FullyConnected(
            data, num_hidden=4, name="fc"), name="svm", margin=0.5)
        mod = pkg.mod.Module(net, label_names=("svm_label",),
                             context=pkg.cpu())
        mod.bind(data_shapes=[("data", (8, 6))],
                 label_shapes=[("svm_label", (8,))])
        w = np.random.RandomState(9).randn(4, 6).astype(np.float32) * 0.3
        mod.init_params(arg_params={
            "fc_weight": pkg.nd.array(w, ctx=pkg.cpu()),
            "fc_bias": pkg.nd.zeros((4,), ctx=pkg.cpu())})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        outs = []
        for _ in range(2):
            mod.forward_backward(pkg.io.DataBatch(
                [pkg.nd.array(x, ctx=pkg.cpu())],
                [pkg.nd.array(y, ctx=pkg.cpu())]))
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        results.append((outs, {n: a.asnumpy() for n, a in
                               mod.get_params()[0].items()}))
    (wo, wp), (go, gp) = results
    for g, w in zip(go, wo):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for n in wp:
        np.testing.assert_allclose(gp[n], wp[n], rtol=RTOL, atol=ATOL)
