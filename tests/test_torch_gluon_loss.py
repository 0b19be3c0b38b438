"""The port's Gluon losses against the JAX package's, on the CPU.

Every ported loss, over its options (``weight``, ``sample_weight``,
``batch_axis`` and each loss's own), on the same inputs from a numpy
seed: the per-sample losses, and in f32 the gradient of their sum with
respect to the prediction under ``autograd.record()``, at rtol 1e-5,
atol 1e-6 (f32 both sides). In bf16 the losses are held within one bf16
step (2^-7 relative, at the magnitude of the largest loss) of the JAX
package's. The JAX package
rounds to bf16 between the steps of its ``log_softmax``; torch rounds
once per op from f32 arithmetic. Where the two part, in
``KLDivLoss(from_logits=False)`` (a difference of terms several times
the loss), the JAX package's loss is 1.6e-3 from the f32 one at a loss
of 0.0153 and the port's 1e-4: that case holds the port to the f32 loss
and checks that the JAX package's is the one off. ``CTCLoss`` raises on
a layout it does not take (its values are held in
`test_torch_gluon_nn_rest.py`), and a hybridized loss equals the eager
one.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import loss as jloss
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import loss as tloss

RTOL, ATOL = 1e-5, 1e-6
CPU = mxt.cpu()
N, C = 4, 5


def _inputs(kind, seed):
    rng = np.random.RandomState(seed)
    pred = rng.randn(N, C)
    if kind == "regression":
        label = rng.randn(N, C)
    elif kind == "binary":
        label = rng.randint(0, 2, (N, C))
    elif kind == "signed":
        label = rng.randint(0, 2, (N, C)) * 2 - 1
    elif kind == "probability":
        pred = 1 / (1 + np.exp(-pred))
        label = rng.randint(0, 2, (N, C))
    elif kind == "sparse":
        label = rng.randint(0, C, (N,))
    elif kind == "distribution":
        label = rng.uniform(0.1, 1.0, (N, C))
        label = label / label.sum(-1, keepdims=True)
    elif kind == "log_distribution":
        pred = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
        label = rng.uniform(0.1, 1.0, (N, C))
        label = label / label.sum(-1, keepdims=True)
    elif kind == "triplet":
        label = (rng.randn(N, C), rng.randn(N, C))
        return [pred.astype(np.float32)] + [v.astype(np.float32)
                                            for v in label]
    return [pred.astype(np.float32), label.astype(np.float32)]


SAMPLE_WEIGHT = np.linspace(0.5, 2.0, N).reshape(N, 1).astype(np.float32)

# (loss, constructor keywords, inputs, with sample_weight)
CASES = [
    ("L2Loss", {}, "regression", False),
    ("L2Loss", {"weight": 0.5}, "regression", True),
    ("L2Loss", {"batch_axis": 1}, "regression", False),
    ("L1Loss", {}, "regression", False),
    ("L1Loss", {"weight": 2.0}, "regression", True),
    ("L1Loss", {"batch_axis": 1}, "regression", False),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary", False),
    ("SigmoidBinaryCrossEntropyLoss", {"weight": 0.5}, "binary", True),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
     "probability", False),
    ("SoftmaxCrossEntropyLoss", {}, "sparse", False),
    ("SoftmaxCrossEntropyLoss", {"weight": 1.5}, "sparse", True),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True}, "sparse", False),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, "distribution",
     False),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False, "from_logits": True},
     "distribution", True),
    ("KLDivLoss", {}, "log_distribution", False),
    ("KLDivLoss", {"from_logits": False}, "distribution", True),
    ("HuberLoss", {}, "regression", False),
    ("HuberLoss", {"rho": 0.5, "weight": 2.0}, "regression", True),
    ("HingeLoss", {}, "signed", False),
    ("HingeLoss", {"margin": 2.0}, "signed", True),
    ("SquaredHingeLoss", {}, "signed", False),
    ("SquaredHingeLoss", {"margin": 0.5}, "signed", True),
    ("LogisticLoss", {}, "signed", False),
    ("LogisticLoss", {"label_format": "binary"}, "binary", True),
    ("TripletLoss", {}, "triplet", False),
    ("TripletLoss", {"margin": 0.5, "weight": 2.0}, "triplet", True),
]
IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(CASES)]
# the bf16 case where the JAX package's loss is more than a bf16 step
# from the f32 loss of the same bf16 inputs (see the module docstring)
JAX_BF16_OFF = {"KLDivLoss-15"}


def _run(pkg, module, ag, case, values, dtype, record):
    name, kwargs, _, weighted = case
    ctx = {"ctx": CPU} if pkg is mxt else {}
    arrays = [pkg.nd.array(v, dtype=dtype, **ctx) for v in values]
    if weighted:
        weight = SAMPLE_WEIGHT.reshape(N) if name == "TripletLoss" \
            else SAMPLE_WEIGHT
        arrays.append(pkg.nd.array(weight, dtype=dtype, **ctx))
    fn = getattr(module, name)(**kwargs)
    if not record:
        return fn(*arrays), None
    arrays[0].attach_grad()
    with ag.record():
        out = fn(*arrays)
    out.backward()
    return out, arrays[0].grad


def _np(arr):
    return np.asarray(arr.astype("float32").asnumpy(), np.float32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_matches_jax_f32(case):
    values = _inputs(case[2], CASES.index(case))
    jout, jgrad = _run(mx, jloss, jag, case, values, "float32", True)
    tout, tgrad = _run(mxt, tloss, tag, case, values, "float32", True)
    axis = case[1].get("batch_axis", 0)
    assert tout.shape == (values[0].shape[axis],) == jout.shape
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(tgrad), _np(jgrad), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_matches_jax_bf16(case):
    values = _inputs(case[2], CASES.index(case))
    want = _np(_run(mx, jloss, jag, case, values, "bfloat16", False)[0])
    got = _run(mxt, tloss, tag, case, values, "bfloat16", False)[0]
    assert got.data.dtype == mxt.base.torch_dtype("bfloat16")
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    if IDS[CASES.index(case)] not in JAX_BF16_OFF:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=step)
        return
    # the f32 losses of the bf16-rounded inputs
    rounded = [_np(mxt.nd.array(v, ctx=CPU, dtype="bfloat16"))
               for v in values]
    exact = _np(_run(mxt, tloss, tag, case, rounded, "float32", False)[0])
    np.testing.assert_allclose(_np(got), exact, rtol=0, atol=step)
    assert np.abs(want - exact).max() > step


def test_hybridized_loss_equals_eager():
    values = _inputs("sparse", 0)
    eager = _run(mxt, tloss, tag, CASES[9], values, "float32", False)[0]
    fn = tloss.SoftmaxCrossEntropyLoss()
    fn.hybridize()
    pred, label = (mxt.nd.array(v, ctx=CPU) for v in values)
    np.testing.assert_array_equal(fn(pred, label).asnumpy(),
                                  eager.asnumpy())


def test_ctc_loss_raises():
    """``CTCLoss`` is live (`test_torch_gluon_nn_rest.py` holds it to the
    JAX package's); it raises on a layout it does not take."""
    with pytest.raises(ValueError, match="'NTC' and 'TNC'"):
        tloss.CTCLoss(layout="NCT")
    with pytest.raises(ValueError, match="'NT' and 'TN'"):
        tloss.CTCLoss(label_layout="TNC")
    pred = mxt.nd.array(np.zeros((N, 6, C), np.float32), ctx=CPU)
    label = mxt.nd.array(np.full((N, 2), 1.0, np.float32), ctx=CPU)
    assert tloss.CTCLoss()(pred, label).shape == (N,)
