"""The rest of ``ops/nn.py`` as one table of cases: the output heads,
``Deconvolution``, ``CTCLoss``, ``InstanceNorm``, ``LRN``, ``UpSampling``
and the two resize ops.

``CASES`` holds each op at small shapes with the variants the JAX ops
branch on: the heads' ``normalization``, ``grad_scale`` and SVM
options; ``Deconvolution`` in 1-3 dimensions with ``stride``,
``dilate``, ``pad``, ``adj``, ``num_group`` and ``no_bias``; ``CTCLoss``
with both blank conventions, the length inputs and repeated labels;
resizing that enlarges and shrinks. The CPU parity tests
(`tests/test_torch_nn_rest.py`) run them through the JAX op beside the
port's, forward and gradients.

:func:`card_cases` gives the same ops at full size, run on ``gpu(0)`` against
``cpu()`` by ``chip_smoke.py`` (phase 25c) and `tests/test_torch_cuda.py`:
``Deconvolution`` at FCN's upsampling layers (Long et al., CVPR 2015;
MXNet ``example/fcn-xs``: 21 VOC classes, FCN-32s kernel 64 stride 32 on
16x16 scores, FCN-16s/8s kernel 4 stride 2 on 34x34, FCN-8s's last
kernel 16 stride 8 on 70x70), each with bilinear and Xavier weights;
``CTCLoss`` at the speech model's shapes (300 frames of batch 32, 29
classes, labels of 25-75 symbols) with both blank conventions, with and
without length inputs; the heads, ``InstanceNorm``, ``LRN``,
``UpSampling`` and the resize ops at ResNet-50 stage widths. They are
read as `detection_sweep.py` reads its cases (:func:`reading`: the
largest difference over the reference's largest magnitude forward, the
relative norm for gradients), each family against ``LIMITS``; the
card's run on inputs rounded to bf16 is the control that must exceed it.
"""
from __future__ import annotations

import numpy as np

from ..context import cpu
from ..initializer import Bilinear
from ..ndarray.ndarray import zeros
from .detection_sweep import Case, _f32, _rng, reading, run_case

__all__ = ["CASES", "card_cases", "LIMITS", "Case", "run_case", "reading"]

# the largest difference over the reference's largest magnitude forward,
# the relative norm for gradients, per family (card against CPU, f32, TF32
# off): between the sound readings on an H100 and the smallest control
# reading (PERF.md section 2). The gradients of the FCN-32s upsampling
# (kernel 64) and of CTC over 300 frames read up to 6.6e-6 and 4.4e-5
LIMITS = {"head": 1e-5, "deconv": 1e-4, "ctc": 3e-4, "norm": 1e-5,
          "resize": 1e-5}


def _bilinear_weight(shape):
    """The ``Bilinear`` initializer's upsampling weights of ``shape``, as
    numpy."""
    arr = zeros(shape, ctx=cpu())
    Bilinear()._init_weight(None, arr)
    return arr.asnumpy()


def _xavier_weight(rng, shape, magnitude=3.0):
    """Uniform Xavier weights (``factor_type="avg"``) of ``shape``, drawn
    from ``rng`` (not numpy's global generator)."""
    hw = int(np.prod(shape[2:]))
    scale = np.sqrt(magnitude / ((shape[0] * hw + shape[1] * hw) / 2.0))
    return _f32(rng.uniform(-scale, scale, shape))


def _ctc_inputs(rng, T, B, C, lengths, blank_first=True, repeats=False):
    """(data (T, B, C), label (B, max(lengths)), frames (B,)) as numpy
    f32: a label of ``lengths[b]`` symbols padded with 0 (blank first) or
    -1 (blank last); ``repeats`` makes every third symbol its
    predecessor. Each sample gets at least twice its label's length in
    frames, so that every alignment problem is feasible."""
    L = max(lengths)
    lo, hi = (1, C) if blank_first else (0, C - 1)
    label = np.full((B, L), 0.0 if blank_first else -1.0, np.float32)
    frames = np.zeros(B, np.float32)
    for b, n in enumerate(lengths):
        sym = rng.randint(lo, hi, n)
        if repeats:
            sym[2::3] = sym[1:-1:3][:len(sym[2::3])]
        label[b, :n] = sym
        frames[b] = rng.randint(min(2 * n + 1, T), T + 1)
    return _f32(rng.randn(T, B, C) * 2.0), label, frames


def _head_cases():
    rng = _rng("heads")
    x = _f32(rng.randn(6, 5))
    reg = _f32(rng.uniform(-1, 1, (6, 5)))
    prob = _f32(rng.uniform(0, 1, (6, 5)))
    cls = _f32(rng.randint(0, 5, 6))
    cases = [
        Case("LinearRegressionOutput", {}, [x, reg], "head", grad=(0,)),
        Case("LinearRegressionOutput", {"grad_scale": 0.5,
                                        "normalization": "batch"},
             [x, reg], "head", grad=(0,)),
        Case("LinearRegressionOutput", {}, [x[:, :1], reg[:, :1]], "head",
             grad=(0,)),
        Case("LogisticRegressionOutput", {}, [x, prob], "head", grad=(0,)),
        Case("LogisticRegressionOutput", {"normalization": "valid"},
             [x, prob], "head", grad=(0,)),
        Case("MAERegressionOutput", {}, [x, reg], "head", grad=(0,)),
        Case("MAERegressionOutput", {"grad_scale": "2.0"}, [x, reg], "head",
             grad=(0,)),
        Case("SVMOutput", {}, [x, cls], "head", grad=(0,)),
        Case("SVMOutput", {"margin": 0.5, "regularization_coefficient": 2.0},
             [x, cls], "head", grad=(0,)),
        Case("SVMOutput", {"use_linear": True, "normalization": "batch"},
             [x, cls], "head", grad=(0,)),
        Case("SVMOutput", {"use_linear": "True", "margin": "1.5"},
             [x, _f32(np.r_[cls[:5], 7.0])], "head", grad=(0,)),
    ]
    return cases


def _deconv_cases():
    rng = _rng("deconv")

    def case(shape, cin, cout, kernel, groups=1, no_bias=False, **kw):
        w = _f32(rng.randn(cin, cout // groups, *kernel) * 0.3)
        arrays = [_f32(rng.randn(shape[0], cin, *shape[1:])), w]
        params = dict(kw, kernel=kernel, num_filter=cout, num_group=groups,
                      no_bias=no_bias)
        if not no_bias:
            arrays.append(_f32(rng.randn(cout)))
        return Case("Deconvolution", params, arrays, "deconv",
                    grad=tuple(range(len(arrays))))

    return [
        case((2, 7), 3, 4, (3,)),
        case((2, 7), 4, 6, (4,), stride=(2,), pad=(1,), adj=(1,),
             groups=2),
        case((2, 5, 6), 3, 5, (3, 3)),
        case((2, 5, 6), 4, 4, (4, 4), stride=(2, 2), pad=(1, 1),
             no_bias=True),
        case((1, 4, 5), 6, 4, (3, 2), stride=(3, 2), adj=(2, 1),
             dilate=(1, 2), groups=2),
        case((1, 4, 4), 2, 3, (3, 3), dilate=(2, 2), pad=(2, 1)),
        case((1, 3, 4, 3), 2, 3, (2, 3, 2), stride=(2, 1, 2),
             pad=(0, 1, 0), adj=(1, 0, 1)),
    ]


def _ctc_cases():
    rng = _rng("ctc")
    cases = []
    for blank_first in (True, False):
        blank = {"blank_label": "first" if blank_first else "last"}
        data, label, frames = _ctc_inputs(rng, 12, 4, 6, (4, 2, 3, 1),
                                         blank_first)
        _, rep, _ = _ctc_inputs(rng, 12, 4, 6, (5, 4, 3, 2), blank_first,
                               repeats=True)
        lab_len = _f32((label >= (1 if blank_first else 0)).sum(1))
        cases += [
            Case("CTCLoss", blank, [data, label], "ctc", grad=(0,)),
            Case("CTCLoss", blank, [data, rep], "ctc", grad=(0,)),
            Case("CTCLoss", dict(blank, use_data_lengths=True),
                 [data, label, frames], "ctc", grad=(0,)),
            Case("CTCLoss", dict(blank, use_label_lengths=True),
                 [data, label, lab_len], "ctc", grad=(0,)),
            Case("CTCLoss", dict(blank, use_data_lengths=True,
                                 use_label_lengths=True),
                 [data, rep, frames, _f32([5, 4, 3, 2])], "ctc",
                 grad=(0,)),
        ]
    # an empty label: only the all-blank path
    data, label, _ = _ctc_inputs(rng, 6, 2, 4, (2, 1))
    label[1] = 0
    cases.append(Case("ctc_loss", {}, [data, label], "ctc", grad=(0,)))
    return cases


def _norm_resize_cases():
    rng = _rng("norm")
    x = _f32(rng.randn(2, 5, 6, 7))
    g, b = _f32(rng.uniform(0.5, 1.5, 5)), _f32(rng.randn(5))
    return [
        Case("InstanceNorm", {}, [x, g, b], "norm", grad=(0, 1, 2)),
        Case("InstanceNorm", {"eps": 1e-5}, [_f32(rng.randn(3, 4, 9)),
                                             g[:4], b[:4]], "norm",
             grad=(0, 1, 2)),
        Case("LRN", {"nsize": 3}, [x], "norm", grad=(0,)),
        Case("LRN", {"nsize": 5, "alpha": 1e-3, "beta": 0.5, "knorm": 1.0},
             [_f32(rng.randn(2, 7, 4, 3) * 3)], "norm", grad=(0,)),
        Case("UpSampling", {"scale": 2, "sample_type": "nearest"}, [x],
             "resize", grad=(0,)),
        Case("UpSampling", {"scale": 3, "sample_type": "bilinear",
                            "num_filter": 5}, [x], "resize", grad=(0,)),
        Case("_contrib_BilinearResize2D", {"height": 11, "width": 13}, [x],
             "resize", grad=(0,)),
        Case("_contrib_BilinearResize2D", {"height": 4, "width": 3}, [x],
             "resize", grad=(0,)),
        Case("_contrib_BilinearResize2D", {"height": 6, "width": 3}, [x],
             "resize", grad=(0,)),
        Case("_contrib_AdaptiveAvgPooling2D", {"output_size": 1}, [x],
             "resize", grad=(0,)),
        Case("_contrib_AdaptiveAvgPooling2D", {"output_size": (3, 7)}, [x],
             "resize", grad=(0,)),
        Case("_contrib_AdaptiveAvgPooling2D", {"output_size": (4, 5)}, [x],
             "resize", grad=(0,)),
        Case("_contrib_AdaptiveAvgPooling2D", {"output_size": (9, 10)},
             [x], "resize", grad=(0,)),
    ]


CASES = _head_cases() + _deconv_cases() + _ctc_cases() + \
    _norm_resize_cases()


def card_cases():
    """The full-size cases, made when asked (their inputs take ~0.3 GB)."""
    rng = _rng("card")
    cases = []
    for kernel, stride, size in ((64, 32, 16), (4, 2, 34), (16, 8, 70)):
        x = _f32(rng.randn(1, 21, size, size))
        shape = (21, 21, kernel, kernel)
        for w in (_bilinear_weight(shape), _xavier_weight(rng, shape)):
            cases.append(Case("Deconvolution", {
                "kernel": (kernel, kernel), "stride": (stride, stride),
                "num_filter": 21, "no_bias": True}, [x, w], "deconv",
                grad=(0, 1)))
    lengths = [25 + (50 * b) // 31 for b in range(32)]
    for blank_first in (True, False):
        blank = {"blank_label": "first" if blank_first else "last"}
        data, label, frames = _ctc_inputs(rng, 300, 32, 29, lengths,
                                         blank_first)
        cases += [
            Case("CTCLoss", blank, [data, label], "ctc", grad=(0,)),
            Case("CTCLoss", dict(blank, use_data_lengths=True,
                                 use_label_lengths=True),
                 [data, label, frames, _f32(lengths)], "ctc", grad=(0,)),
        ]
    logits = _f32(rng.randn(32, 2048))
    cases += [
        Case("LinearRegressionOutput", {}, [logits, _f32(rng.randn(32, 2048))],
             "head", grad=(0,)),
        Case("LogisticRegressionOutput", {},
             [logits, _f32(rng.uniform(0, 1, (32, 2048)))], "head",
             grad=(0,)),
        Case("MAERegressionOutput", {}, [logits, _f32(rng.randn(32, 2048))],
             "head", grad=(0,)),
        Case("SVMOutput", {}, [_f32(rng.randn(32, 1000)),
                               _f32(rng.randint(0, 1000, 32))], "head",
             grad=(0,)),
    ]
    x = _f32(rng.randn(8, 256, 56, 56))
    cases += [
        Case("InstanceNorm", {}, [x, _f32(rng.uniform(0.5, 1.5, 256)),
                                  _f32(rng.randn(256))], "norm",
             grad=(0, 1, 2)),
        Case("LRN", {"nsize": 5}, [x], "norm", grad=(0,)),
    ]
    y = _f32(rng.randn(8, 512, 28, 28))
    z = _f32(rng.randn(8, 2048, 7, 7))
    cases += [
        Case("UpSampling", {"scale": 2, "sample_type": "nearest"}, [y],
             "resize", grad=(0,)),
        Case("UpSampling", {"scale": 2, "sample_type": "bilinear"}, [y],
             "resize", grad=(0,)),
        Case("_contrib_BilinearResize2D", {"height": 56, "width": 56}, [y],
             "resize", grad=(0,)),
        Case("_contrib_BilinearResize2D", {"height": 20, "width": 20}, [y],
             "resize", grad=(0,)),
        Case("_contrib_AdaptiveAvgPooling2D", {"output_size": 1}, [z],
             "resize", grad=(0,)),
        Case("_contrib_AdaptiveAvgPooling2D", {"output_size": 3}, [z],
             "resize", grad=(0,)),
    ]
    return cases

