"""Every op of the detection slice, as one table of cases, and the inputs
of greedy NMS.

``CASES`` holds each op of `ops/contrib_ops.py` and of the ported part of
`ops/detection.py` at the SSD and Faster-RCNN examples' shapes (TinySSD's
8x8 feature map with 4 anchors a cell, the RCNN example's 8x8 map with 9,
32 rois, 32 channels), with the variants the JAX ops branch on: both box
formats, ``force_suppress``, ``nms_topk``, ``background_id`` != 0, empty
labels, hard-negative mining, ties in scores and maxima, samples outside
the image. ``SSD300_CASES`` adds the MultiBox ops at SSD300's layout
(8732 anchors, 21 classes, labels padded to 50 rows). The CPU parity tests
(`tests/test_torch_detection.py`) run ``CASES`` through the JAX package's
op beside the port's, forward and gradients; ``chip_smoke.py`` (phase 22)
and `tests/test_torch_cuda.py` run them on ``gpu(0)`` against ``cpu()``.

A case's ``grad`` names the inputs that take a gradient: :func:`run_case`
then also returns the gradients of a seeded cotangent of every float
output. The card is held to the CPU by :func:`reading`: forward, the
largest difference over the reference's largest magnitude; gradients, by
relative norm; each at most ``LIMITS[family]``; ``exact`` cases
(anchors, matching) must agree bit for bit. :func:`control` rounds a
family's inputs to bf16 on the card only and must exceed its limit.

``nms_inputs`` makes the boxes, scores and classes that N1's tests and
phase 22 feed greedy NMS: clustered boxes (so that NMS suppresses), scores
rounded to two decimals (ties), a few identical boxes.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from ..context import cpu
from ..ops.registry import get_op

__all__ = ["CASES", "SSD300_CASES", "LIMITS", "Case", "run_case", "reading",
           "compare", "control", "nms_inputs", "anchors_of"]

# the largest difference over the reference's largest magnitude, forward
# and gradient, per family (card against CPU, f32; PERF.md section 2)
LIMITS = {"exact": 0.0, "box": 1e-5, "pool": 1e-5, "sample": 1e-5}


class Case:
    """One op call: ``name``, ``params``, numpy ``arrays``, ``family`` and
    the indices of the inputs that take a gradient (``grad``)."""

    def __init__(self, name, params, arrays, family, grad=()):
        self.name, self.params, self.arrays = name, params, arrays
        self.family, self.grad = family, tuple(grad)

    def __repr__(self):
        return "Case(%s, %s)" % (self.name, self.params)


def _rng(tag):
    return np.random.RandomState(zlib.crc32(tag.encode()))


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _boxes(rng, shape, lo, hi, wh_lo, wh_hi):
    """Corner boxes of shape ``shape + (4,)`` inside [lo, hi]."""
    wh = rng.uniform(wh_lo, wh_hi, shape + (2,))
    xy = rng.uniform(lo, hi - wh_hi, shape + (2,))
    return _f32(np.concatenate([xy, xy + wh], axis=-1))


def nms_inputs(batch, n, seed, classes=3, identical=False):
    """(boxes (B, n, 4), scores (B, n), valid (B, n) bool, class ids
    (B, n)) as numpy: boxes in clusters of about 8, scores rounded to two
    decimals, every 7th box a copy of its predecessor; ``identical`` makes
    every box and score the same."""
    rng = np.random.RandomState(seed)
    if identical:
        boxes = np.tile(_f32([10.0, 10.0, 30.0, 40.0]), (batch, n, 1))
        scores = np.full((batch, n), 0.5, np.float32)
    else:
        k = max(1, n // 8)
        centre = rng.uniform(0, 200, (batch, k, 2))[:, rng.randint(0, k, n)]
        centre = centre + rng.randn(batch, n, 2) * 4.0
        wh = rng.uniform(10, 30, (batch, n, 2))
        boxes = _f32(np.concatenate([centre - wh / 2, centre + wh / 2], -1))
        boxes[:, 7::7] = boxes[:, 6:-1:7][:, :boxes[:, 7::7].shape[1]]
        scores = _f32(np.round(rng.uniform(0, 1, (batch, n)), 2))
    valid = scores > 0.05
    cls = _f32(rng.randint(0, classes, (batch, n)))
    return boxes, scores, valid, cls


def anchors_of(h, w, sizes, ratios):
    """MultiBoxPrior's anchors (1, h*w*A, 4) of an (h, w) map, as numpy."""
    data = torch.zeros((1, 1, h, w))
    out = get_op("_contrib_MultiBoxPrior").fcompute(
        {"sizes": sizes, "ratios": ratios}, data)[0]
    return out.numpy()


def _ssd_label(rng, batch, rows, max_valid, classes):
    lab = np.full((batch, rows, 5), -1.0, np.float32)
    for i in range(batch):
        k = rng.randint(0, max_valid + 1) if i else max_valid
        lab[i, :k, 0] = rng.randint(0, classes, k)
        lab[i, :k, 1:] = _boxes(rng, (k,), 0.0, 1.0, 0.1, 0.5)
    return lab


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return _f32(e / e.sum(axis=axis, keepdims=True))


def _multibox_cases(tag, batch, anchors, classes, rows, max_valid,
                    full_nms_batch=None):
    """MultiBoxTarget and MultiBoxDetection over ``anchors`` (1, A, 4);
    the MultiBoxDetection variants without ``nms_topk`` on the first
    ``full_nms_batch`` images only (all when None): their plain NMS holds
    an (A, A) IoU matrix an image."""
    rng = _rng(tag)
    A = anchors.shape[1]
    label = _ssd_label(rng, batch, rows, max_valid, classes)
    label[-1] = -1.0                                   # an image without gt
    cls_pred = _f32(rng.randn(batch, classes + 1, A))
    # logits rounded to 0.5: many anchors share a score
    probs = _softmax(np.round(rng.randn(batch, classes + 1, A) * 2) / 2, 1)
    loc = _f32(rng.randn(batch, A * 4) * 0.5)
    cases = [
        Case("_contrib_MultiBoxTarget", {}, [anchors, label, cls_pred],
             "box"),
        Case("_contrib_MultiBoxTarget",
             {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.5,
              "minimum_negative_samples": 2, "overlap_threshold": 0.4},
             [anchors, label, cls_pred], "box"),
    ]
    cases.append(Case("_contrib_MultiBoxDetection",
                      {"nms_threshold": 0.45, "nms_topk": min(A, 400)},
                      [probs, loc, anchors], "box"))
    few = slice(0, full_nms_batch)
    for params in ({"nms_threshold": 0.45},
                   {"nms_threshold": 0.5, "force_suppress": True,
                    "threshold": 0.2},
                   {"nms_threshold": 0.45, "background_id": 2,
                    "clip": False}):
        cases.append(Case("_contrib_MultiBoxDetection", params,
                          [probs[few], loc[few], anchors], "box"))
    return cases


def _contrib_cases():
    rng = _rng("contrib")
    x = _f32(rng.randn(4, 6))
    box_a = _boxes(rng, (2, 5), 0, 20, 2, 8)
    box_b = _boxes(rng, (2, 7), 0, 20, 2, 8)
    nms = np.concatenate([np.round(rng.uniform(0, 2, (2, 40, 1))),
                          np.round(rng.uniform(0, 1, (2, 40, 1)), 1),
                          _boxes(rng, (2, 40), 0, 30, 4, 12),
                          rng.randn(2, 40, 1)], axis=-1).astype(np.float32)
    feat = _f32(np.round(rng.uniform(0, 3, (2, 4, 8, 8))))   # ties
    rois = np.concatenate([rng.randint(0, 2, (6, 1)),
                           _boxes(rng, (6,), 0, 15, 3, 9)], 1)
    h = _f32(rng.randint(0, 6, (1, 10)))
    s = _f32(np.sign(rng.randn(1, 10)))
    return [
        Case("_contrib_quadratic", {"a": 1.5, "b": -2.0, "c": 0.5}, [x],
             "box", grad=(0,)),
        Case("_contrib_fft", {}, [_f32(rng.randn(3, 8))], "box", grad=(0,)),
        Case("_contrib_ifft", {}, [_f32(rng.randn(3, 16))], "box",
             grad=(0,)),
        Case("_contrib_count_sketch", {"out_dim": 6},
             [_f32(rng.randn(4, 10)), h, s], "box", grad=(0,)),
        Case("_contrib_box_iou", {}, [box_a, box_b], "box"),
        Case("_contrib_box_iou", {"format": "center"}, [box_a, box_b],
             "box"),
        Case("_contrib_box_nms", {"overlap_thresh": 0.5}, [nms], "box"),
        Case("_contrib_box_nms", {"overlap_thresh": 0.4, "id_index": 0,
                                  "topk": 12, "valid_thresh": 0.25},
             [nms], "box"),
        Case("_contrib_box_nms", {"overlap_thresh": 0.4, "id_index": 0,
                                  "force_suppress": True}, [nms], "box"),
        Case("_contrib_box_nms", {"overlap_thresh": 0.5}, [nms[0]], "box"),
        Case("ROIPooling", {"pooled_size": (3, 3), "spatial_scale": 0.5},
             [feat, _f32(rois)], "pool", grad=(0,)),
    ]


def _ssd_cases():
    """TinySSD's layout: an 8x8 map of batch 8, sizes (0.3, 0.5), ratios
    (1, 2, 0.5) (4 anchors a cell), 2 classes, one gt box an image."""
    feat = np.zeros((8, 64, 8, 8), np.float32)
    anchors = anchors_of(8, 8, (0.3, 0.5), (1.0, 2.0, 0.5))
    return [
        Case("_contrib_MultiBoxPrior", {"sizes": (0.3, 0.5),
                                        "ratios": (1.0, 2.0, 0.5)},
             [feat], "exact"),
        Case("_contrib_MultiBoxPrior", {"sizes": (0.2, 0.4, 0.7),
                                        "ratios": (1.0, 3.0),
                                        "steps": (0.1, 0.15),
                                        "offsets": (0.4, 0.6), "clip": True},
             [feat[:1, :, :5, :7]], "exact"),
    ] + _multibox_cases("ssd", 8, anchors, 2, 3, 1)


def _rcnn_inputs(rng, batch=2, size=8, stride=8, anchors=9):
    cls = _softmax(rng.randn(batch, 2, anchors, size, size), 1).reshape(
        batch, 2 * anchors, size, size)
    bbox = _f32(rng.randn(batch, 4 * anchors, size, size) * 0.2)
    info = _f32(np.tile([size * stride, size * stride, 1.0], (batch, 1)))
    return cls, bbox, info


def _rcnn_cases():
    """The Faster-RCNN example's layout: batch 2, a 64x64 image at stride
    8 (an 8x8 map), scales (2, 4, 8) x ratios (0.5, 1, 2), 200 pre-NMS and
    32 post-NMS proposals, 16 rois an image, 3 classes, 32 channels."""
    rng = _rng("rcnn")
    cls, bbox, info = _rcnn_inputs(rng)
    prop = {"feature_stride": 8, "scales": (2, 4, 8), "ratios": (0.5, 1, 2),
            "rpn_pre_nms_top_n": 200, "rpn_post_nms_top_n": 32,
            "threshold": 0.7, "rpn_min_size": 8}
    rois = np.concatenate([np.repeat(np.arange(2), 16)[:, None],
                           _boxes(rng, (32,), 0, 64, 8, 36)], 1)
    rois = _f32(rois)
    gt = np.full((2, 3, 5), -1.0, np.float32)
    gt[:, 0, :4] = _boxes(rng, (2,), 0, 64, 20, 36)
    gt[:, 0, 4] = [1, 2]
    gt[1, 1, :4], gt[1, 1, 4] = _boxes(rng, (), 0, 64, 10, 20), 1
    ohem = _softmax(rng.randn(2, 16, 3), -1)
    feat = _f32(np.maximum(rng.randn(2, 32, 8, 8), 0))         # relu ties
    psfeat = _f32(rng.randn(2, 8 * 16, 8, 8))
    offset = _f32(rng.randn(2, 18, 8, 8) * 1.5)
    weight = _f32(rng.randn(32, 32, 3, 3) * 0.1)
    return [
        Case("_contrib_Proposal", prop, [cls, bbox, info], "box"),
        Case("_contrib_MultiProposal", dict(prop, output_score=True),
             [cls, bbox, info], "box"),
        Case("_contrib_Proposal", dict(prop, rpn_pre_nms_top_n=20,
                                       threshold=0.5),
             [cls, bbox, info], "box"),
        Case("ProposalTarget",
             {"num_classes": 3, "batch_images": 2, "batch_rois": 32,
              "fg_fraction": 0.5, "fg_thresh": 0.5, "bg_thresh_hi": 0.5,
              "bg_thresh_lo": 0.0, "ohem": True},
             [rois.reshape(2, 16, 5), gt, ohem], "box"),
        Case("ROIPooling", {"pooled_size": (4, 4), "spatial_scale": 0.125},
             [feat, rois], "pool", grad=(0,)),
        Case("_contrib_DeformableConvolution",
             {"kernel": (3, 3), "pad": (1, 1), "num_filter": 32,
              "no_bias": True}, [feat, offset, weight], "sample",
             grad=(0, 1, 2)),
        Case("_contrib_DeformablePSROIPooling",
             {"spatial_scale": 0.125, "output_dim": 8, "pooled_size": 4,
              "group_size": 4, "no_trans": True}, [psfeat, rois], "pool",
             grad=(0,)),
    ]


def _spatial_cases():
    rng = _rng("spatial")
    data = _f32(rng.randn(2, 3, 5, 6))
    grid = _f32(rng.uniform(-1.3, 1.3, (2, 2, 4, 4)))          # some outside
    theta = _f32(np.tile([0.9, 0.1, 0.05, -0.1, 0.8, 0.1], (2, 1))
                 + rng.randn(2, 6) * 0.05)
    flow = _f32(rng.randn(2, 2, 4, 5))
    ddata = _f32(rng.randn(2, 4, 7, 7))
    off2 = _f32(rng.randn(2, 2 * 2 * 9, 4, 4) * 1.5)
    w2 = _f32(rng.randn(6, 2, 3, 3) * 0.2)
    bias = _f32(rng.randn(6))
    ps = _f32(rng.randn(2, 2 * 9, 8, 8))
    prois = _f32(np.concatenate([rng.randint(0, 2, (5, 1)),
                                 _boxes(rng, (5,), 0, 15, 3, 10)], 1))
    trans = _f32(rng.randn(5, 4, 3, 3))
    adata = _f32(np.round(rng.uniform(0, 3, (2, 3, 8, 8))))    # ties
    arois = prois.copy()
    arois[1, 0] = -1.0
    return [
        Case("BilinearSampler", {}, [data, grid], "sample", grad=(0, 1)),
        Case("GridGenerator", {"transform_type": "affine",
                               "target_shape": (4, 5)}, [theta], "sample",
             grad=(0,)),
        Case("GridGenerator", {"transform_type": "warp"}, [flow], "sample",
             grad=(0,)),
        Case("SpatialTransformer", {"target_shape": (5, 5)},
             [data, theta], "sample", grad=(0, 1)),
        Case("_contrib_DeformableConvolution",
             {"kernel": (3, 3), "stride": (2, 2), "dilate": (2, 2),
              "pad": (2, 2), "num_filter": 6, "num_deformable_group": 2,
              "num_group": 2}, [ddata, off2, w2, bias], "sample",
             grad=(0, 1, 2, 3)),
        Case("_contrib_PSROIPooling", {"spatial_scale": 0.5,
                                       "output_dim": 2, "pooled_size": 3},
             [ps, prois], "pool", grad=(0,)),
        Case("_contrib_DeformablePSROIPooling",
             {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 3,
              "group_size": 3, "part_size": 3, "sample_per_part": 2,
              "trans_std": 0.1}, [ps, prois, trans], "pool", grad=(0, 2)),
        Case("_contrib_ROIAlign_v2", {"spatial_scale": 0.5,
                                      "pooled_size": (3, 3)},
             [adata, arois], "pool", grad=(0,)),
        Case("_contrib_ROIAlign_v2", {"spatial_scale": 0.5,
                                      "pooled_size": 2},
             [adata, arois], "pool", grad=(0,)),
    ]


def _matching_cases():
    rng = _rng("matching")
    scores = _f32(np.round(rng.uniform(0, 1, (2, 6, 5)), 1))   # ties
    return [
        Case("_contrib_bipartite_matching", {"threshold": 0.2}, [scores],
             "exact"),
        Case("_contrib_bipartite_matching", {"threshold": 0.6,
                                             "is_ascend": True},
             [scores], "exact"),
        Case("_contrib_bipartite_matching", {"threshold": 0.1, "topk": 2},
             [scores[0]], "exact"),
    ]


CASES = _contrib_cases() + _ssd_cases() + _rcnn_cases() + \
    _spatial_cases() + _matching_cases()


def _ssd300_cases():
    """SSD300's layout (reference example/ssd): six maps of 38, 19, 10, 5,
    3 and 1 cells with 4, 6, 6, 6, 4 and 4 anchors (8732), 20 classes and
    background, labels padded to 50 rows with 1-20 valid, batch 32 (2
    for NMS without ``nms_topk``)."""
    maps = [(38, (0.1, 0.141), (1, 2, 0.5)),
            (19, (0.2, 0.272), (1, 2, 0.5, 3, 1.0 / 3)),
            (10, (0.37, 0.447), (1, 2, 0.5, 3, 1.0 / 3)),
            (5, (0.54, 0.619), (1, 2, 0.5, 3, 1.0 / 3)),
            (3, (0.71, 0.79), (1, 2, 0.5)),
            (1, (0.88, 0.961), (1, 2, 0.5))]
    anchors = np.concatenate([anchors_of(n, n, s, r) for n, s, r in maps], 1)
    return _multibox_cases("ssd300", 32, anchors, 20, 50, 20,
                           full_nms_batch=2)


SSD300_CASES = _ssd300_cases()


def _cotangent(case, k, shape):
    """The seeded cotangent of output ``k`` (a CPU tensor of ``shape``)."""
    rng = _rng("cot%s%d" % (case.name, k))
    return torch.from_numpy(_f32(rng.randn(*shape)))


def out_shapes(case):
    """The shapes of the case's outputs, from a run on ``meta`` tensors."""
    ins = [torch.empty(a.shape, dtype=torch.float32, device="meta")
           for a in case.arrays]
    outs = get_op(case.name).fcompute(dict(case.params, _is_train=False),
                                      *ins)
    return [tuple(o.shape) for o in outs]


def run_case(case, ctx, inputs_of=None, no_sync=False):
    """(outputs, gradients) of the case on ``ctx`` as CPU tensors: the
    gradients of the inputs named by ``case.grad`` under the seeded
    cotangents of the float outputs (empty without ``grad``).
    ``inputs_of`` may change the numpy inputs first (a control). With
    ``no_sync`` the op and its backward run under
    ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation
    raises."""
    dev = ctx.torch_device()
    arrays = case.arrays if inputs_of is None else \
        [inputs_of(a) for a in case.arrays]
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in arrays]
    for i in case.grad:
        ins[i].requires_grad_(True)
    params = dict(case.params, _ctx=ctx, _is_train=False)
    cots = [_cotangent(case, k, shape).to(dev)
            for k, shape in enumerate(out_shapes(case))] if case.grad else []
    if no_sync:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.enable_grad() if case.grad else torch.no_grad():
            outs = get_op(case.name).fcompute(params, *ins)
            grads = []
            if case.grad:
                heads = [(o, cots[k])
                         for k, o in enumerate(outs) if o.requires_grad]
                grads = torch.autograd.grad([h for h, _ in heads],
                                            [ins[i] for i in case.grad],
                                            [c for _, c in heads])
    finally:
        if no_sync:
            torch.cuda.set_sync_debug_mode(0)
    return ([o.detach().cpu() for o in outs],
            [g.detach().cpu() for g in grads])


def reading(got, want, family, norm=False):
    """0 for equal results; else the largest difference over the
    reference's largest magnitude, or with ``norm`` the difference's norm
    over the reference's (gradients), the worst over the tensors; inf for
    an exact family or a shape or dtype that differs."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf")
        if torch.equal(g, w):
            continue
        if family == "exact":
            return float("inf")
        g64, w64 = g.double(), w.double()
        if norm:
            diff = float(torch.linalg.vector_norm(g64 - w64))
            scale = float(torch.linalg.vector_norm(w64)) or 1.0
        else:
            diff = float((g64 - w64).abs().max())
            scale = float(w64.abs().max()) or 1.0
        worst = max(worst, diff / scale)
    return worst


def compare(case, ctx, ref=None, inputs_of=None, no_sync=False):
    """(forward reading, gradient reading) of the case on ``ctx`` against
    ``ref`` (cpu() by default); ``no_sync`` as :func:`run_case` takes it,
    on ``ctx``."""
    want = run_case(case, ref or cpu())
    got = run_case(case, ctx, inputs_of, no_sync)
    return reading(got[0], want[0], case.family), \
        reading(got[1], want[1], case.family, norm=True)


def _bf16_rounded(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float() \
        .numpy()


def control(ctx, family, cases=CASES, ref=None):
    """The family's largest reading, forward or gradient, with the card's
    inputs rounded to bf16: what a kernel that lost f32 precision reads."""
    return max(max(compare(c, ctx, ref, _bf16_rounded)) for c in cases
               if c.family == family)
