"""Detection and spatial operators: the SSD MultiBox suite, RCNN Proposal
and ProposalTarget, bipartite matching, the spatial transformer family,
deformable convolution, and position-sensitive and aligned ROI pooling.

Counterpart of the ops of `mxnet_tpu/ops/detection.py` that the SSD and
Faster-RCNN examples reach, with the same names and aliases:
``_contrib_MultiBoxPrior``, ``_contrib_MultiBoxTarget``,
``_contrib_MultiBoxDetection``, ``_contrib_bipartite_matching``,
``_contrib_Proposal`` (``_contrib_MultiProposal``), ``ProposalTarget``,
``BilinearSampler``, ``GridGenerator``, ``SpatialTransformer``,
``_contrib_DeformableConvolution``, ``_contrib_PSROIPooling``,
``_contrib_DeformablePSROIPooling`` and ``_contrib_ROIAlign_v2``. The rest
of that file (the Mask-RCNN targets, correlation, the fork's losses and
point-cloud ops) is not ported yet.

Every op has static shapes and reads nothing back to the host, so it runs
on the card without a synchronisation, inside a CUDA graph capture where
it draws no random numbers, and on ``meta`` tensors for shape inference.
Constants are Python scalars in elementwise ops (no host-to-device copy).
Where the JAX op sorts (``argsort``, ``lax.top_k``) the port sorts stably,
so ties keep the lower index first as there; where it picks with
``argmax`` the port's ``argmax`` also takes the first maximum; a maximum
whose gradient matters is ``torch.amax``, which splits the gradient over
equal maxima as ``jnp.max``'s does. The sequential loops of the JAX ops
(bipartite matching: one round a ground-truth box or a match) are Python
loops of batched tensor ops; greedy NMS is N1 (`ops/contrib_ops.py`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from .contrib_ops import box_iou_xyxy, greedy_nms_keep, tuple_param
from .nn import _attr_bool, _attr_num
from .registry import register

__all__ = []

_INF = float("inf")


def _f32(v):
    """``v`` rounded to f32, as ``jnp.asarray(.., float32)`` rounds it."""
    return float(np.float32(v))


def _full(value, like, dtype=None):
    return torch.full((), value, dtype=dtype or like.dtype, device=like.device)


def _div(x, d):
    """``x / d`` for a Python number ``d``, divided on the device: CUDA's
    division by a host scalar multiplies by its reciprocal, which rounds
    otherwise than the CPU's (and the JAX package's) division."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _rank(order):
    """The inverse permutation of each row of ``order`` (the rank of each
    element in the sorted order)."""
    pos = torch.arange(order.shape[-1], device=order.device)
    return torch.empty_like(order).scatter_(-1, order, pos.expand_as(order))


# ---------------------------------------------------------------------------
# SSD MultiBox suite
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def _multibox_prior(params, data):
    """Anchors of data (B, C, H, W): (1, H*W*A, 4) corner boxes in [0, 1];
    A = num_sizes - 1 + num_ratios, sizes first, then the ratios past the
    first, per location."""
    sizes = tuple_param(params, "sizes", (1.0,))
    ratios = tuple_param(params, "ratios", (1.0,))
    steps = tuple_param(params, "steps", (-1.0, -1.0))
    offsets = tuple_param(params, "offsets", (0.5, 0.5))
    clip = _attr_bool(params, "clip", False)
    h, w = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    f32 = torch.float32
    cy = (torch.arange(h, dtype=f32, device=data.device) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=f32, device=data.device) + offsets[1]) * step_x
    half = [(s * h / w / 2.0, s / 2.0) for s in sizes]
    for r in ratios[1:]:
        sr = math.sqrt(r)
        half.append((sizes[0] * h / w * sr / 2.0, sizes[0] / sr / 2.0))
    cyg = cy[:, None].expand(h, w)
    cxg = cx[None, :].expand(h, w)
    boxes = torch.stack([
        torch.stack([cxg - _f32(hw), cyg - _f32(hh), cxg + _f32(hw),
                     cyg + _f32(hh)], dim=-1) for hw, hh in half], dim=2)
    boxes = boxes.reshape(1, h * w * len(half), 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return (boxes.to(data.dtype),)


def _encode_box(anchor, gt, variances):
    aw = anchor[..., 2] - anchor[..., 0]
    ah = anchor[..., 3] - anchor[..., 1]
    ax = (anchor[..., 0] + anchor[..., 2]) * 0.5
    ay = (anchor[..., 1] + anchor[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    vx, vy, vw, vh = variances
    eps = 1e-12
    aw_, ah_ = torch.clamp(aw, min=eps), torch.clamp(ah, min=eps)
    return torch.stack([
        _div((gx - ax) / aw_, vx), _div((gy - ay) / ah_, vy),
        _div(torch.log(torch.clamp(gw / aw_, min=eps)), vw),
        _div(torch.log(torch.clamp(gh / ah_, min=eps)), vh)], dim=-1)


def _decode_box(anchor, pred, variances, clip):
    aw = anchor[..., 2] - anchor[..., 0]
    ah = anchor[..., 3] - anchor[..., 1]
    ax = (anchor[..., 0] + anchor[..., 2]) * 0.5
    ay = (anchor[..., 1] + anchor[..., 3]) * 0.5
    vx, vy, vw, vh = variances
    ox = pred[..., 0] * vx * aw + ax
    oy = pred[..., 1] * vy * ah + ay
    ow = torch.exp(pred[..., 2] * vw) * aw * 0.5
    oh = torch.exp(pred[..., 3] * vh) * ah * 0.5
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          num_outputs=3)
def _multibox_target(params, anchor, label, cls_pred):
    """SSD training targets. anchor (1, A, 4), label (B, G, >=5) rows
    [cls, x1, y1, x2, y2, ...] padded with -1, cls_pred (B, C, A). Returns
    loc_target (B, A*4), loc_mask (B, A*4) and cls_target (B, A), classes
    shifted by +1 (0 background, ``ignore_label`` for don't-care anchors):
    G rounds of bipartite matching, then threshold matching, then
    hard-negative mining when ``negative_mining_ratio`` > 0."""
    overlap_threshold = _attr_num(params, "overlap_threshold", 0.5)
    ignore_label = _attr_num(params, "ignore_label", -1.0)
    neg_ratio = _attr_num(params, "negative_mining_ratio", -1.0)
    neg_thresh = _attr_num(params, "negative_mining_thresh", 0.5)
    min_neg = int(_attr_num(params, "minimum_negative_samples", 0))
    variances = tuple_param(params, "variances", (0.1, 0.1, 0.2, 0.2))
    anchor, label, cls_pred = anchor.detach(), label.detach(), \
        cls_pred.detach()
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    B, G = label.shape[0], label.shape[1]
    dev = label.device
    lab = label
    # valid gts: the prefix before the first cls == -1
    valid_gt = torch.cumprod((lab[..., 0] != -1.0).to(torch.int32),
                             dim=1).bool()                      # (B, G)
    n_valid = valid_gt.sum(dim=1)
    ious = box_iou_xyxy(anchors[None], lab[..., 1:5])          # (B, A, G)
    ious = torch.where(valid_gt[:, None, :], ious, _full(-1.0, ious))

    a_idx = torch.arange(A, device=dev)
    g_idx = torch.arange(G, device=dev)
    aflag = torch.zeros((B, A), dtype=torch.bool, device=dev)
    agt = torch.full((B, A), -1, dtype=torch.int64, device=dev)
    aiou = torch.full((B, A), -1.0, dtype=ious.dtype, device=dev)
    gdone = ~valid_gt
    for _ in range(G):          # bipartite matching: G global argmaxes
        m = torch.where(aflag[:, :, None] | gdone[:, None, :],
                        _full(-1.0, ious), ious)
        flat = torch.argmax(m.reshape(B, -1), dim=1)
        best = torch.amax(m.reshape(B, -1), dim=1)
        bi, bg = flat // G, flat % G
        ok = best > 1e-6
        hit_a = (a_idx[None] == bi[:, None]) & ok[:, None]
        hit_g = (g_idx[None] == bg[:, None]) & ok[:, None]
        aflag = aflag | hit_a
        agt = torch.where(hit_a, bg[:, None], agt)
        aiou = torch.where(hit_a, best[:, None], aiou)
        gdone = gdone | hit_g

    best_gt = torch.argmax(ious, dim=2)
    best_iou = torch.amax(ious, dim=2)
    use_thr = (~aflag) & (best_iou > overlap_threshold) & \
        (overlap_threshold > 0)
    agt = torch.where(aflag, agt, best_gt)
    aiou = torch.where(aflag, aiou, best_iou)
    aflag = aflag | use_thr
    num_pos = aflag.sum(dim=1)

    if neg_ratio > 0:       # hard negatives: lowest background prob first
        prob_bg = torch.softmax(cls_pred, dim=1)[:, 0]          # (B, A)
        cand = (~aflag) & (aiou < neg_thresh)
        num_neg = torch.clamp((num_pos.to(torch.float64) * neg_ratio)
                              .to(torch.int64), min_neg, A)
        num_neg = torch.minimum(num_neg, A - num_pos)
        key = torch.where(cand, prob_bg, _full(_INF, prob_bg))
        rank = _rank(torch.sort(key, dim=1, stable=True).indices)
        neg = cand & (rank < num_neg[:, None])
    else:
        neg = ~aflag

    has_gt = (n_valid > 0)[:, None]
    aflag = aflag & has_gt
    neg = torch.where(has_gt, neg, torch.ones_like(neg))
    gi = torch.clamp(agt, 0, G - 1)
    gt_rows = torch.gather(lab, 1, gi[..., None].expand(-1, -1, lab.shape[2]))
    cls_t = torch.where(aflag, gt_rows[..., 0] + 1.0,
                        torch.where(neg, _full(0.0, lab),
                                    _full(ignore_label, lab)))
    enc = _encode_box(anchors[None], gt_rows[..., 1:5], variances)
    loc_t = torch.where(aflag[..., None], enc, _full(0.0, enc))
    loc_m = aflag[..., None].expand(B, A, 4).to(loc_t.dtype)
    dt = anchor.dtype
    return (loc_t.reshape(B, -1).to(dt), loc_m.reshape(B, -1).to(dt),
            cls_t.to(dt))


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",))
def _multibox_detection(params, cls_prob, loc_pred, anchor):
    """SSD decode and NMS. cls_prob (B, C, A), loc_pred (B, A*4), anchor
    (1, A, 4) -> (B, A, 6) rows [id, score, x1, y1, x2, y2] in descending
    score order; invalid and suppressed rows -1 (suppressed rows keep their
    score and box, as in the JAX op). Class ids past ``background_id``
    shift down by one. With ``nms_topk`` > 0 NMS sees only the topk
    highest-scoring valid anchors, and the others count as suppressed."""
    clip = _attr_bool(params, "clip", True)
    threshold = _attr_num(params, "threshold", 0.01)
    bg_id = int(_attr_num(params, "background_id", 0))
    nms_threshold = _attr_num(params, "nms_threshold", 0.5)
    force = _attr_bool(params, "force_suppress")
    variances = tuple_param(params, "variances", (0.1, 0.1, 0.2, 0.2))
    nms_topk = int(_attr_num(params, "nms_topk", -1))
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    B, C = cls_prob.shape[0], cls_prob.shape[1]
    dev = cls_prob.device
    is_bg = (torch.arange(C, device=dev) == bg_id)[None, :, None]
    scores = torch.where(is_bg, _full(-_INF, cls_prob), cls_prob)
    cid = torch.argmax(scores, dim=1)                           # (B, A)
    score = torch.amax(scores, dim=1)
    valid = score >= threshold
    boxes = _decode_box(anchors[None], loc_pred.reshape(B, A, 4), variances,
                        clip)
    out_id = torch.where(valid, (cid - (cid > bg_id).to(cid.dtype))
                         .to(cls_prob.dtype), _full(-1.0, cls_prob))
    if 0 < nms_threshold <= 1:
        if nms_topk > 0:
            k = min(A, nms_topk)
            masked = torch.where(valid, score, _full(-_INF, score))
            top_scr, sel = torch.sort(masked, dim=1, descending=True,
                                      stable=True)
            top_scr, sel = top_scr[:, :k], sel[:, :k]
            keep_k = greedy_nms_keep(
                torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4)),
                top_scr, torch.isfinite(top_scr), torch.gather(cid, 1, sel),
                nms_threshold, -1, force)
            keep = torch.zeros((B, A), dtype=torch.bool, device=dev) \
                .scatter(1, sel, keep_k)
        else:
            keep = greedy_nms_keep(boxes, score, valid, cid, nms_threshold,
                                   -1, force)
        out_id = torch.where(valid & ~keep, _full(-1.0, out_id), out_id)
    rows = torch.cat([out_id[..., None], score[..., None], boxes], dim=-1)
    rows = torch.where(valid[..., None], rows, _full(-1.0, rows))
    key = torch.where(valid, score, _full(-_INF, score))
    perm = torch.sort(-key, dim=1, stable=True).indices
    rows = torch.gather(rows, 1, perm[..., None].expand(-1, -1, 6))
    return (rows.to(cls_prob.dtype),)


@register("_contrib_bipartite_matching", aliases=("bipartite_matching",),
          num_outputs=2)
def _bipartite_matching(params, scores):
    """Greedy bipartite matching over (..., R, C) scores: take the best
    unmatched (row, col) pair while its score passes ``threshold`` (below
    it with ``is_ascend``), at most ``topk`` + 1 matches when ``topk`` > 0.
    Returns row->col (..., R) and col->row (..., C), -1 unmatched."""
    thresh = _attr_num(params, "threshold", 0.0)
    is_ascend = _attr_bool(params, "is_ascend")
    topk = int(_attr_num(params, "topk", -1))
    shape = scores.shape
    R, C = shape[-2], shape[-1]
    s = scores.detach().reshape((-1, R, C))
    if is_ascend:
        s, thresh = -s, -thresh
    rounds = min(R, C) if topk <= 0 else min(topk + 1, min(R, C))
    dev = scores.device
    rm = torch.full(s.shape[:2], -1.0, dtype=scores.dtype, device=dev)
    cm = torch.full((s.shape[0], C), -1.0, dtype=scores.dtype, device=dev)
    r_idx = torch.arange(R, device=dev)
    c_idx = torch.arange(C, device=dev)
    for _ in range(rounds):
        j = torch.argmax(s.reshape(s.shape[0], -1), dim=1)
        best = torch.amax(s.reshape(s.shape[0], -1), dim=1)
        r, c = j // C, j % C
        ok = (best > thresh)[:, None]
        hit_r = (r_idx[None] == r[:, None]) & ok
        hit_c = (c_idx[None] == c[:, None]) & ok
        rm = torch.where(hit_r, c[:, None].to(rm.dtype), rm)
        cm = torch.where(hit_c, r[:, None].to(cm.dtype), cm)
        s = torch.where(hit_r[:, :, None] | hit_c[:, None, :],
                        _full(-_INF, s), s)
    return (rm.reshape(shape[:-1]), cm.reshape(shape[:-2] + (C,)))


# ---------------------------------------------------------------------------
# RCNN Proposal
# ---------------------------------------------------------------------------
def _rcnn_base_anchors(base_size, scales, ratios):
    """RCNN base anchors centred on a base_size cell, ratios outer."""
    px, py = (base_size - 1) * 0.5, (base_size - 1) * 0.5
    out = []
    for r in ratios:
        size = base_size * base_size / r
        ws = round(math.sqrt(size))
        hs = round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            out.append([px - 0.5 * (w - 1), py - 0.5 * (h - 1),
                        px + 0.5 * (w - 1), py + 0.5 * (h - 1)])
    return np.asarray(out, np.float32)


@register("_contrib_Proposal", aliases=("Proposal", "_contrib_MultiProposal"),
          num_outputs=lambda p: 2 if _attr_bool(p, "output_score") else 1)
def _proposal(params, cls_prob, bbox_pred, im_info):
    """RPN proposals. cls_prob (B, 2A, H, W), bbox_pred (B, 4A, H, W),
    im_info (B, 3) [h, w, scale] -> rois (B*post_nms_top_n, 5)
    [batch_idx, x1, y1, x2, y2] (and scores (B*post, 1) with
    ``output_score``): decode, clip, drop boxes under ``rpn_min_size``,
    the top ``rpn_pre_nms_top_n`` by score, NMS, the top
    ``rpn_post_nms_top_n`` kept (short rows repeat the best box, as in the
    JAX op)."""
    scales = tuple_param(params, "scales", (4.0, 8.0, 16.0, 32.0))
    ratios = tuple_param(params, "ratios", (0.5, 1.0, 2.0))
    stride = int(_attr_num(params, "feature_stride", 16))
    pre_top = int(_attr_num(params, "rpn_pre_nms_top_n", 6000))
    post_top = int(_attr_num(params, "rpn_post_nms_top_n", 300))
    nms_thresh = _attr_num(params, "threshold", 0.7)
    min_size = _attr_num(params, "rpn_min_size", 16)
    output_score = _attr_bool(params, "output_score")

    B, _, H, W = cls_prob.shape
    dev = cls_prob.device
    base = _rcnn_base_anchors(stride, scales, ratios)
    A = base.shape[0]
    f32 = torch.float32
    sy = (torch.arange(H, dtype=f32, device=dev) * stride)[:, None] \
        .expand(H, W)
    sx = (torch.arange(W, dtype=f32, device=dev) * stride)[None, :] \
        .expand(H, W)
    anchors = torch.stack([
        torch.stack([sx + float(b[0]), sy + float(b[1]), sx + float(b[2]),
                     sy + float(b[3])], dim=-1) for b in base],
        dim=2).reshape(-1, 4)                                  # (H*W*A, 4)

    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    deltas = bbox_pred.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + 0.5 * (aw - 1.0)
    ay = anchors[:, 1] + 0.5 * (ah - 1.0)
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(deltas[..., 2]) * aw
    h = torch.exp(deltas[..., 3]) * ah
    zero = _full(0.0, cx)
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    x1 = torch.minimum(torch.maximum(cx - 0.5 * (w - 1.0), zero), im_w - 1.0)
    y1 = torch.minimum(torch.maximum(cy - 0.5 * (h - 1.0), zero), im_h - 1.0)
    x2 = torch.minimum(torch.maximum(cx + 0.5 * (w - 1.0), zero), im_w - 1.0)
    y2 = torch.minimum(torch.maximum(cy + 0.5 * (h - 1.0), zero), im_h - 1.0)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    ms = min_size * im_info[:, 2:3]
    valid = ((x2 - x1 + 1.0) >= ms) & ((y2 - y1 + 1.0) >= ms)
    n = boxes.shape[1]
    k = min(pre_top, n)
    scr, sel = torch.sort(torch.where(valid, fg, _full(-_INF, fg)), dim=1,
                          descending=True, stable=True)
    scr, sel = scr[:, :k], sel[:, :k]
    bsel = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
    keep = greedy_nms_keep(bsel, scr, torch.isfinite(scr), None, nms_thresh,
                           -1, True)
    order = torch.sort(-torch.where(keep, scr, _full(-_INF, scr)), dim=1,
                       stable=True).indices
    if k < post_top:
        order = torch.cat([order, torch.zeros((B, post_top - k),
                                              dtype=order.dtype,
                                              device=dev)], dim=1)
    sel2 = order[:, :post_top]
    ok = torch.gather(keep, 1, sel2)
    kept = torch.gather(bsel, 1, sel2[..., None].expand(-1, -1, 4))
    rois = torch.where(ok[..., None], kept, _full(0.0, bsel))
    out_scr = torch.where(ok, torch.gather(scr, 1, sel2), _full(0.0, scr))
    bidx = torch.arange(B, dtype=cls_prob.dtype, device=dev)[:, None] \
        .expand(B, post_top).reshape(-1)
    rois = torch.cat([bidx[:, None], rois.reshape(-1, 4).to(cls_prob.dtype)],
                     dim=1)
    if output_score:
        return rois, out_scr.reshape(-1, 1).to(cls_prob.dtype)
    return (rois,)


# ---------------------------------------------------------------------------
# ProposalTarget (Faster-RCNN roi sampling)
# ---------------------------------------------------------------------------
def _masked_rank(key, mask):
    """Rank of each element among the ``mask`` members of its row ordered
    by ``key`` ascending (stable); non-members get N."""
    n = key.shape[-1]
    order = torch.sort(torch.where(mask, key, _full(_INF, key)), dim=-1,
                       stable=True).indices
    return torch.where(mask, _rank(order), torch.full_like(order, n))


def _bbox_overlap_plus1(boxes, query):
    """IoU with the reference's +1 pixel convention: boxes (..., N, 4),
    query (..., G, 4) -> (..., N, G)."""
    x1, y1, x2, y2 = (boxes[..., k, None] for k in range(4))
    qx1, qy1, qx2, qy2 = (query[..., None, :, k] for k in range(4))
    iw = torch.minimum(x2, qx2) - torch.maximum(x1, qx1) + 1.0
    ih = torch.minimum(y2, qy2) - torch.maximum(y1, qy1) + 1.0
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    qarea = (qx2 - qx1 + 1.0) * (qy2 - qy1 + 1.0)
    return inter / (area + qarea - inter)


def _bbox_transform_norm(ex, gt, mean, std):
    """Normalised regression targets of boxes ``ex`` towards ``gt``
    (..., 4); ``mean`` and ``std`` four floats."""
    ew = ex[..., 2] - ex[..., 0] + 1.0
    eh = ex[..., 3] - ex[..., 1] + 1.0
    ecx = ex[..., 0] + 0.5 * (ew - 1.0)
    ecy = ex[..., 1] + 0.5 * (eh - 1.0)
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gcx = gt[..., 0] + 0.5 * (gw - 1.0)
    gcy = gt[..., 1] + 0.5 * (gh - 1.0)
    t = [(gcx - ecx) / (ew + 1e-14), (gcy - ecy) / (eh + 1e-14),
         torch.log(gw / ew), torch.log(gh / eh)]
    return torch.stack([_div(v - m, s) for v, m, s in zip(t, mean, std)],
                       dim=-1)


def _pt_params(params):
    """(mean, std, weight): four f32-rounded floats each."""
    return tuple(tuple(_f32(v) for v in tuple_param(params, key, default))
                 for key, default in (("bbox_mean", (0.0, 0.0, 0.0, 0.0)),
                                      ("bbox_std", (0.1, 0.1, 0.2, 0.2)),
                                      ("bbox_weight", (1.0, 1.0, 1.0, 1.0))))


def _ohem_scores(params, extra, op_name):
    """The cls_prob input of ``ohem=True`` (detached), else None."""
    if not _attr_bool(params, "ohem"):
        return None
    if not extra:
        raise MXNetError(
            "%s(ohem=True) needs a cls_prob input of shape "
            "(batch, rois, num_classes) — predicted probabilities to rank "
            "hard examples by loss" % op_name)
    return extra[0].detach()


def _sample_rois(gen, rois, gt, *, rois_per_image, fg_cap, num_classes,
                 fg_thresh, bg_hi, bg_lo, without_gt, mean, std, weight,
                 score=None):
    """Fixed-shape roi sampling of every image at once (the JAX package's
    ``_sample_rois_one_image`` over a batch): candidates are the image's
    rois then its valid gt boxes; fg first, then bg, then negatives pad the
    quota, each ranked by a uniform draw from ``gen`` or, with ``score``
    (B, R, num_classes), hardest-first by classification loss (gt boxes
    hardest); a quota the pools cannot fill repeats the selected rows.
    Returns (rows (B, P, 5), labels (B, P), targets, weights (B, P, 4C))."""
    B, R = rois.shape[0], rois.shape[1]
    G = gt.shape[1]
    dev = rois.device
    valid_gt = gt[..., 4] != -1                                 # (B, G)
    any_gt = valid_gt.any(dim=1, keepdim=True)
    img = torch.arange(B, dtype=gt.dtype, device=dev)[:, None, None] \
        .expand(B, G, 1)
    cand = torch.cat([rois, torch.cat([img, gt[..., :4]], dim=2)], dim=1)
    cand_valid = torch.cat([torch.ones((B, R), dtype=torch.bool, device=dev),
                            valid_gt & (not without_gt)], dim=1)
    N = R + G
    ious = _bbox_overlap_plus1(cand[..., 1:5], gt[..., :4])     # (B, N, G)
    ious = torch.where(valid_gt[:, None, :], ious, _full(-1.0, ious))
    assignment = torch.argmax(ious, dim=2)
    max_ov = torch.where(any_gt, torch.amax(ious, dim=2), _full(0.0, ious))
    cand_label = torch.where(any_gt, torch.gather(gt[..., 4], 1, assignment),
                             _full(0.0, gt))
    fg = cand_valid & (max_ov >= fg_thresh)
    bg = cand_valid & (max_ov >= bg_lo) & (max_ov < bg_hi)
    neg = cand_valid & ~fg

    if score is None:
        draws = torch.rand((3, B, N), generator=gen, device=dev)
        fg_key, bg_key, pad_key = draws[0], draws[1], draws[2]
    else:
        tgt = torch.where(fg[:, :R], cand_label[:, :R],
                          _full(0.0, cand_label)).to(torch.int64)
        p = torch.gather(score, 2, tgt[..., None])[..., 0]
        hard = -torch.log(torch.clamp(p, min=1e-12))
        hard = torch.cat([hard, torch.full((B, G), _INF, dtype=hard.dtype,
                                           device=dev)], dim=1)
        fg_key = bg_key = pad_key = -hard
    fg_rank = _masked_rank(fg_key, fg)
    n_fg = torch.clamp(fg.sum(dim=1, keepdim=True), max=fg_cap)
    sel_fg = fg & (fg_rank < n_fg)
    bg_rank = _masked_rank(bg_key, bg)
    n_bg = torch.minimum(bg.sum(dim=1, keepdim=True), rois_per_image - n_fg)
    sel_bg = bg & (bg_rank < n_bg)
    pool = neg & ~sel_bg
    pad_rank = _masked_rank(pad_key, pool)
    sel_pad = pool & (pad_rank < rois_per_image - n_fg - n_bg)

    idx = torch.arange(N, device=dev).expand(B, N)
    cat = torch.where(sel_fg, 0, torch.where(sel_bg, 1,
                                             torch.where(sel_pad, 2, 3)))
    tie = torch.where(sel_fg, fg_rank, torch.where(
        sel_bg, bg_rank, torch.where(sel_pad, pad_rank, idx)))
    order = torch.sort(cat * (N + 1) + tie, dim=1, stable=True) \
        .indices[:, :rois_per_image]
    n_sel = n_fg + n_bg + sel_pad.sum(dim=1, keepdim=True)
    pos = torch.arange(rois_per_image, device=dev)[None]
    src = torch.where(pos < n_sel, pos,
                      torch.remainder(pos, torch.clamp(n_sel, min=1)))
    kept = torch.gather(order, 1, src)
    labels = torch.where(src < n_fg, torch.gather(cand_label, 1, kept),
                         _full(0.0, cand_label))
    rows = torch.gather(cand, 1, kept[..., None].expand(-1, -1, 5))
    gt_kept = torch.gather(gt[..., :4], 1, torch.gather(assignment, 1, kept)
                           [..., None].expand(-1, -1, 4))
    gt_kept = torch.where(any_gt[..., None], gt_kept, _full(0.0, gt_kept))
    t = _bbox_transform_norm(rows[..., 1:5], gt_kept, mean, std)
    cls = labels.to(torch.int64)
    onehot = (torch.arange(num_classes, device=dev) == cls[..., None]) & \
        (cls > 0)[..., None]                                    # (B, P, C)
    targets = (onehot[..., None] * t[:, :, None, :]).reshape(
        B, rois_per_image, num_classes * 4)
    wt = torch.stack([_full(v, t) for v in weight])
    weights = (onehot[..., None] * wt).reshape(B, rois_per_image,
                                               num_classes * 4)
    return rows, labels, targets, weights


def _pt_draws(params):
    return not _attr_bool(params, "ohem")


@register("ProposalTarget", num_outputs=4, need_rng=_pt_draws)
def _proposal_target(params, rois, gt_boxes, *cls_prob):
    """Faster-RCNN roi sampling and regression targets. rois (B, R, 5)
    [batch_idx, x1, y1, x2, y2]; gt_boxes (B, G, 5) [x1, y1, x2, y2, cls],
    cls -1 for padding. Outputs rois (batch_rois, 5), label (batch_rois,),
    bbox_target and bbox_weight (batch_rois, num_classes*4); no gradient.
    The random path draws from the op's generator (``need_rng``);
    ``ohem=True`` ranks by loss against the extra cls_prob input, draws
    nothing and is deterministic."""
    score = _ohem_scores(params, cls_prob, "ProposalTarget")
    num_classes = int(_attr_num(params, "num_classes", 0))
    batch_images = int(_attr_num(params, "batch_images", 1))
    batch_rois = int(_attr_num(params, "batch_rois", 128))
    rois_per_image = batch_rois // batch_images
    fg_cap = int(rois_per_image * _attr_num(params, "fg_fraction", 0.25))
    mean, std, weight = _pt_params(params)
    out_rois, labels, targets, weights = _sample_rois(
        params.get("_generator"), rois.detach(), gt_boxes.detach(),
        rois_per_image=rois_per_image, fg_cap=fg_cap,
        num_classes=num_classes,
        fg_thresh=_attr_num(params, "fg_thresh", 0.5),
        bg_hi=_attr_num(params, "bg_thresh_hi", 0.5),
        bg_lo=_attr_num(params, "bg_thresh_lo", 0.0),
        without_gt=_attr_bool(params, "proposal_without_gt"),
        mean=mean, std=std, weight=weight, score=score)
    return (out_rois.reshape(batch_rois, 5), labels.reshape(batch_rois),
            targets.reshape(batch_rois, num_classes * 4),
            weights.reshape(batch_rois, num_classes * 4))


# ---------------------------------------------------------------------------
# Spatial transformer family
# ---------------------------------------------------------------------------
def _affine_grid(theta, h, w):
    """theta (B, 6) -> sampling grid (B, 2, h, w) in [-1, 1] (x, y)."""
    dev = theta.device
    ys = torch.linspace(-1.0, 1.0, h, dtype=theta.dtype, device=dev)
    xs = torch.linspace(-1.0, 1.0, w, dtype=theta.dtype, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    src = torch.stack([gx, gy, torch.ones_like(gx)], dim=0).reshape(3, -1)
    out = torch.matmul(theta.reshape(-1, 2, 3), src)           # (B, 2, h*w)
    return out.reshape(-1, 2, h, w)


def _bilinear_sample(data, grid):
    """data (B, C, H, W), grid (B, 2, H', W') x/y in [-1, 1] -> (B, C, H',
    W'); samples outside the image read 0."""
    B, C, H, W = data.shape
    gx = (grid[:, 0] + 1.0) * (W - 1) / 2.0                    # (B, H', W')
    gy = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]
    flat = data.reshape(B, C, H * W)
    out_hw = grid.shape[2] * grid.shape[3]

    def gather(y, x):
        yi = torch.clamp(y, 0, H - 1).to(torch.int64)
        xi = torch.clamp(x, 0, W - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(B, 1, out_hw).expand(B, C, out_hw)
        v = torch.gather(flat, 2, idx).reshape(B, C, *grid.shape[2:])
        inb = (y >= 0) & (y <= H - 1) & (x >= 0) & (x <= W - 1)
        return v * inb[:, None].to(data.dtype)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


@register("BilinearSampler")
def _bilinear_sampler(params, data, grid):
    return (_bilinear_sample(data, grid).to(data.dtype),)


@register("GridGenerator")
def _grid_generator(params, data):
    """``affine``: data (B, 6) -> grid (B, 2, H, W) over ``target_shape``;
    ``warp``: data (B, 2, H, W) optical flow -> normalised grid."""
    if params.get("transform_type", "affine") == "affine":
        h, w = (int(v) for v in tuple_param(params, "target_shape", (0, 0)))
        if h <= 0 or w <= 0:
            raise ValueError("GridGenerator(transform_type='affine') "
                             "requires target_shape=(H, W)")
        return (_affine_grid(data, h, w).to(data.dtype),)
    B, _, h, w = data.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=data.dtype, device=data.device),
        torch.arange(w, dtype=data.dtype, device=data.device), indexing="ij")
    x = _div((gx[None] + data[:, 0]) * 2.0, max(w - 1, 1)) - 1.0
    y = _div((gy[None] + data[:, 1]) * 2.0, max(h - 1, 1)) - 1.0
    return (torch.stack([x, y], dim=1).to(data.dtype),)


@register("SpatialTransformer")
def _spatial_transformer(params, data, loc):
    """Affine spatial transformer with bilinear sampling."""
    h, w = (int(v) for v in tuple_param(params, "target_shape", (0, 0)))
    if h == 0 or w == 0:
        h, w = data.shape[2], data.shape[3]
    return (_bilinear_sample(data, _affine_grid(loc, h, w)).to(data.dtype),)


# ---------------------------------------------------------------------------
# Deformable convolution
# ---------------------------------------------------------------------------
@register("_contrib_DeformableConvolution", aliases=("DeformableConvolution",))
def _deformable_conv(params, data, offset, weight, *bias):
    """Deformable convolution v1: each kernel tap bilinear-sampled at its
    learned offset (offset (B, 2*num_deformable_group*kh*kw, oh, ow),
    [group, tap, (y, x)]), then one grouped contraction with the weights
    (``num_group``). The pixel offsets go to [-1, 1] and back through
    ``_bilinear_sample`` as in the JAX op, with its roundings."""
    kh, kw = (int(v) for v in tuple_param(params, "kernel", (3, 3)))
    sh, sw = (int(v) for v in tuple_param(params, "stride", (1, 1)))
    ph, pw = (int(v) for v in tuple_param(params, "pad", (0, 0)))
    dh, dw = (int(v) for v in tuple_param(params, "dilate", (1, 1)))
    ngroup = int(_attr_num(params, "num_deformable_group", 1))
    B, C, H, W = data.shape
    oh = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    off = offset.reshape(B, ngroup, kh * kw, 2, oh, ow)
    dev = data.device
    base_y = (torch.arange(oh, device=dev) * sh - ph)[:, None]
    base_x = (torch.arange(ow, device=dev) * sw - pw)[None, :]
    cpg = C // ngroup
    cols = []
    for g in range(ngroup):
        dg = data[:, g * cpg:(g + 1) * cpg]
        taps = []
        for i, (ky, kx) in enumerate(
                (a, b) for a in range(kh) for b in range(kw)):
            py = base_y + ky * dh + off[:, g, i, 0]
            px = base_x + kx * dw + off[:, g, i, 1]
            gx = _div(px * 2.0, max(W - 1, 1)) - 1.0
            gy = _div(py * 2.0, max(H - 1, 1)) - 1.0
            taps.append(_bilinear_sample(dg, torch.stack([gx, gy], dim=1)))
        cols.append(torch.stack(taps, dim=2))         # (B, cpg, K, oh, ow)
    col = torch.cat(cols, dim=1)
    ng = int(_attr_num(params, "num_group", 1))
    O = weight.shape[0]
    colg = col.reshape(B, ng, (C // ng) * kh * kw, oh * ow)
    wg = weight.reshape(ng, O // ng, (C // ng) * kh * kw)
    out = torch.matmul(wg[None], colg).reshape(B, O, oh, ow)
    if bias and not _attr_bool(params, "no_bias"):
        out = out + bias[0][None, :, None, None]
    return (out.to(data.dtype),)


# ---------------------------------------------------------------------------
# Position-sensitive ROI pooling (R-FCN), its deformable variant, ROIAlign
# ---------------------------------------------------------------------------
def _roi_images(data, bi):
    """data[bi] for roi batch indices ``bi`` (clamped into the batch, as
    the JAX package's gather clamps)."""
    return data[torch.clamp(bi, 0, data.shape[0] - 1)]


@register("_contrib_PSROIPooling", aliases=("PSROIPooling",))
def _psroi_pooling(params, data, rois):
    """Position-sensitive ROI pooling: output bin (d, p, q) averages its
    region of input channel (d*G + gh[p])*G + gh[q]; empty bins give 0."""
    scale = _attr_num(params, "spatial_scale", 1.0)
    D = int(_attr_num(params, "output_dim", 0))
    P = int(_attr_num(params, "pooled_size", 0))
    G = int(_attr_num(params, "group_size", 0)) or P
    B, C, H, W = data.shape
    dev = data.device
    R = rois.shape[0]
    p = torch.arange(P, dtype=torch.float32, device=dev)
    gh = torch.clamp(torch.floor(_div(p * G, P)).to(torch.int64), 0, G - 1)
    img = _roi_images(data, rois[:, 0].to(torch.int64))       # (R, C, H, W)
    start_w = torch.round(rois[:, 1:2]) * scale
    start_h = torch.round(rois[:, 2:3]) * scale
    end_w = (torch.round(rois[:, 3:4]) + 1.0) * scale
    end_h = (torch.round(rois[:, 4:5]) + 1.0) * scale
    roi_w = torch.clamp(end_w - start_w, min=0.1)
    roi_h = torch.clamp(end_h - start_h, min=0.1)
    bin_h, bin_w = _div(roi_h, P), _div(roi_w, P)
    hs = torch.clamp(torch.floor(p * bin_h + start_h), 0, H).to(torch.int64)
    he = torch.clamp(torch.ceil((p + 1) * bin_h + start_h), 0, H) \
        .to(torch.int64)
    ws = torch.clamp(torch.floor(p * bin_w + start_w), 0, W).to(torch.int64)
    we = torch.clamp(torch.ceil((p + 1) * bin_w + start_w), 0, W) \
        .to(torch.int64)
    hh = torch.arange(H, device=dev)
    ww = torch.arange(W, device=dev)
    mh = ((hh >= hs[..., None]) & (hh < he[..., None])).to(data.dtype)
    mw = ((ww >= ws[..., None]) & (ww < we[..., None])).to(data.dtype)
    grouped = img.reshape(R, D, G, G, H, W)[:, :, gh][:, :, :, gh]
    pooled = torch.einsum("rdpqxy,rpx,rqy->rdpq", grouped, mh, mw)
    area = ((he - hs)[:, :, None] * (we - ws)[:, None, :]).to(data.dtype)
    empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]
    out = torch.where(empty[:, None], _full(0.0, pooled),
                      pooled / torch.clamp(area, min=1.0)[:, None])
    return (out,)


@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",), num_outputs=2)
def _deformable_psroi_pooling(params, data, rois, *maybe_trans):
    """Deformable PSROI pooling: each bin shifted by trans * trans_std *
    roi size and averaged over sample_per_part^2 bilinear samples; outputs
    (output, top_count), the count of in-image samples a bin."""
    scale = _attr_num(params, "spatial_scale", 1.0)
    D = int(_attr_num(params, "output_dim", 0))
    P = int(_attr_num(params, "pooled_size", 0))
    G = int(_attr_num(params, "group_size", 0))
    part = int(_attr_num(params, "part_size", 0)) or P
    S = int(_attr_num(params, "sample_per_part", 1))
    trans_std = _attr_num(params, "trans_std", 0.0)
    no_trans = _attr_bool(params, "no_trans")
    if not no_trans and not maybe_trans:
        raise ValueError(
            "DeformablePSROIPooling needs the trans input unless "
            "no_trans=True (the reference op fails on the missing input)")
    B, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    if no_trans:
        ncls = 1
        trans = torch.zeros((R, 2, part, part), dtype=data.dtype, device=dev)
    else:
        trans = maybe_trans[0]
        ncls = trans.shape[1] // 2
    cls_of_ctop = torch.arange(D, device=dev) // (D // ncls)
    pidx = torch.arange(P, device=dev)
    pf = pidx.to(torch.float32)
    gh = torch.clamp(pidx * G // P, 0, G - 1)
    part_h = torch.floor(_div(pf, P) * part).to(torch.int64)
    sidx = torch.arange(S, dtype=torch.float32, device=dev)

    start_w = torch.round(rois[:, 1]) * scale - 0.5
    start_h = torch.round(rois[:, 2]) * scale - 0.5
    end_w = (torch.round(rois[:, 3]) + 1.0) * scale - 0.5
    end_h = (torch.round(rois[:, 4]) + 1.0) * scale - 0.5
    roi_w = torch.clamp(end_w - start_w, min=0.1)
    roi_h = torch.clamp(end_h - start_h, min=0.1)
    bin_h, bin_w = _div(roi_h, P), _div(roi_w, P)
    sub_h, sub_w = _div(bin_h, S), _div(bin_w, S)
    r5 = (slice(None),) + (None,) * 5                          # (R,1,1,1,1,1)

    tr = trans.reshape(R, ncls, 2, part, part)
    tx = tr[:, :, 0][:, :, part_h][:, :, :, part_h] * trans_std  # (R,n,P,P)
    ty = tr[:, :, 1][:, :, part_h][:, :, :, part_h] * trans_std
    wstart = pf[None, None, None, :] * bin_w[:, None, None, None] \
        + start_w[:, None, None, None] + tx * roi_w[:, None, None, None]
    hstart = pf[None, None, :, None] * bin_h[:, None, None, None] \
        + start_h[:, None, None, None] + ty * roi_h[:, None, None, None]
    wcoord = wstart[..., None, None] + sidx[None, None, None, None, None, :] \
        * sub_w[r5]                                          # (R,n,P,P,S,S)
    hcoord = hstart[..., None, None] + sidx[None, None, None, None, :, None] \
        * sub_h[r5]
    valid = ((wcoord >= -0.5) & (wcoord <= W - 0.5)
             & (hcoord >= -0.5) & (hcoord <= H - 0.5))
    wc = torch.clamp(wcoord, 0.0, W - 1.0)
    hc = torch.clamp(hcoord, 0.0, H - 1.0)
    x0 = torch.floor(wc).to(torch.int64)
    y0 = torch.floor(hc).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (wc - x0)[:, cls_of_ctop]                           # (R,D,P,P,S,S)
    fy = (hc - y0)[:, cls_of_ctop]
    validc = valid[:, cls_of_ctop]
    x0, x1, y0, y1 = (t[:, cls_of_ctop] for t in (x0, x1, y0, y1))
    c = (torch.arange(D, device=dev)[:, None, None] * G
         + gh[None, :, None]) * G + gh[None, None, :]        # (D, P, P)
    cb = c[None, :, :, :, None, None]
    img = _roi_images(data, rois[:, 0].to(torch.int64)).reshape(R, -1)

    def at(y, x):
        idx = (cb * H + y) * W + x                           # (R,D,P,P,S,S)
        return torch.gather(img, 1, idx.reshape(R, -1)).reshape(idx.shape)

    val = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
           + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)
    val = torch.where(validc, val, _full(0.0, val))
    cnt = validc.sum(dim=(-1, -2)).to(data.dtype)
    out = torch.where(cnt > 0, val.sum(dim=(-1, -2))
                      / torch.clamp(cnt, min=1.0), _full(0.0, cnt))
    return out, cnt


@register("_contrib_ROIAlign_v2", aliases=("ROIAlign_v2",))
def _roi_align_v2(params, data, rois):
    """ROIAlign with the per-bin maximum of 2x2 bilinear samples at 1/3 and
    2/3 of each bin; rois with a negative batch index, and empty bins,
    give 0. The gradient is split over equal maxima."""
    scale = _attr_num(params, "spatial_scale", 1.0)
    ps = tuple_param(params, "pooled_size", ())
    P_h, P_w = int(ps[0]), int(ps[-1])
    B, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    ph = torch.arange(P_h, dtype=torch.float32, device=dev)
    pw = torch.arange(P_w, dtype=torch.float32, device=dev)
    bi = rois[:, 0].to(torch.int64)
    img = _roi_images(data, torch.clamp(bi, min=0))          # (R, C, H, W)
    sw, sh = rois[:, 1:2] * scale, rois[:, 2:3] * scale
    ew, eh = rois[:, 3:4] * scale, rois[:, 4:5] * scale
    bin_h = _div(eh - sh, P_h)
    bin_w = _div(ew - sw, P_w)
    hs = torch.clamp(ph * bin_h + sh, 0.0, H - 1.0)           # (R, P_h)
    he = torch.clamp((ph + 1) * bin_h + sh, 0.0, H - 1.0)
    ws = torch.clamp(pw * bin_w + sw, 0.0, W - 1.0)
    we = torch.clamp((pw + 1) * bin_w + sw, 0.0, W - 1.0)
    empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]   # (R, P_h, P_w)
    fr = (_f32(1.0 / 3.0), _f32(2.0 / 3.0))
    hpts = torch.stack([hs + (he - hs) * f for f in fr], dim=-1)  # (R,P_h,2)
    wpts = torch.stack([ws + (we - ws) * f for f in fr], dim=-1)
    hh = hpts[:, :, None, :, None]                           # (R,P_h,1,2,1)
    wwp = wpts[:, None, :, None, :]                          # (R,1,P_w,1,2)
    y0 = torch.clamp(torch.floor(hh).to(torch.int64), 0, H - 1)
    y1 = torch.clamp(torch.ceil(hh).to(torch.int64), 0, H - 1)
    x0 = torch.clamp(torch.floor(wwp).to(torch.int64), 0, W - 1)
    x1 = torch.clamp(torch.ceil(wwp).to(torch.int64), 0, W - 1)
    a = torch.where(y0 == y1, _full(0.5, hh), hh - y0)
    b = torch.where(x0 == x1, _full(0.5, wwp), wwp - x0)
    shape = (R, P_h, P_w, 2, 2)
    y0, y1, x0, x1, a, b = (t.expand(shape) for t in (y0, y1, x0, x1, a, b))
    flat = img.reshape(R, C, H * W)

    def at(y, x):
        idx = (y * W + x).reshape(R, 1, -1).expand(R, C, -1)
        return torch.gather(flat, 2, idx).reshape((R, C) + shape[1:])

    a, b = a[:, None], b[:, None]
    v = (at(y0, x0) * (1 - a) * (1 - b) + at(y1, x0) * a * (1 - b)
         + at(y0, x1) * (1 - a) * b + at(y1, x1) * a * b)  # (R,C,P_h,P_w,2,2)
    maxval = torch.amax(v.reshape(R, C, P_h, P_w, 4), dim=-1)
    invalid = empty[:, None] | (bi < 0)[:, None, None, None]
    return (torch.where(invalid, _full(0.0, maxval), maxval),)
