"""Contributed operators: the box ops, ROIPooling, FFT, count sketch,
quadratic and fused attention.

Counterpart of `mxnet_tpu/ops/contrib_ops.py`, every op of it with its
aliases: ``_contrib_quadratic``, ``_contrib_fft`` / ``_contrib_ifft``,
``_contrib_count_sketch``, ``_contrib_box_iou`` (corner and center
formats), ``_contrib_box_nms``, ``ROIPooling`` and
``_contrib_flash_attention``, reached as ``nd.contrib.<Name>`` and
``sym.contrib.<Name>`` (``nd.ROIPooling``). :func:`greedy_nms_keep` is
the NMS that ``box_nms``, ``MultiBoxDetection`` and ``Proposal``
(`ops/detection.py`) share: the sort and un-permute here, the sweep in
`ops/nms_kernel.py` (N1 on CUDA tensors).

No op reads a value back to the host or takes a shape from data: each runs
on the card without a synchronisation and on ``meta`` tensors for shape
inference.
"""
from __future__ import annotations

import torch

from .attention_kernel import FlashAttention
from .nms_kernel import box_iou_xyxy, greedy_nms
from .nn import _attr_bool, _attr_num
from .registry import register

__all__ = ["box_iou_xyxy", "greedy_nms_keep", "tuple_param"]


def tuple_param(params, key, default):
    """A tuple attribute as floats; a graph's JSON gives it as a string,
    and a single number is a tuple of one."""
    v = params.get(key, default)
    if isinstance(v, str):
        v = [t for t in v.strip("()[] ").split(",") if t.strip()]
    elif isinstance(v, (int, float)):
        v = (v,)
    return tuple(float(t) for t in v)


@register("_contrib_quadratic", aliases=("quadratic",))
def _quadratic(params, x):
    a = _attr_num(params, "a", 0.0)
    b = _attr_num(params, "b", 0.0)
    c = _attr_num(params, "c", 0.0)
    return (a * x * x + b * x + c,)


@register("_contrib_fft", aliases=("fft",))
def _fft(params, x):
    out = torch.fft.fft(x.to(torch.complex64), dim=-1)
    return (torch.stack([out.real, out.imag], dim=-1).reshape(
        x.shape[:-1] + (2 * x.shape[-1],)).to(torch.float32),)


@register("_contrib_ifft", aliases=("ifft",))
def _ifft(params, x):
    n = x.shape[-1] // 2
    comp = x.reshape(x.shape[:-1] + (n, 2)).to(torch.float32)
    out = torch.fft.ifft(torch.complex(comp[..., 0], comp[..., 1]), dim=-1)
    return ((out.real * n).to(torch.float32),)


@register("_contrib_count_sketch", aliases=("count_sketch",))
def _count_sketch(params, data, h, s):
    out_dim = int(_attr_num(params, "out_dim", 0))
    idx = h.to(torch.int64).reshape(-1)
    contrib = data * s.reshape(-1)[None, :]
    out = torch.zeros((data.shape[0], out_dim), dtype=data.dtype,
                      device=data.device)
    return (out.index_add(1, idx, contrib),)


def _center_to_corner(x):
    return torch.cat([x[..., :2] - x[..., 2:4] / 2,
                      x[..., :2] + x[..., 2:4] / 2], dim=-1)


@register("_contrib_box_iou", aliases=("box_iou",))
def _box_iou(params, lhs, rhs):
    if params.get("format", "corner") == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return (box_iou_xyxy(lhs, rhs),)


def greedy_nms_keep(boxes, scores, valid, class_id, thresh, topk, force):
    """Greedy NMS keep mask, in the input order, over (B, N, 4) boxes.

    The JAX package's function over a batch: a stable sort by descending
    score (invalid boxes last), ``topk > 0`` keeping only the first topk
    sorted candidates, the sweep (:func:`ops.nms_kernel.greedy_nms`, N1 on
    CUDA tensors; in f32) and the un-permute. Suppression stays within
    equal ``class_id`` unless ``force`` or ``class_id`` is None."""
    n = boxes.shape[-2]
    key = torch.where(valid, scores, torch.full((), float("-inf"),
                                                dtype=scores.dtype,
                                                device=scores.device))
    order = torch.sort(-key, dim=-1, stable=True).indices
    b = torch.gather(boxes.detach().to(torch.float32), 1,
                     order[..., None].expand(-1, -1, 4))
    keep0 = torch.gather(valid, 1, order)
    if topk > 0:
        keep0 = keep0 & (torch.arange(n, device=boxes.device) < topk)
    cid = None
    if not force and class_id is not None:
        cid = torch.gather(class_id.detach(), 1, order)
    keep_sorted = greedy_nms(b, keep0, cid, thresh)
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)


@register("_contrib_box_nms", aliases=("box_nms",))
def _box_nms(params, data):
    """Greedy NMS over (B, N, K>=6) [id, score, x1, y1, x2, y2, ...] rows
    (or one (N, K) image): rows sorted by descending score, suppressed and
    invalid rows -1."""
    thresh = _attr_num(params, "overlap_thresh", 0.5)
    vthresh = _attr_num(params, "valid_thresh", 0.0)
    topk = int(_attr_num(params, "topk", -1))
    coord = int(_attr_num(params, "coord_start", 2))
    score_i = int(_attr_num(params, "score_index", 1))
    id_i = int(_attr_num(params, "id_index", -1))
    force = _attr_bool(params, "force_suppress")
    x = data[None] if data.dim() == 2 else data
    scores = x[..., score_i]
    cid = x[..., id_i] if (not force and id_i >= 0) else None
    keep = greedy_nms_keep(x[..., coord:coord + 4], scores, scores > vthresh,
                           cid, thresh, topk, force)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    rows = torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))
    kept = torch.gather(keep, 1, order)
    out = torch.where(kept[..., None], rows,
                      torch.full((), -1.0, dtype=x.dtype, device=x.device))
    return (out[0] if data.dim() == 2 else out,)


@register("ROIPooling", aliases=("ROIPooling_v1",))
def _roi_pooling(params, data, rois):
    """Max pooling of each roi (R, 5) [batch_idx, x1, y1, x2, y2] (image
    coordinates) over a ``pooled_size`` grid of data (B, C, H, W); an
    empty cell gives 0. The gradient is split equally over equal maxima,
    as the JAX op's ``jnp.max`` does."""
    ph, pw = (int(v) for v in tuple_param(params, "pooled_size", ()))
    scale = _attr_num(params, "spatial_scale", 1.0)
    B, C, H, W = data.shape
    dev = data.device
    bi = rois[:, 0].to(torch.int64).clamp(0, B - 1)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * scale).to(torch.int64)
                      for k in range(1, 5))
    rh = torch.clamp(y2 - y1 + 1, min=1)[:, None]
    rw = torch.clamp(x2 - x1 + 1, min=1)[:, None]
    iy = torch.arange(ph, device=dev)
    ix = torch.arange(pw, device=dev)
    hs = y1[:, None] + torch.div(iy * rh, ph, rounding_mode="floor")
    he = y1[:, None] + torch.div((iy + 1) * rh + ph - 1, ph,
                                 rounding_mode="floor")
    ws = x1[:, None] + torch.div(ix * rw, pw, rounding_mode="floor")
    we = x1[:, None] + torch.div((ix + 1) * rw + pw - 1, pw,
                                 rounding_mode="floor")
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    mh = (ys >= hs[..., None]) & (ys < he[..., None])      # (R, ph, H)
    mw = (xs >= ws[..., None]) & (xs < we[..., None])      # (R, pw, W)
    mask = mh[:, :, None, :, None] & mw[:, None, :, None, :]
    img = data[bi]                                         # (R, C, H, W)
    masked = torch.where(mask[:, None], img[:, :, None, None],
                         torch.full((), float("-inf"), dtype=data.dtype,
                                    device=dev))
    m = torch.amax(masked, dim=(-2, -1))                   # (R, C, ph, pw)
    out = torch.where(torch.isfinite(m), m,
                      torch.zeros((), dtype=m.dtype, device=dev))
    return (out.to(data.dtype),)


@register("_contrib_flash_attention", aliases=("flash_attention",))
def _flash_attention_op(params, q, k, v):
    """Fused multi-head attention on [B, T, H, D] inputs: K4 on CUDA
    tensors, its plain version on the CPU, the dense recompute for the
    gradient. Attributes: ``causal`` (bool), ``scale`` (float, default
    1/sqrt(D); "None" from a graph's JSON means the default),
    ``block_q``/``block_k`` (the TPU kernel's tile sizes, accepted and
    not used)."""
    causal = _attr_bool(params, "causal")
    scale = params.get("scale")
    scale = None if scale in (None, "None") else float(scale)
    block_q = int(_attr_num(params, "block_q", 512))
    block_k = int(_attr_num(params, "block_k", 512))
    return (FlashAttention.apply(q, k, v, scale, causal, block_q, block_k),)
