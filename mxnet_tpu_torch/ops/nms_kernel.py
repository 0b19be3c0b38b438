"""Greedy NMS over score-sorted boxes: N1 and its plain version.

N1 (``csrc/greedy_nms.cu``) replaces no TPU kernel: it is the counterpart
of the ``lax.fori_loop`` of `mxnet_tpu/ops/contrib_ops.py::greedy_nms_keep`,
one compiled XLA loop there and a few launches a candidate if run eagerly
here. :func:`greedy_nms` takes boxes (B, N, 4) already in descending score
order, ``valid`` (B, N) bool and optional class ids (B, N), and returns the
keep mask (B, N) bool in that order: row i suppresses every later j with
IoU(i, j) > ``thresh`` (within its class unless class ids are None) only if
i is still kept. On CUDA tensors it launches N1, on CPU tensors it runs
:func:`greedy_nms_plain`, on ``meta`` tensors (shape inference) it returns
an empty mask, and it raises on any other device. The sort, top-k and
un-permute around it stay in PyTorch (`ops/contrib_ops.py`).
``greedy_nms.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from . import _build
from .launch_count import count

__all__ = ["greedy_nms", "greedy_nms_plain", "box_iou_xyxy", "MAX_BOXES"]

#: boxes an image N1 takes (its removed-bitmask lives in shared memory)
MAX_BOXES = 32768
_lock = threading.Lock()


def box_iou_xyxy(a, b):
    """IoU of two corner-format box sets: a (..., N, 4), b (..., M, 4) ->
    (..., N, M), with the operations of the JAX package's
    ``box_iou_xyxy`` in its order (N1 repeats them)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def greedy_nms_plain(boxes, valid, class_id, thresh):
    """The plain version: the JAX function's loop over the sorted rows,
    vectorised over the batch, on the full (B, N, N) IoU matrix."""
    n = boxes.shape[-2]
    ious = box_iou_xyxy(boxes, boxes)
    if class_id is not None:
        same = class_id[..., :, None] == class_id[..., None, :]
        ious = torch.where(same, ious, torch.zeros((), dtype=ious.dtype,
                                                   device=ious.device))
    over = ious > thresh
    later = torch.arange(n, device=boxes.device)
    keep = valid.clone()
    for i in range(n):
        sup = over[:, i] & (later > i) & keep[:, i:i + 1]
        keep &= ~sup
    return keep


def _library():
    lib = _build.library("greedy_nms")
    with _lock:
        if lib.greedy_nms.argtypes is None:
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.greedy_nms.argtypes = [vp, vp, vp, i, i, ctypes.c_float,
                                       vp, vp, vp]
            lib.greedy_nms.restype = i
            lib.greedy_nms_error_name.argtypes = [i]
            lib.greedy_nms_error_name.restype = ctypes.c_char_p
    return lib


def greedy_nms(boxes, valid, class_id, thresh):
    """Keep mask (B, N) bool of score-sorted ``boxes`` (B, N, 4): N1 on
    CUDA tensors, the plain version on CPU tensors (see the module
    docstring). ``class_id`` (B, N) or None; ``thresh`` a float."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise MXNetError("greedy_nms: boxes must be (B, N, 4), got %s"
                         % (tuple(boxes.shape),))
    B, n = boxes.shape[0], boxes.shape[1]
    dev = boxes.device
    if dev.type == "meta":
        return torch.empty((B, n), dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return greedy_nms_plain(boxes, valid, class_id, thresh)
    if dev.type != "cuda":
        raise MXNetError("greedy_nms: no kernel for device %s" % dev)
    if boxes.dtype != torch.float32:
        raise MXNetError("greedy_nms: the kernel takes f32 boxes, got %s"
                         % boxes.dtype)
    if n > MAX_BOXES:
        raise MXNetError("greedy_nms: the kernel takes at most %d boxes an "
                         "image, got %d" % (MAX_BOXES, n))
    if B == 0 or n == 0:
        return torch.zeros((B, n), dtype=torch.bool, device=dev)
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    valid = valid.to(torch.bool).contiguous()
    cls = None if class_id is None else \
        class_id.to(torch.float32).contiguous()
    for t in (valid, cls):
        if t is not None and (t.device != dev or tuple(t.shape) != (B, n)):
            raise MXNetError("greedy_nms: valid and class ids must be (B, N) "
                             "on %s" % dev)
    words = (n + 63) // 64
    mask = torch.empty((B, n, words), dtype=torch.int64, device=dev)
    keep = torch.empty((B, n), dtype=torch.bool, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = lib.greedy_nms(boxes.data_ptr(),
                             None if cls is None else cls.data_ptr(),
                             valid.data_ptr(), B, n, float(thresh),
                             mask.data_ptr(), keep.data_ptr(),
                             stream.cuda_stream)
    if err:
        raise MXNetError("greedy_nms kernel launch failed: %s (%d)"
                         % (lib.greedy_nms_error_name(err).decode(), err))
    count(greedy_nms)
    return keep


#: calls that launched the CUDA kernel (the plain version does not count)
greedy_nms.launches = 0
