"""The strided 1x1 convolution's input gradient: K5 and its plain version.

Counterpart of `mxnet_tpu/ops/conv_kernels.py`. ``conv1x1_s2_dgrad``
replaces the TPU kernel ``conv1x1_s2_dgrad`` (``_kern``) with the same
signature and layouts: ``dy (N, Ho, Wo, K)`` and ``w2 (K, C)`` (the OHWI
weight of the 1x1 conv, reshaped) give ``dx (N, 2Ho, 2Wo, C)`` with
``dx[:, ::2, ::2] = dy @ w2`` and zeros elsewhere. On a CUDA tensor it
launches ``csrc/conv1x1_s2_dgrad.cu``, which does the product itself (f32
accumulation) and writes every element of ``dx`` once, zeros included; on
a CPU tensor it runs :func:`conv1x1_s2_dgrad_plain`, which is also the
kernel's reference on the card. It raises on any other device, and on a
CUDA tensor it cannot launch on (a dtype other than f32 or bf16).
``conv1x1_s2_dgrad.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from . import _build

__all__ = ["conv1x1_s2_dgrad", "conv1x1_s2_dgrad_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lock = threading.Lock()


def _check_shapes(dy, w2, H, W):
    if dy.dim() != 4 or w2.dim() != 2 or w2.shape[0] != dy.shape[3]:
        raise MXNetError("conv1x1_s2_dgrad: dy must be (N, Ho, Wo, K) and w2 "
                         "(K, C); got %s and %s"
                         % (tuple(dy.shape), tuple(w2.shape)))
    _, ho, wo, _ = dy.shape
    if H != 2 * ho or W != 2 * wo:
        raise MXNetError("conv1x1_s2_dgrad needs H==2*Ho, W==2*Wo; got "
                         "H=%d Ho=%d W=%d Wo=%d" % (H, ho, W, wo))


def conv1x1_s2_dgrad_plain(dy, w2, H, W):
    """K5's function in plain PyTorch: the product in f32, stored in dy's
    dtype at the even rows and columns of a zero ``dx``."""
    _check_shapes(dy, w2, H, W)
    n, _, _, _ = dy.shape
    dx = torch.zeros((n, H, W, w2.shape[1]), dtype=dy.dtype,
                     device=dy.device)
    dx[:, ::2, ::2] = torch.matmul(dy.float(), w2.float()).to(dy.dtype)
    return dx


def _library():
    lib = _build.library("conv1x1_s2_dgrad")
    with _lock:
        if lib.conv1x1_s2_dgrad.argtypes is None:
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.conv1x1_s2_dgrad.argtypes = [vp] * 3 + [i] * 6 + [vp]
            lib.conv1x1_s2_dgrad.restype = i
            lib.conv1x1_s2_dgrad_error_name.argtypes = [i]
            lib.conv1x1_s2_dgrad_error_name.restype = ctypes.c_char_p
    return lib


def conv1x1_s2_dgrad(dy, w2, H, W):
    """Input gradient of a stride-2, pad-0 NHWC 1x1 conv (K5).

    dy: (N, Ho, Wo, K) cotangent; w2: (K, C); returns dx (N, H, W, C) in
    dy's dtype with dx[:, ::2, ::2] = dy @ w2 and zeros elsewhere.
    Requires H == 2*Ho and W == 2*Wo. CPU tensors take the plain version;
    CUDA tensors (f32 or bf16, one device) the kernel."""
    if dy.device.type == "cpu":
        return conv1x1_s2_dgrad_plain(dy, w2, H, W)
    if dy.device.type != "cuda":
        raise MXNetError("conv1x1_s2_dgrad: no kernel for device %s"
                         % dy.device)
    _check_shapes(dy, w2, H, W)
    if dy.dtype not in _DTYPES or w2.dtype != dy.dtype:
        raise MXNetError("conv1x1_s2_dgrad: the kernel takes f32 or bf16 "
                         "dy and w2 of one dtype; got %s and %s"
                         % (dy.dtype, w2.dtype))
    if w2.device != dy.device:
        raise MXNetError("conv1x1_s2_dgrad: w2 is on %s, dy on %s"
                         % (w2.device, dy.device))
    n, ho, wo, k = dy.shape
    c = w2.shape[1]
    lib = _library()
    with torch.cuda.device(dy.device):
        dy_c, w2_c = dy.contiguous(), w2.contiguous()
        dx = torch.empty((n, H, W, c), dtype=dy.dtype, device=dy.device)
        if dx.numel() == 0:
            return dx
        err = lib.conv1x1_s2_dgrad(
            dy_c.data_ptr(), w2_c.data_ptr(), dx.data_ptr(), n * ho * wo, k,
            c, ho, wo, _DTYPES[dy.dtype],
            torch.cuda.current_stream(dy.device).cuda_stream)
    if err:
        raise MXNetError("conv1x1_s2_dgrad kernel launch failed: %s (%d)"
                         % (lib.conv1x1_s2_dgrad_error_name(err).decode(),
                            err))
    with _lock:
        conv1x1_s2_dgrad.launches += 1
    return dx


#: calls that launched the CUDA kernel (the plain version does not count)
conv1x1_s2_dgrad.launches = 0
