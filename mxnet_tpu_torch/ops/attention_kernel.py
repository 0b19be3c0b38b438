"""Streaming-softmax attention: the hand-written CUDA kernel K4 and its
plain versions.

Counterpart of the attention half of `mxnet_tpu/ops/pallas_kernels.py`
(``flash_attention``, ``_flash_fwd_kernel``, ``_dense_attention``), with
the same layout: q ``[B, Tq, H, D]``, k and v ``[B, Tk, H, D]``, output
``[B, Tq, H, D]`` in q's dtype, arithmetic in f32, scale ``1/sqrt(D)``
unless given. The causal mask is ``qpos >= kpos`` on absolute positions,
so it is aligned at the top left when ``Tq != Tk``.

``flash_attention`` runs :func:`flash_attention_plain` on a CPU tensor,
returns an empty tensor of the output's shape for a ``meta`` tensor (the
port's shape inference), launches ``csrc/flash_attention.cu`` on a CUDA
tensor (f32 or bf16, ``D <= 256``: bf16 up to 128 on the TMA + ``wgmma``
kernel, above it and f32 on a CUDA-core kernel), and raises on anything
else.
``flash_attention.launches`` counts the calls that launched the kernel.
The bf16 kernel reads q, k and v through TMA maps, which need a head dim
that is a multiple of 8 and 16-byte aligned tensors: :func:`tma_operands`
pads and copies the inputs for it, and the output is sliced back.

:class:`FlashAttention` is the ``torch.autograd.Function`` (the JAX
package's ``custom_vjp``): the forward is ``flash_attention``, the
backward recomputes the dense attention (:func:`dense_attention_plain`)
in PyTorch ops and differentiates it, as the JAX package does outside
any Pallas kernel; there is no backward kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from . import _build
from .launch_count import count

__all__ = ["flash_attention", "flash_attention_plain",
           "dense_attention_plain", "tma_operands", "FlashAttention"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
_lock = threading.Lock()


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise MXNetError("flash_attention: q must be [B, Tq, H, D] and k, v "
                         "[B, Tk, H, D]; got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))


def _scale(q, scale):
    return 1.0 / q.shape[-1] ** 0.5 if scale is None else float(scale)


def flash_attention_plain(q, k, v, scale=None, causal=False, q_start=0):
    """K4's function in plain PyTorch: q, k, v cast to f32, scaled scores
    masked to -1e30 where (causal) ``qpos < kpos``, softmax, the product
    with v in f32, cast to q's dtype (the TPU kernel's ``kpos < Tk`` mask
    covers its padding, which this version has none of). ``q_start`` is the
    absolute position of q's first row, so a slice of the query rows
    gives the same rows as the whole."""
    _check_shapes(q, k, v)
    tq, tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * _scale(q, scale)
    if causal:
        qpos = torch.arange(q_start, q_start + tq, device=q.device)
        mask = qpos[:, None] >= torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def dense_attention_plain(q, k, v, scale=None, causal=False):
    """The JAX package's ``_dense_attention`` (the backward's math): f32
    scores, the causal mask at -1e30, softmax in f32, p cast to q's dtype
    before the product with v (in the inputs' dtype)."""
    _check_shapes(q, k, v)
    tq, tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * _scale(q, scale)
    if causal:
        mask = torch.arange(tq, device=q.device)[:, None] \
            >= torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def tma_operands(q, k, v):
    """q, k, v as the bf16 kernel's TMA maps can address them: contiguous,
    the head dim zero-padded to a multiple of 8 (a token's stride a
    multiple of 16 bytes), each base 16-byte aligned (an unaligned one is
    copied). Returns the three tensors; where nothing needs to change they
    are the inputs themselves. Zero columns add nothing to q.k and give
    zero output columns, so the first D output columns are the function of
    the original inputs at the original scale."""
    pad = -q.shape[-1] % 8
    out = []
    for t in (q, k, v):
        t = t.contiguous()
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        elif t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _library():
    lib = _build.library("flash_attention")
    with _lock:
        if lib.flash_attention_fwd.argtypes is None:
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_attention_fwd.argtypes = ([vp] * 4 + [i] * 5
                                                + [ctypes.c_float, i, i, vp])
            lib.flash_attention_fwd.restype = i
            lib.flash_attention_error_name.argtypes = [i]
            lib.flash_attention_error_name.restype = ctypes.c_char_p
            lib.flash_attention_bf16_smem.argtypes = [i]
            lib.flash_attention_bf16_smem.restype = i
    return lib


def flash_attention(q, k, v, scale=None, causal=False, block_q=512,
                    block_k=512):
    """Fused attention forward on [B, T, H, D] (K4).

    ``block_q`` and ``block_k`` are the TPU kernel's tile sizes: they are
    accepted for the same signature and change nothing here (the CUDA
    kernel picks its own tiles). CPU tensors take the plain version;
    CUDA tensors (f32 or bf16, one dtype, one device, ``D <= 256``) the
    kernel."""
    del block_q, block_k
    if q.device.type == "meta":
        _check_shapes(q, k, v)
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise MXNetError("flash_attention: no kernel for device %s"
                         % q.device)
    _check_shapes(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash_attention: the kernel takes f32 or bf16 q, "
                         "k, v of one dtype; got %s, %s, %s"
                         % (q.dtype, k.dtype, v.dtype))
    if k.device != q.device or v.device != q.device:
        raise MXNetError("flash_attention: q is on %s, k on %s, v on %s"
                         % (q.device, k.device, v.device))
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d > MAX_HEAD_DIM:
        raise MXNetError("flash_attention: the kernel takes head dims up to "
                         "%d; got %d" % (MAX_HEAD_DIM, d))
    lib = _library()
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            q_c, k_c, v_c = tma_operands(q, k, v)
        else:
            q_c, k_c, v_c = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty_like(q_c)
        if out.numel() == 0:
            return out[..., :d]
        if tk == 0:
            raise MXNetError("flash_attention: no keys (Tk = 0)")
        err = lib.flash_attention_fwd(
            q_c.data_ptr(), k_c.data_ptr(), v_c.data_ptr(), out.data_ptr(),
            b, tq, tk, h, q_c.shape[-1], _scale(q, scale),
            int(bool(causal)), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise MXNetError("flash_attention kernel launch failed: %s (%d)"
                         % (lib.flash_attention_error_name(err).decode(),
                            err))
    # q @ k^T and p @ v; a causal mask skips half of both
    flops = 4 * b * h * tq * tk * d
    count(flash_attention, flops=flops // 2 if causal else flops)
    return out if out.shape[-1] == d else out[..., :d].contiguous()


#: calls that launched the CUDA kernel (the plain version does not count)
flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the JAX package's gradient: the backward
    recomputes :func:`dense_attention_plain` from the saved q, k, v and
    differentiates it (O(T^2) memory in the backward only)."""

    @staticmethod
    def forward(ctx, q, k, v, scale=None, causal=False, block_q=512,
                block_k=512):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.causal = scale, causal
        return flash_attention(q, k, v, scale, causal, block_q, block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = dense_attention_plain(q, k, v, ctx.scale, ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None
