"""Contributed operators (the subset the port's slices use).

Counterpart of `mxnet_tpu/ops/contrib_ops.py`: ``_contrib_flash_attention``
(alias ``flash_attention``), reached as ``nd.contrib.flash_attention`` and
``sym.contrib.flash_attention``.
"""
from __future__ import annotations

from .attention_kernel import FlashAttention
from .nn import _attr_bool, _attr_num
from .registry import register


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
