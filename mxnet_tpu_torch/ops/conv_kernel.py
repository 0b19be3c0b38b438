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

The kernel has three routes, which :func:`_k5_route` picks from the shape
and dtype before the launch: ``wgmma``, the persistent TMA + wgmma kernel
of ``csrc/dgrad_wgmma.cuh`` (bf16, K and C multiples of 8: every ResNet
site); ``wmma`` (bf16 shapes TMA cannot address); ``f32`` (CUDA cores).
The C side refuses a plan its route is not built for, and the wrapper
raises; no route stands in for another.
``conv1x1_s2_dgrad.launches`` counts the calls that launched the kernel,
``launches_by_route`` the same calls by route.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import _build
from .launch_count import count

__all__ = ["conv1x1_s2_dgrad", "conv1x1_s2_dgrad_plain", "K5Plan",
           "conv1x1_s2_dgrad_plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"f32": 0, "wmma": 1, "wgmma": 2}
_lock = threading.Lock()
_sms = {}


class K5Plan(NamedTuple):
    """How one K5 call is launched (:func:`_k5_route`)."""
    route: str       # "wgmma", "wmma" or "f32"
    bn: int          # product columns (of C) a tile
    stages: int      # depth of the TMA ring (1: none)
    grid: int        # blocks of the launch
    row_tiles: int
    col_tiles: int
    smem: int        # dynamic shared memory a block, bytes (0: static only)


#: the wgmma route's ring depth by tile width (``k5::Layout<BN>``)
_WGMMA_STAGES = {128: 5, 256: 3}


def _wgmma_smem(bn):
    """``k5::Layout<bn>::kBytes``: the ring (a 128x64 dy box and bn/64
    64x64 w2 boxes a stage), the bf16 staging of a 128 x bn tile (rows
    padded by 16 bytes), the mbarriers, the tile count and 1024 bytes of
    alignment."""
    stages = _WGMMA_STAGES[bn]
    stage = 128 * 128 + (bn // 64) * 64 * 128
    return stages * stage + 128 * (bn + 8) * 2 + 16 * stages + 16 + 1024


def _wgmma_plan(row_tiles, c, bn, sms):
    """The ``wgmma`` plan of ``row_tiles`` 128-row tiles of C = ``c``
    columns, ``bn`` columns a tile, on a card of ``sms`` SMs."""
    cols = -(-c // bn)
    return K5Plan("wgmma", bn, _WGMMA_STAGES[bn], min(sms, row_tiles * cols),
                  row_tiles, cols, _wgmma_smem(bn))


def _k5_route(n, ho, wo, k, c, dtype, sms):
    """K5's plan for dy (n, ho, wo, k) and w2 (k, c) of ``dtype`` on a card
    of ``sms`` SMs, from the shape alone, before any launch.

    ``wgmma`` for bf16 with k and c multiples of 8 (TMA's 16-byte row
    strides): a persistent grid of at most ``sms`` blocks over tiles of 128
    rows by 128 or 256 columns. The wider tile unless the narrower one
    leaves the busiest block less work (ceil(tiles / sms) tiles of its
    width): at C = 1024 and M = 6272 (stage 4 at batch 128) 196 wide tiles
    are two waves on 132 SMs, 392 narrow ones three half-size waves.
    ``wmma`` for other bf16 shapes, ``f32`` for f32: one block a tile of
    128 (64 for f32) by 64."""
    m = n * ho * wo
    if dtype == torch.float32 or (dtype == torch.bfloat16
                                  and (k % 8 or c % 8 or k == 0)):
        route, bm = ("f32", 64) if dtype == torch.float32 else ("wmma", 128)
        rows, cols = -(-m // bm), -(-c // 64)
        return K5Plan(route, 64, 1, rows * cols, rows, cols, 0)
    if dtype != torch.bfloat16:
        raise MXNetError("conv1x1_s2_dgrad: the kernel takes f32 or bf16, "
                         "not %s" % dtype)
    wide, narrow = (_wgmma_plan(-(-m // 128), c, bn, sms) for bn in (256, 128))

    def load(plan):
        tiles = plan.row_tiles * plan.col_tiles
        return -(-tiles // sms) * plan.bn
    return narrow if load(narrow) < load(wide) else wide


def _k5_walk(plan):
    """The tiles each block of a ``wgmma`` plan computes, in its order, as
    ``dgrad_wgmma`` walks them: tile t is (t // col_tiles, t % col_tiles),
    so a row tile's column tiles are consecutive, and block b takes tiles
    b, b + grid, ...; [[(row tile, column tile), ...] for each block]."""
    tiles = plan.row_tiles * plan.col_tiles
    return [[divmod(t, plan.col_tiles) for t in range(b, tiles, plan.grid)]
            for b in range(plan.grid)]


def _device_sms(device):
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def conv1x1_s2_dgrad_plan(dy, w2):
    """The :class:`K5Plan` that K5 takes for these CUDA tensors."""
    n, ho, wo, k = dy.shape
    return _k5_route(n, ho, wo, k, w2.shape[1], dy.dtype,
                     _device_sms(dy.device))


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (a
    view into another tensor): TMA addresses 16-byte aligned rows only."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
            lib.conv1x1_s2_dgrad.argtypes = [vp] * 3 + [i] * 10 + [vp]
            lib.conv1x1_s2_dgrad.restype = i
            lib.conv1x1_s2_dgrad_error_name.argtypes = [i]
            lib.conv1x1_s2_dgrad_error_name.restype = ctypes.c_char_p
    return lib


def conv1x1_s2_dgrad(dy, w2, H, W):
    """Input gradient of a stride-2, pad-0 NHWC 1x1 conv (K5).

    dy: (N, Ho, Wo, K) cotangent; w2: (K, C); returns dx (N, H, W, C) in
    dy's dtype with dx[:, ::2, ::2] = dy @ w2 and zeros elsewhere.
    Requires H == 2*Ho and W == 2*Wo. CPU tensors take the plain version;
    CUDA tensors (f32 or bf16, one device) the kernel, by the route of
    :func:`conv1x1_s2_dgrad_plan`."""
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
        dx = torch.empty((n, H, W, c), dtype=dy.dtype, device=dy.device)
        if dx.numel() == 0:
            return dx
        plan = conv1x1_s2_dgrad_plan(dy, w2)
        dy_c, w2_c = _aligned(dy.contiguous()), _aligned(w2.contiguous())
        err = lib.conv1x1_s2_dgrad(
            dy_c.data_ptr(), w2_c.data_ptr(), dx.data_ptr(), n * ho * wo, k,
            c, wo, _DTYPES[dy.dtype], _ROUTES[plan.route], plan.bn,
            plan.stages, plan.grid, plan.smem,
            torch.cuda.current_stream(dy.device).cuda_stream)
    if err:
        raise MXNetError("conv1x1_s2_dgrad kernel launch failed: %s (%d)"
                         % (lib.conv1x1_s2_dgrad_error_name(err).decode(),
                            err))
    count(conv1x1_s2_dgrad, plan.route, flops=2 * n * ho * wo * k * c)
    return dx


#: calls that launched the CUDA kernel (the plain version does not count),
#: and the same calls by route (:func:`_k5_route`)
conv1x1_s2_dgrad.launches = 0
conv1x1_s2_dgrad.launches_by_route = {"wgmma": 0, "wmma": 0, "f32": 0}
