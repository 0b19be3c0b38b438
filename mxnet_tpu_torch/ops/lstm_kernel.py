"""The fused LSTM layer: hand-written CUDA kernels and their plain versions.

Three TPU kernels of `mxnet_tpu/ops/pallas_kernels.py` have a counterpart
here, with the same signatures and layouts (gate order i, f, g, o):

- ``fused_lstm`` (K1, inference) replaces ``fused_lstm`` / ``_lstm_kernel``
  and launches ``csrc/fused_lstm.cu``;
- ``fused_lstm_train`` (K2) replaces ``_lstm_fwd_train_kernel``: the
  forward that also keeps ``cseq`` and the activated gates;
- ``lstm_bwd_recurrence`` (K3) replaces ``_lstm_bwd_kernel``: the
  reverse-time backward that emits ``dgates``, ``dh0`` and ``dc0``.

K2 and K3 launch ``csrc/fused_lstm_train.cu``. K1 and K2 share the
recurrence of ``csrc/lstm_persistent.cuh``, launched by one of two routes
that :func:`_lstm_route` picks from the shape alone: ``persistent``, one
cooperative launch a layer with Wh resident in shared memory, or
``step``, one launch per time step where Wh's slice does not fit. K3 has
the same two routes, picked by :func:`_lstm_bwd_route`: ``persistent``
runs ``csrc/lstm_bwd_persistent.cuh``, one launch a layer; ``step`` runs
T + 1 launches. Each
wrapper runs its plain version (``*_plain``, a loop over time with the
same math, which is also the kernel's reference on the card) on a CPU
tensor, launches its kernel on a CUDA tensor, and raises on any other
device. ``<wrapper>.launches`` counts the calls that launched a kernel
(one call is one layer), and ``launches_by_route`` the same calls by
route; a call captured in a CUDA graph counts at each replay
(`launch_count.py`).

:class:`FusedLSTM` is the layer's ``torch.autograd.Function`` (the JAX
package's ``custom_vjp``): forward K2, backward K3 plus the four
sequence-wide products outside it (``dx``, ``dWx``, ``dWh``, ``db``).
K1 keeps no residuals and has no gradient: it refuses inputs that need
one. As in the JAX package, the input projection ``x @ wx + b`` of every
step is one matrix product outside the kernels (``torch.matmul``), and
the recurrence works in f32 and returns x's dtype.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import _build
from .launch_count import count

__all__ = ["fused_lstm", "fused_lstm_plain", "fused_lstm_train",
           "fused_lstm_train_plain", "lstm_bwd_recurrence",
           "lstm_bwd_recurrence_plain", "fused_lstm_backward",
           "fused_lstm_backward_plain", "FusedLSTM", "LSTMPlan", "lstm_plan",
           "lstm_bwd_plan"]


def _project(x, wx, b):
    """xp = x @ wx + b for all T steps at once, f32: (T, B, 4H)."""
    return torch.matmul(x.float(), wx.float()) + b.float()


def _activate(gates, hid):
    """Pre-activation gates (B, 4H) -> (i, f, g, o), activated."""
    return (torch.sigmoid(gates[:, :hid]),
            torch.sigmoid(gates[:, hid:2 * hid]),
            torch.tanh(gates[:, 2 * hid:3 * hid]),
            torch.sigmoid(gates[:, 3 * hid:]))


def fused_lstm_plain(x, h0, c0, wx, wh, b):
    """Single-layer LSTM over a full sequence, gate order i, f, g, o.

    x: [T, B, I]; h0/c0: [B, H]; wx: [I, 4H]; wh: [H, 4H]; b: [4H].
    Returns (h_seq [T,B,H], h_n, c_n) in x's dtype."""
    hseq, cseq, _ = fused_lstm_train_plain(x, h0, c0, wx, wh, b)
    return (hseq.to(x.dtype), hseq[-1].to(x.dtype), cseq[-1].to(x.dtype))


def fused_lstm_train_plain(x, h0, c0, wx, wh, b):
    """K2's function: the forward with its residuals, all f32.

    Returns (hseq [T,B,H], cseq [T,B,H], gates [T,B,4H]) with the
    post-activation gates i, f, g, o; h_n = hseq[-1], c_n = cseq[-1]."""
    hid = wh.shape[0]
    xp = _project(x, wx, b)
    whf = wh.float()
    h, c = h0.float(), c0.float()
    hs, cs, gs = [], [], []
    for t in range(x.shape[0]):
        i, f, g, o = _activate(xp[t] + torch.matmul(h, whf), hid)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        gs.append(torch.cat([i, f, g, o], dim=1))
    return torch.stack(hs), torch.stack(cs), torch.stack(gs)


def lstm_bwd_recurrence_plain(dhseq, dhn, dcn, gates, cseq, c0, wh):
    """K3's function: the reverse-time recurrence of the backward, f32.

    dhseq: [T,B,H]; dhn/dcn/c0: [B,H]; gates: [T,B,4H] activated;
    cseq: [T,B,H]; wh: [H,4H]. Returns (dgates [T,B,4H], dh0, dc0)."""
    hid = wh.shape[0]
    whT = wh.float().t()
    dh_carry, dc = dhn.float(), dcn.float()
    dgates = [None] * gates.shape[0]
    for t in range(gates.shape[0] - 1, -1, -1):
        dh = dhseq[t].float() + dh_carry
        i, f, g, o = torch.split(gates[t], hid, dim=1)
        c_prev = cseq[t - 1] if t > 0 else c0.float()
        tanh_c = torch.tanh(cseq[t])
        do = dh * tanh_c
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        dgates[t] = torch.cat([dc * g * i * (1.0 - i),
                               dc * c_prev * f * (1.0 - f),
                               dc * i * (1.0 - g * g),
                               do * o * (1.0 - o)], dim=1)
        dh_carry = torch.matmul(dgates[t], whT)
        dc = dc * f
    return torch.stack(dgates), dh_carry, dc


def _backward_products(dgates, x, h0, hseq, wx):
    """The four sequence-wide products outside K3 (`_lstm_vjp_bwd`
    :546-557): dx, dwx, dwh, db, f32."""
    hprev = torch.cat([h0.float()[None], hseq[:-1]], dim=0)
    dg2 = dgates.reshape(-1, dgates.shape[-1])
    dx = torch.matmul(dgates, wx.float().t())
    dwx = torch.matmul(x.float().reshape(-1, x.shape[-1]).t(), dg2)
    dwh = torch.matmul(hprev.reshape(-1, hprev.shape[-1]).t(), dg2)
    return dx, dwx, dwh, dg2.sum(0)


def fused_lstm_backward_plain(dhseq, dhn, dcn, x, h0, c0, wx, wh, hseq,
                              cseq, gates):
    """The layer's backward in plain PyTorch: K3's function plus the four
    products. Returns the gradients of (x, h0, c0, wx, wh, b), f32."""
    dgates, dh0, dc0 = lstm_bwd_recurrence_plain(dhseq, dhn, dcn, gates,
                                                 cseq, c0, wh)
    dx, dwx, dwh, db = _backward_products(dgates, x, h0, hseq, wx)
    return dx, dh0, dc0, dwx, dwh, db


def fused_lstm_backward(dhseq, dhn, dcn, x, h0, c0, wx, wh, hseq, cseq,
                        gates):
    """The layer's backward: K3 (`lstm_bwd_recurrence`) plus the four
    products. Returns the gradients of (x, h0, c0, wx, wh, b), f32."""
    dgates, dh0, dc0 = lstm_bwd_recurrence(dhseq, dhn, dcn, gates, cseq,
                                           c0, wh)
    dx, dwx, dwh, db = _backward_products(dgates, x, h0, hseq, wx)
    return dx, dh0, dc0, dwx, dwh, db


# ---------------------------------------------------------------------------
# ctypes wrappers of the kernels
# ---------------------------------------------------------------------------
_VP = ctypes.c_void_p
_INT = ctypes.c_int


def _library(name, signatures):
    """The loaded library ``csrc/<name>.cu`` with its functions typed."""
    lib = _build.library(name)
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = _INT
    err = getattr(lib, name + "_error_name")
    if err.argtypes is None:
        err.argtypes = [_INT]
        err.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, name, err):
    if err:
        raise MXNetError("%s kernel launch failed: %s (%d)" % (
            name, getattr(lib, name + "_error_name")(err).decode(), err))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(x, h0, c0, wx, wh, b):
    if x.dim() != 3:
        raise MXNetError("fused_lstm: x must be (T, B, I), got %s"
                         % (tuple(x.shape),))
    t, bs, inp = x.shape
    hid = wh.shape[0]
    want = {"h0": (bs, hid), "c0": (bs, hid), "wx": (inp, 4 * hid),
            "wh": (hid, 4 * hid), "b": (4 * hid,)}
    for name, arr in (("h0", h0), ("c0", c0), ("wx", wx), ("wh", wh),
                      ("b", b)):
        if tuple(arr.shape) != want[name]:
            raise MXNetError("fused_lstm: %s must be %s, got %s"
                             % (name, want[name], tuple(arr.shape)))
        if arr.device != x.device:
            raise MXNetError("fused_lstm: %s is on %s, x on %s"
                             % (name, arr.device, x.device))
    if t < 1 or bs < 1 or hid < 1:
        raise MXNetError("fused_lstm: empty shape T=%d B=%d H=%d"
                         % (t, bs, hid))


def _on_kernel_device(x, name):
    """True for a CUDA tensor, False for a CPU one; raises otherwise
    (``meta`` tensors of shape inference never reach a kernel)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise MXNetError("%s: no kernel for device %s" % (name, x.device))
    return True


def _f32(t):
    return t.float().contiguous()


# ---------------------------------------------------------------------------
# K1 and K2: the route and the launch
# ---------------------------------------------------------------------------
#: batch rows of a warp's work item in csrc/lstm_persistent.cuh, and the
#: most rows of h a block holds at once (8 such groups, one mbarrier each)
_ITEM_ROWS, _MAX_TILE_ROWS = 8, 64
#: the step route's block: 32 hidden units by 8 rows, 32 KB of shared memory
_STEP_UNITS, _STEP_ROWS, _STEP_SMEM = 32, 8, 32768


class LSTMPlan(NamedTuple):
    """How one layer's recurrence is launched (:func:`_lstm_route`)."""
    route: str   # "persistent": one cooperative launch; "step": T launches
    grid: int    # blocks of a launch
    units: int   # hidden units a block
    rows: int    # batch rows a block holds at once
    smem: int    # shared memory a block, bytes (dynamic for "persistent")


def _lstm_route(batch, hid, sms, smem_per_block):
    """The plan of one layer of batch ``batch`` and hidden size ``hid`` on a
    card of ``sms`` SMs whose blocks may opt in to ``smem_per_block`` bytes
    of shared memory, from the shape alone, before any launch.

    ``persistent``: at most ``sms`` blocks of ``ceil(H / sms)`` units each,
    every block resident at once; a block keeps its units' four gate
    columns of Wh (rows padded to ``Hp``, H rounded up to 4) in shared
    memory beside a tile of h: all B rows when they fit (64 at most),
    else the most that fit rounded down to a multiple of 8, walked in turn
    each step.
    ``step``, where not one such tile fits: one launch per step of blocks
    of 32 units by 8 rows."""
    hp = -(-hid // 4) * 4
    units = -(-hid // sms)
    w_bytes = 4 * 4 * units * hp
    rows = min(batch, _MAX_TILE_ROWS,
               max(0, smem_per_block - w_bytes) // (4 * hp))
    if rows < batch:
        rows -= rows % _ITEM_ROWS
    if rows > 0:
        return LSTMPlan("persistent", -(-hid // units), units, rows,
                        w_bytes + 4 * hp * rows)
    return LSTMPlan("step", -(-hid // _STEP_UNITS) * -(-batch // _STEP_ROWS),
                    _STEP_UNITS, _STEP_ROWS, _STEP_SMEM)


#: unit counts a block of K3's persistent kernel is built for
#: (``lstm_bwd_persistent<U>``, U = 1 .. this)
_BWD_MAX_UNITS = 9
#: K3's step route: blocks of 32 units by 8 rows, 8 KB of shared memory
_BWD_STEP_SMEM = 8192


def _lstm_bwd_route(batch, hid, sms, smem_per_block):
    """K3's plan for a layer of batch ``batch`` and hidden size ``hid`` on
    a card of ``sms`` SMs whose blocks may opt in to ``smem_per_block``
    bytes of shared memory, from the shape alone, before any launch.

    ``persistent``: ``ceil(H / units)`` blocks of ``units = ceil(H / sms)``
    hidden units, all resident at once. A block keeps the rows of Wh^T
    that multiply its own 4·units dgates columns in shared memory (every
    owner's units × 4·units, and 4 floats of padding for an even units);
    the slab of a tile, the partial products the other blocks wrote for
    its units (grid writers × 8 rows × units floats an 8-row group),
    which then holds the block's own staged partials (4 floats of
    padding an owner); and for each group its dgates (4·units × 8 and 4
    floats of padding) and the four partial sums of its carries (8 ×
    units each): all B rows when they fit, else the most 8-row groups
    that fit, walked in turn each step.
    ``step``, where not one group fits or units exceed
    ``_BWD_MAX_UNITS``: T + 1 launches of blocks of 32 units by 8 rows."""
    units = -(-hid // sms)
    grid = -(-hid // units)
    # the Wh slice, 4·units² floats an owner (4 more for an even units),
    # and the staged partials' padding, 4 floats an owner
    fixed = 4 * grid * (4 * units * units + (0 if units % 2 else 4) + 4)
    group_bytes = 32 * units * grid + 256 * units + 16
    groups = min(-(-batch // _ITEM_ROWS),
                 max(0, smem_per_block - fixed) // group_bytes)
    if units <= _BWD_MAX_UNITS and groups > 0:
        return LSTMPlan("persistent", grid, units,
                        min(batch, _ITEM_ROWS * groups),
                        fixed + groups * group_bytes)
    return LSTMPlan("step", -(-hid // _STEP_UNITS) * -(-batch // _STEP_ROWS),
                    _STEP_UNITS, _STEP_ROWS, _BWD_STEP_SMEM)


_FORWARD_ARGS = [_VP] * 8 + [_INT] * 8 + [_VP]
#: fused_lstm_backward: 10 pointers, T, B, H, Wh's two strides (64-bit),
#: the plan's five ints, the stream
_BACKWARD_ARGS = ([_VP] * 10 + [_INT] * 3 + [ctypes.c_longlong] * 2
                  + [_INT] * 5 + [_VP])
_limits = {}


def _forward_library(name):
    return _library(name, {name + "_forward": _FORWARD_ARGS,
                           name + "_limits": [ctypes.POINTER(_INT)] * 2})


def _device_limits(lib, name, device):
    """(SM count, opt-in shared memory a block) of a CUDA device."""
    if device.index not in _limits:
        sms, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            err = getattr(lib, name + "_limits")(ctypes.byref(sms),
                                                 ctypes.byref(smem))
        _raise_on(lib, name, err)
        _limits[device.index] = (sms.value, smem.value)
    return _limits[device.index]


def lstm_plan(batch, hid, device):
    """The :class:`LSTMPlan` that K1 and K2 take for a layer of this batch
    and hidden size on the CUDA ``device``."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = _forward_library("fused_lstm")
    return _lstm_route(batch, hid, *_device_limits(lib, "fused_lstm", device))


def lstm_bwd_plan(batch, hid, device):
    """The :class:`LSTMPlan` that K3 takes for a layer of this batch and
    hidden size on the CUDA ``device``."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = _forward_library("fused_lstm_train")
    return _lstm_bwd_route(batch, hid,
                           *_device_limits(lib, "fused_lstm_train", device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(wrapper, name, x, h0, c0, wx, wh, b, residuals):
    """One layer's recurrence by the kernel of ``csrc/<name>.cu``:
    (hseq (T,B,H), c_T (B,H) or cseq (T,B,H), gates (T,B,4H) or None),
    f32. A refused plan or launch raises; it never takes another route."""
    _check(x, h0, c0, wx, wh, b)
    t, bs, _ = x.shape
    hid = wh.shape[0]
    lib = _forward_library(name)
    plan = _lstm_route(bs, hid, *_device_limits(lib, name, x.device))
    persistent = plan.route == "persistent"
    f32 = {"dtype": torch.float32, "device": x.device}
    with torch.cuda.device(x.device):
        xp = _project(x, wx, b).contiguous()
        whf, h0f, c0f = _f32(wh), _f32(h0), _f32(c0)
        hseq = torch.empty((t, bs, hid), **f32)
        cout = torch.empty((t, bs, hid) if residuals else (bs, hid), **f32)
        gates = torch.empty((t, bs, 4 * hid), **f32) if residuals else None
        # h_t's exchange buffer between blocks, rows padded to Hp
        hx = (torch.empty((2, bs, -(-hid // 4) * 4), **f32) if persistent
              else None)
        err = getattr(lib, name + "_forward")(
            xp.data_ptr(), whf.data_ptr(), h0f.data_ptr(), c0f.data_ptr(),
            hseq.data_ptr(), cout.data_ptr(), _ptr(gates), _ptr(hx), t, bs,
            hid, int(persistent), plan.grid, plan.units, plan.rows,
            plan.smem, _stream(x))
    _raise_on(lib, name, err)
    # the recurrence's products, h_{t-1} @ Wh at every step
    count(wrapper, plan.route, flops=8 * t * bs * hid * hid)
    return hseq, cout, gates


def fused_lstm(x, h0, c0, wx, wh, b):
    """Single-layer LSTM over a full sequence (cuDNN-RNN analog), K1.

    x: [T, B, I]; h0/c0: [B, H]; wx: [I, 4H]; wh: [H, 4H]; b: [4H].
    Gate order i, f, g, o. Returns (h_seq [T,B,H], h_n, c_n) in x's
    dtype. CPU tensors take the plain version; CUDA tensors the kernel.
    It computes no gradient: inputs that need one go through
    :class:`FusedLSTM` instead, and are refused here."""
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, h0, c0, wx, wh, b)):
        raise MXNetError("fused_lstm is the inference kernel and keeps no "
                         "residuals: inputs that need a gradient go through "
                         "FusedLSTM")
    if not _on_kernel_device(x, "fused_lstm"):
        return fused_lstm_plain(x, h0, c0, wx, wh, b)
    hseq, c, _ = _forward(fused_lstm, "fused_lstm", x, h0, c0, wx, wh, b,
                          residuals=False)
    return (hseq.to(x.dtype), hseq[-1].to(x.dtype), c.to(x.dtype))


def fused_lstm_train(x, h0, c0, wx, wh, b):
    """K2: the forward with its residuals, f32.

    Same inputs as :func:`fused_lstm`. Returns (hseq [T,B,H],
    cseq [T,B,H], gates [T,B,4H] post-activation). CPU tensors take
    :func:`fused_lstm_train_plain`; CUDA tensors the kernel."""
    if not _on_kernel_device(x, "fused_lstm_train"):
        return fused_lstm_train_plain(x, h0, c0, wx, wh, b)
    return _forward(fused_lstm_train, "fused_lstm_train", x, h0, c0, wx, wh,
                    b, residuals=True)


def lstm_bwd_recurrence(dhseq, dhn, dcn, gates, cseq, c0, wh):
    """K3: the reverse-time recurrence of the backward, f32.

    Same arguments as :func:`lstm_bwd_recurrence_plain`. Returns
    (dgates [T,B,4H], dh0, dc0). CPU tensors take the plain version;
    CUDA tensors the kernel, by the route of :func:`_lstm_bwd_route`: one
    launch a call on ``persistent``, T + 1 on ``step``. A refused plan or
    launch raises; it never takes another route."""
    if not _on_kernel_device(gates, "lstm_bwd_recurrence"):
        return lstm_bwd_recurrence_plain(dhseq, dhn, dcn, gates, cseq, c0,
                                         wh)
    t, bs, g4 = gates.shape
    hid = wh.shape[0]
    want = {"dhseq": (t, bs, hid), "dhn": (bs, hid), "dcn": (bs, hid),
            "gates": (t, bs, 4 * hid), "cseq": (t, bs, hid),
            "c0": (bs, hid), "wh": (hid, 4 * hid)}
    for name, arr in zip(want, (dhseq, dhn, dcn, gates, cseq, c0, wh)):
        if tuple(arr.shape) != want[name] or arr.device != gates.device:
            raise MXNetError("lstm_bwd_recurrence: %s must be %s on %s, got "
                             "%s on %s" % (name, want[name], gates.device,
                                           tuple(arr.shape), arr.device))
    lib = _library("fused_lstm_train", {
        "fused_lstm_backward": _BACKWARD_ARGS,
        "fused_lstm_train_limits": [ctypes.POINTER(_INT)] * 2})
    plan = _lstm_bwd_route(bs, hid, *_device_limits(lib, "fused_lstm_train",
                                                    gates.device))
    persistent = plan.route == "persistent"
    f32 = {"dtype": torch.float32, "device": gates.device}
    with torch.cuda.device(gates.device):
        ins = [_f32(a) for a in (dhseq, dhn, gates, cseq, c0)]
        if persistent:
            # read through its strides: neither layout of Wh is copied
            w = wh.float()
            strides = w.stride()
            # partial products between blocks: (2, owner, writer, 8-row
            # group, 8 rows, units)
            xbuf = torch.empty((2, plan.grid, -(-bs // _ITEM_ROWS) * plan.grid
                                * _ITEM_ROWS * plan.units), **f32)
        else:
            w, strides, xbuf = _f32(wh.t()), (0, 0), None
        # the kernel owns dc in place: start it from a copy of dc_n
        dc = torch.empty((bs, hid), **f32)
        dc.copy_(dcn)
        dgates = torch.empty((t, bs, g4), **f32)
        dh0 = torch.empty_like(dc)
        err = lib.fused_lstm_backward(
            *[a.data_ptr() for a in ins], w.data_ptr(), dc.data_ptr(),
            dgates.data_ptr(), dh0.data_ptr(), _ptr(xbuf), t, bs, hid,
            *strides, int(persistent), plan.grid, plan.units, plan.rows,
            plan.smem, _stream(gates))
    _raise_on(lib, "fused_lstm_train", err)
    # dgates_t @ Wh^T at every step
    count(lstm_bwd_recurrence, plan.route, flops=8 * t * bs * hid * hid)
    return dgates, dh0, dc


#: calls that launched a CUDA kernel (the plain versions do not count)
fused_lstm.launches = 0
fused_lstm_train.launches = 0
lstm_bwd_recurrence.launches = 0
#: calls by route (:func:`_lstm_route`; K3: :func:`_lstm_bwd_route`)
fused_lstm.launches_by_route = {"persistent": 0, "step": 0}
fused_lstm_train.launches_by_route = {"persistent": 0, "step": 0}
lstm_bwd_recurrence.launches_by_route = {"persistent": 0, "step": 0}


class FusedLSTM(torch.autograd.Function):
    """One LSTM layer with its gradient: K2 forward, K3 backward.

    ``FusedLSTM.apply(x, h0, c0, wx, wh, b)`` takes and returns what
    :func:`fused_lstm` does, (h_seq, h_n, c_n) in x's dtype, and
    differentiates all six inputs, as the JAX package's ``fused_lstm``
    ``custom_vjp`` (`pallas_kernels.py:434-560`). The residuals are the
    f32 ``hseq``, ``cseq`` and activated ``gates`` of K2."""

    @staticmethod
    def forward(ctx, x, h0, c0, wx, wh, b):
        hseq, cseq, gates = fused_lstm_train(x, h0, c0, wx, wh, b)
        ctx.save_for_backward(x, h0, c0, wx, wh, b, hseq, cseq, gates)
        # h_n and c_n are copies: outputs must not be views of each other
        return (hseq.to(x.dtype), hseq[-1].to(x.dtype, copy=True),
                cseq[-1].to(x.dtype, copy=True))

    @staticmethod
    def backward(ctx, dhseq, dhn, dcn):
        x, h0, c0, wx, wh, b, hseq, cseq, gates = ctx.saved_tensors
        grads = fused_lstm_backward(dhseq, dhn, dcn, x, h0, c0, wx, wh, hseq,
                                    cseq, gates)
        return tuple(g.to(r.dtype)
                     for g, r in zip(grads, (x, h0, c0, wx, wh, b)))
