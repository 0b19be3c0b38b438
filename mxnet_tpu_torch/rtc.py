"""Runtime compilation of CUDA kernels: ``mx.rtc``.

Counterpart of `mxnet_tpu/rtc.py`, whose user-supplied kernel language is
Pallas. On the card it is CUDA C++ again, so this module is the
reference's own API (`python/mxnet/rtc.py`, `src/common/rtc.cc`):
``CudaModule(source, options, exports)`` compiles the source with NVRTC
for the current device (``sm_90a`` on Hopper), ``get_kernel(name,
signature)`` finds a kernel in it, and ``Kernel.launch(args, ctx,
grid_dims, block_dims, shared_mem)`` launches it on PyTorch's current
stream through ``libcuda`` (``cuLaunchKernel``), in the context PyTorch
made current. Launches are asynchronous, as in the reference: outputs
are NDArrays the caller passes and the kernel writes in place.
``out_shapes``, as the JAX package's ``Kernel.launch`` takes it, also
allocates outputs on ``ctx``, passes them after ``args`` and returns
them.

NVRTC (``libnvrtc``, from the CUDA toolkit: ``$CUDA_HOME/lib64``,
``/usr/local/cuda/lib64``) and ``libcuda.so.1`` are loaded with
``ctypes`` at first use. Without them, or without a CUDA device, this
module raises; it has no CPU mode. The JAX package's
``PallasModule`` (Pallas source) has no counterpart here.

Example::

    mod = mx.rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float* x, const float* y,
                                    float* out, int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) out[i] = 2.0f * x[i] + y[i];
    }''')
    k = mod.get_kernel("axpy", "const float *x, const float *y, "
                               "float *out, int n")
    k.launch((x, y, out, n), mx.gpu(0), (n // 256 + 1, 1, 1),
             (256, 1, 1))
"""
from __future__ import annotations

import ctypes
import os
import re
import threading
from pathlib import Path

import numpy as np
import torch

from .base import MXNetError
from .context import Context
from .ndarray.ndarray import NDArray, zeros
from .ops.launch_count import count

__all__ = ["CudaModule", "Kernel"]

# argument types of a kernel signature (the reference's
# _DTYPE_CPP_TO_NP, with bf16 added)
_CPP_TYPES = {
    "float": torch.float32, "double": torch.float64,
    "__half": torch.float16, "__nv_bfloat16": torch.bfloat16,
    "uint8_t": torch.uint8, "int": torch.int32, "int32_t": torch.int32,
    "int8_t": torch.int8, "char": torch.int8, "int64_t": torch.int64,
}
_SCALARS = {
    torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
    torch.float16: ctypes.c_uint16, torch.bfloat16: ctypes.c_uint16,
    torch.uint8: ctypes.c_uint8, torch.int32: ctypes.c_int32,
    torch.int8: ctypes.c_int8, torch.int64: ctypes.c_int64,
}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")
_MAX_STATIC_SMEM = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_lock = threading.Lock()
_libs = {}


def parse_signature(signature):
    """The reference's signature language, ``"const float *x, float *y,
    int n"``: [(is_pointer, torch dtype)] per argument. Raises ValueError
    for a malformed argument and TypeError for a type it has no mapping
    for."""
    out = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        match = _ARG.match(arg)
        if not match or match.group(2) == "const":
            raise ValueError('Invalid function prototype "%s". Must be in '
                             'the form of "(const) type (*) (name)"' % arg)
        if match.group(2) not in _CPP_TYPES:
            raise TypeError("Unsupported kernel argument type %s. Supported "
                            "types are: %s." % (arg, ",".join(_CPP_TYPES)))
        out.append((bool(match.group(3)), _CPP_TYPES[match.group(2)]))
    return out


def _toolkit_dirs():
    home = os.environ.get("CUDA_HOME")
    dirs = [Path(home) / "lib64"] if home else []
    return dirs + [Path("/usr/local/cuda/lib64")]


def _nvrtc(dirs=None):
    """``libnvrtc`` of the CUDA toolkit, loaded once."""
    with _lock:
        if "nvrtc" in _libs:
            return _libs["nvrtc"]
        dirs = list(dirs) if dirs is not None else _toolkit_dirs()
        for d in dirs:
            found = sorted(d.glob("libnvrtc.so*")) if d.is_dir() else []
            found = [p for p in found if "builtins" not in p.name]
            if found:
                lib = ctypes.CDLL(str(found[0]))
                _declare_nvrtc(lib)
                _libs["nvrtc"] = lib
                return lib
    raise MXNetError("rtc: NVRTC (libnvrtc.so) not found in %s; it comes "
                     "with the CUDA toolkit (set CUDA_HOME)"
                     % ", ".join(str(d) for d in dirs))


def _declare_nvrtc(lib):
    vp, sz, cp = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
    pp = ctypes.POINTER(ctypes.c_char_p)
    sig = {
        "nvrtcCreateProgram": [ctypes.POINTER(vp), cp, cp, ctypes.c_int,
                               pp, pp],
        "nvrtcAddNameExpression": [vp, cp],
        "nvrtcCompileProgram": [vp, ctypes.c_int, pp],
        "nvrtcGetProgramLogSize": [vp, ctypes.POINTER(sz)],
        "nvrtcGetProgramLog": [vp, ctypes.c_char_p],
        "nvrtcGetCUBINSize": [vp, ctypes.POINTER(sz)],
        "nvrtcGetCUBIN": [vp, ctypes.c_char_p],
        "nvrtcGetLoweredName": [vp, cp, pp],
        "nvrtcDestroyProgram": [ctypes.POINTER(vp)],
    }
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p


def _libcuda():
    """``libcuda.so.1`` (``cuInit``, modules, launches), loaded and
    initialised once."""
    with _lock:
        if "cuda" in _libs:
            return _libs["cuda"]
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as exc:
            raise MXNetError("rtc: libcuda.so.1 cannot be loaded: %s"
                             % exc) from None
        vp, u = ctypes.c_void_p, ctypes.c_uint
        sig = {
            "cuInit": [u],
            "cuCtxGetCurrent": [ctypes.POINTER(vp)],
            "cuModuleLoadData": [ctypes.POINTER(vp), vp],
            "cuModuleGetFunction": [ctypes.POINTER(vp), vp, ctypes.c_char_p],
            "cuFuncSetAttribute": [vp, ctypes.c_int, ctypes.c_int],
            "cuLaunchKernel": [vp, u, u, u, u, u, u, u, vp,
                               ctypes.POINTER(vp), ctypes.POINTER(vp)],
            "cuGetErrorName": [ctypes.c_int,
                               ctypes.POINTER(ctypes.c_char_p)],
        }
        for name, argtypes in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs["cuda"] = lib
        try:
            _cu(lib.cuInit(0), "cuInit")
        except MXNetError:
            del _libs["cuda"]
            raise
    return lib


def _cu(res, what):
    if res != 0:
        name = ctypes.c_char_p()
        _libs["cuda"].cuGetErrorName(res, ctypes.byref(name))
        raise MXNetError("rtc: %s failed: %s (%d)"
                         % (what, (name.value or b"?").decode(), res))


def _nv(lib, res, what):
    if res != 0:
        raise MXNetError("rtc: %s failed: %s" % (
            what, lib.nvrtcGetErrorString(res).decode()))


def _cuda_device(ctx=None):
    """The ``torch.device`` of a GPU context (the current device when
    None); raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise MXNetError("rtc: CudaModule needs a CUDA device; this host "
                         "has none (there is no CPU mode)")
    if ctx is None:
        return torch.device("cuda", torch.cuda.current_device())
    if not isinstance(ctx, Context) or ctx.device_type not in ("gpu", "tpu"):
        raise MXNetError("rtc: kernels launch on a GPU context; got %s"
                         % (ctx,))
    return ctx.torch_device()


def _current_context(device):
    """Check that PyTorch's context of ``device`` is current on this
    thread; called inside ``torch.cuda.device(device)``."""
    lib = _libcuda()
    ctx = ctypes.c_void_p()
    _cu(lib.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if not ctx.value:
        torch.empty(1, device=device)   # PyTorch creates it lazily
        _cu(lib.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if not ctx.value:
        raise MXNetError("rtc: no CUDA context is current for %s" % device)


class CudaModule:
    """CUDA C++ source compiled at runtime with NVRTC.

    ``options`` are NVRTC options (``--gpu-architecture`` defaults to the
    current device's, ``sm_90a`` on Hopper); ``exports`` are the names of
    kernels that are not ``extern "C"``, templates included
    (``"row_sum<float>"``): NVRTC instantiates them and ``get_kernel``
    finds them by these names. A compile error raises MXNetError with
    NVRTC's log."""

    def __init__(self, source, options=(), exports=()):
        device = _cuda_device()
        lib = _nvrtc()
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._exports = tuple(exports)
        options = list(options)
        if not any(o.startswith(("--gpu-architecture", "-arch"))
                   for o in options):
            major, minor = torch.cuda.get_device_capability(device)
            options.append("--gpu-architecture=sm_%d%d%s"
                           % (major, minor, "a" if major == 9 else ""))
        include = [d.parent / "include" for d in _toolkit_dirs()]
        options += ["--include-path=%s" % d for d in include if d.is_dir()]
        prog = ctypes.c_void_p()
        _nv(lib, lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        b"rtc.cu", 0, None, None),
            "nvrtcCreateProgram")
        try:
            for name in self._exports:
                _nv(lib, lib.nvrtcAddNameExpression(prog, name.encode()),
                    "nvrtcAddNameExpression(%s)" % name)
            opts = (ctypes.c_char_p * len(options))(
                *[o.encode() for o in options])
            res = lib.nvrtcCompileProgram(prog, len(options), opts)
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            lib.nvrtcGetProgramLog(prog, log)
            if res != 0:
                raise MXNetError("rtc: NVRTC could not compile the module "
                                 "(%s):\n%s" % (lib.nvrtcGetErrorString(
                                     res).decode(), log.value.decode(
                                         errors="replace")))
            self._lowered = {}
            for name in self._exports:
                low = ctypes.c_char_p()
                _nv(lib, lib.nvrtcGetLoweredName(prog, name.encode(),
                                                 ctypes.byref(low)),
                    "nvrtcGetLoweredName(%s)" % name)
                self._lowered[name] = low.value
            _nv(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            _nv(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
            self._cubin = cubin      # a buffer that outlives the call
        finally:
            lib.nvrtcDestroyProgram(ctypes.byref(prog))
        self._modules = {}      # device index -> CUmodule

    def _module(self, device):
        """The module loaded in ``device``'s context, which is current."""
        mod = self._modules.get(device.index)
        if mod is None:
            handle = ctypes.c_void_p()
            _cu(_libcuda().cuModuleLoadData(ctypes.byref(handle), self._cubin),
                "cuModuleLoadData")
            mod = self._modules[device.index] = handle.value
        return mod

    def _function(self, name, device):
        """The CUfunction of ``name``; called inside
        ``torch.cuda.device(device)`` with its context current."""
        _current_context(device)
        func = ctypes.c_void_p()
        res = _libcuda().cuModuleGetFunction(
            ctypes.byref(func), self._module(device),
            self._lowered.get(name, name.encode()))
        if res != 0:
            raise ValueError("no kernel %r in module (exports: %s)"
                             % (name, list(self._exports)))
        return func.value

    def get_kernel(self, name, signature):
        """The kernel ``name`` with the reference's ``signature`` string.
        Raises ValueError when the module was made with ``exports`` that
        do not name it, or when the module has no such kernel."""
        if self._exports and name not in self._exports:
            raise ValueError("kernel %r not in exports %s"
                             % (name, list(self._exports)))
        args = parse_signature(signature)
        device = _cuda_device()
        with torch.cuda.device(device):
            self._function(name, device)
        return Kernel(self, name, args)


class Kernel:
    """A kernel of a :class:`CudaModule` (the reference's
    ``CudaKernel``). ``Kernel.launches`` counts every launch of every
    kernel."""

    launches = 0

    def __init__(self, module, name, args):
        self._module = module
        self._name = name
        self._args = args

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0,
               out_shapes=None):
        """Launch on ``ctx`` (a GPU context) with up to three grid and
        block dimensions and ``shared_mem`` bytes of dynamic shared memory.
        Each argument is checked against the signature: an NDArray of its
        dtype on ``ctx`` for a pointer, a number for a scalar. With
        ``out_shapes=[(shape, dtype), ...]`` the outputs are allocated on
        ``ctx``, passed after ``args``, and returned (one NDArray, or a
        list of them)."""
        device = _cuda_device(ctx)
        outs = [zeros(shape, ctx=ctx, dtype=dtype)
                for shape, dtype in (out_shapes or ())]
        args = list(args) + outs
        if len(args) != len(self._args):
            raise MXNetError("rtc: kernel %s takes %d arguments, got %d"
                             % (self._name, len(self._args), len(args)))
        storage = []
        for i, (arg, (pointer, dtype)) in enumerate(zip(args, self._args)):
            if pointer:
                if not isinstance(arg, NDArray):
                    raise MXNetError("rtc: argument %d of %s must be an "
                                     "NDArray, got %s"
                                     % (i, self._name, type(arg).__name__))
                t = arg.data
                if t.dtype != dtype:
                    raise MXNetError("rtc: argument %d of %s must be %s, got "
                                     "%s" % (i, self._name, dtype, t.dtype))
                if t.device != device:
                    raise MXNetError("rtc: argument %d of %s is on %s, the "
                                     "launch on %s" % (i, self._name,
                                                       t.device, device))
                if not t.is_contiguous():
                    raise MXNetError("rtc: argument %d of %s is not "
                                     "contiguous" % (i, self._name))
                storage.append(ctypes.c_void_p(t.data_ptr()))
            else:
                if isinstance(arg, NDArray) or not isinstance(
                        arg, (int, float, np.number)):
                    raise MXNetError("rtc: argument %d of %s must be a "
                                     "number, got %s"
                                     % (i, self._name, type(arg).__name__))
                storage.append(_scalar(arg, dtype))
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        lib = _libcuda()
        # kernelParams: one void* per argument, pointing at its value
        params = (ctypes.c_void_p * len(storage))(
            *[ctypes.addressof(s) for s in storage])
        with torch.cuda.device(device):
            func = self._module._function(self._name, device)
            if shared_mem > _MAX_STATIC_SMEM:
                _cu(lib.cuFuncSetAttribute(
                    func, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                    int(shared_mem)), "cuFuncSetAttribute")
            stream = torch.cuda.current_stream(device).cuda_stream
            _cu(lib.cuLaunchKernel(func, *grid, *block, int(shared_mem),
                                   ctypes.c_void_p(stream), params, None),
                "cuLaunchKernel(%s)" % self._name)
        count(Kernel)
        if out_shapes is None:
            return None
        return outs[0] if len(outs) == 1 else outs


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError("rtc: %s must be 1 to 3 positive integers, got %s"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


def _scalar(value, dtype):
    """A scalar kernel argument as the ctypes value of its C type (half
    and bfloat16 go as their 16 bits)."""
    if dtype in (torch.float16, torch.bfloat16):
        bits = torch.tensor([float(value)], dtype=dtype).view(torch.int16)
        return ctypes.c_uint16(int(bits.item()) & 0xFFFF)
    if dtype.is_floating_point:
        return _SCALARS[dtype](float(value))
    return _SCALARS[dtype](int(value))

