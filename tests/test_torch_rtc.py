"""``mx.rtc`` of the port on the CPU: what runs without a card.

The module compiles CUDA C++ with NVRTC and launches through
``libcuda``, so compiling and launching are held on the card
(`test_torch_cuda.py`, `chip_smoke.py`). Here: the reference's signature
language, the scalar and launch-dimension conversions, and that the
module raises, with no CPU fallback, where NVRTC or the card is missing.
The JAX package's ``rtc`` runs Pallas source and has no counterpart in
the port, so nothing here imports JAX.
"""
import ctypes

import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import rtc


@pytest.mark.parametrize("signature, want", [
    ("const float *x, const float *y, float *out, int n",
     [(True, torch.float32), (True, torch.float32), (True, torch.float32),
      (False, torch.int32)]),
    ("double*a,int64_t  n", [(True, torch.float64), (False, torch.int64)]),
    ("const __nv_bfloat16 *x, __half h, uint8_t *m, char c, int8_t *z",
     [(True, torch.bfloat16), (False, torch.float16), (True, torch.uint8),
      (False, torch.int8), (True, torch.int8)]),
    ("const int32_t *idx", [(True, torch.int32)]),
])
def test_parse_signature(signature, want):
    assert rtc.parse_signature(signature) == want


@pytest.mark.parametrize("signature", ["float *x, const", "float x y",
                                       "const *x", ""])
def test_parse_signature_rejects_malformed(signature):
    with pytest.raises(ValueError, match="Invalid function prototype"):
        rtc.parse_signature(signature)


def test_parse_signature_rejects_unknown_type():
    with pytest.raises(TypeError, match="Unsupported kernel argument type"):
        rtc.parse_signature("const float *x, size_t n")


def test_scalar_arguments_take_their_c_type():
    assert rtc._scalar(3, torch.int32).value == 3
    assert isinstance(rtc._scalar(3, torch.int32), ctypes.c_int32)
    assert rtc._scalar(2.5, torch.float32).value == 2.5
    assert rtc._scalar(-7, torch.int64).value == -7
    assert rtc._scalar(1.0, torch.bfloat16).value == 0x3F80
    assert rtc._scalar(1.0, torch.float16).value == 0x3C00
    assert rtc._scalar(-2.0, torch.bfloat16).value == 0xC000


def test_launch_dimensions():
    assert rtc._dims((4,), "grid_dims") == (4, 1, 1)
    assert rtc._dims([2, 3, 4], "grid_dims") == (2, 3, 4)
    for bad in ((), (1, 1, 1, 1), (0, 1, 1)):
        with pytest.raises(mxt.MXNetError, match="grid_dims"):
            rtc._dims(bad, "grid_dims")


def test_cuda_module_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="needs a CUDA device"):
        rtc.CudaModule('extern "C" __global__ void k() {}')


def test_launch_refuses_a_cpu_context(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    kernel = rtc.Kernel(None, "k", rtc.parse_signature("float *x"))
    with pytest.raises(mxt.MXNetError, match="GPU context"):
        kernel.launch((mxt.nd.zeros((4,), ctx=mxt.cpu()),), mxt.cpu(),
                      (1, 1, 1), (4, 1, 1))


def test_missing_nvrtc_names_where_it_looked(monkeypatch, tmp_path):
    monkeypatch.delitem(rtc._libs, "nvrtc", raising=False)
    with pytest.raises(mxt.MXNetError, match="NVRTC .* not found in %s"
                       % tmp_path):
        rtc._nvrtc([tmp_path])


def test_toolkit_dirs_follow_cuda_home(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    dirs = rtc._toolkit_dirs()
    assert dirs[0] == tmp_path / "lib64"
    assert str(dirs[-1]) == "/usr/local/cuda/lib64"
