// Inference LSTM layer for Hopper (sm_90a): the hand-written counterpart of
// the TPU kernel mxnet_tpu/ops/pallas_kernels.py::fused_lstm (_lstm_kernel).
//
// The recurrence is lstm_persistent.cuh's, without residuals: one
// cooperative launch a layer with the block's slice of Wh resident in shared
// memory across all T steps (route 1), or one launch per step where that
// slice does not fit (route 2). The header says what bounds it and how its
// design answers that. c is written once a step by the thread that owns it
// and holds c_T on return.
#include "lstm_persistent.cuh"

// Runs the T-step recurrence on `stream`: xp (T, B, 4H), wh (H, 4H), h0 and
// c0 (B, H) read; hseq (T, B, H) and c (B, H, c_T on return) written; hx
// (2, B, Hp) scratch for route 1 (null for route 2); `gates` is unused (the
// training forward's signature). All f32, contiguous, on the current device.
// `persistent`, `grid`, `units`, `rows` and `smem` are the caller's plan.
// Returns the first CUDA error (0 when the launches were accepted); it does
// not synchronise.
extern "C" int fused_lstm_forward(const float* xp, const float* wh,
                                  const float* h0, const float* c0,
                                  float* hseq, float* c, float* gates,
                                  float* hx, int T, int B, int H,
                                  int persistent, int grid, int units,
                                  int rows, int smem, void* stream) {
  (void)gates;
  return lstm_forward<false>(xp, wh, h0, c0, hseq, c, nullptr, hx, T, B, H,
                             persistent, grid, units, rows, smem,
                             static_cast<cudaStream_t>(stream));
}

// The current device's SM count and opt-in shared memory a block.
extern "C" int fused_lstm_limits(int* sms, int* smem_optin) {
  return lstm_device_limits(sms, smem_optin);
}

extern "C" const char* fused_lstm_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
