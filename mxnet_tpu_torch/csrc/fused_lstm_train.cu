// Training LSTM layer for Hopper (sm_90a): the hand-written counterparts of
// two TPU kernels of mxnet_tpu/ops/pallas_kernels.py, the forward and the
// backward of fused_lstm's custom VJP.
//
// K2 fused_lstm_train_forward replaces _lstm_fwd_train_kernel (called from
// _lstm_vjp_fwd). It runs K1's recurrence (lstm_persistent.cuh) and also
// keeps the residuals the backward needs, gate order i, f, g, o:
//   gates_t = [sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)]  (post-activation)
//   c_t     = f * c_{t-1} + i * g,   h_t = o * tanh(c_t)
// writing hseq, cseq (T, B, H) and gates (T, B, 4H). xp = x @ Wx + b comes
// from the caller (one cuBLAS product for all steps, as in the TPU code).
//
// K3 fused_lstm_backward replaces _lstm_bwd_kernel (called from
// _lstm_vjp_bwd). It walks t = T-1 .. 0 with the carries dh and dc:
//   dh      = dhseq_t + dh_carry            (dh_carry = dh_n at t = T-1)
//   do      = dh * tanh(c_t)
//   dc      = dc_carry + dh * o * (1 - tanh(c_t)^2)   (dc_carry = dc_n first)
//   dgates_t = [dc*g * i(1-i), dc*c_{t-1} * f(1-f), dc*i * (1-g^2), do * o(1-o)]
//   dh_carry = dgates_t @ Wh^T,   dc_carry = dc * f
// and returns dgates (T, B, 4H), dh0 = dgates_0 @ Wh^T and dc0. The input and
// weight gradients are sequence-wide products of dgates that the caller runs
// outside (dx, dWx, dWh, db), as the TPU code does.
//
// Design. K2 is the recurrence of lstm_persistent.cuh with residuals: one
// cooperative launch a layer with the block's slice of Wh resident in shared
// memory across all T steps (route 1), or one launch per step where that
// slice does not fit (route 2); the header says what bounds it. It writes
// c_t and the activated gates every step, and reads c_{t-1} from cseq (c0 at
// t = 0): nothing is updated in place and c0 is not copied.
//
// K3 takes one of two routes, chosen from the shape by the caller
// (mxnet_tpu_torch/ops/lstm_kernel.py::_lstm_bwd_route). Route 1,
// lstm_bwd_persistent (lstm_bwd_persistent.cuh, which says what bounds it):
// one cooperative launch a layer, each block's slice of Wh resident in
// shared memory for all T steps, the partial products of dgates_t @ Wh^T
// exchanged between blocks through a double buffer in device memory.
// Route 2, below, where that slice and one row group do not fit (at 132
// SMs, H above about 1,200): one launch per step, the carry product fused
// with the elementwise part. For
// hidden unit j the elementwise part needs only column j of each gate, so a
// block that owns units j..j+31 for 8 rows first reduces
//   dh_carry[b, j] = sum_k dgates_{t+1}[b, k] * WhT[k, j],  k < 4H,
// and then writes dgates_t[b, j + g*H] for the four gates. WhT (4H, H) is
// passed contiguous, as the TPU code passes it, so a warp's loads of one row
// of WhT are coalesced; the 8 warps take k in chunks of 4, read as one float4
// of each dgates row (4H is a multiple of 4, so the chunks stay aligned).
// dgates_{t+1} is already in the output buffer from the launch before, and dc
// is owned in place by the one thread that updates it. One last
// reduction-only launch gives dh0: T + 1 dependent launches, each of which
// reads all of WhT from the L2 once per 8-row batch tile.
#include "lstm_bwd_persistent.cuh"

namespace {

// The carry product of the backward for this block's 32 units and 8 rows:
// returns sum_k dg[b0 + warp, k] * whT[k, j] to the thread of (warp, lane);
// every thread of the block must call it (it synchronises the block).
__device__ __forceinline__ float carry_product(
    const float* __restrict__ dg,   // (B, 4H)
    const float* __restrict__ whT,  // (4H, H)
    float (*partial)[kRows][kLanes], int b0, int rows, int j, int H) {
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const size_t G = 4 * static_cast<size_t>(H);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  if (j < H) {
    const float* dgb = dg + static_cast<size_t>(b0) * G;
    for (int c = warp; c < H; c += kWarps) {  // chunk c: k = 4c .. 4c+3
      const size_t k = 4 * static_cast<size_t>(c);
      const float w0 = whT[k * H + j];
      const float w1 = whT[(k + 1) * H + j];
      const float w2 = whT[(k + 2) * H + j];
      const float w3 = whT[(k + 3) * H + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float4 d =
              *reinterpret_cast<const float4*>(dgb + r * G + k);
          acc[r] = fmaf(d.x, w0, acc[r]);
          acc[r] = fmaf(d.y, w1, acc[r]);
          acc[r] = fmaf(d.z, w2, acc[r]);
          acc[r] = fmaf(d.w, w3, acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) partial[warp][r][lane] = acc[r];
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += partial[w][warp][lane];
  return s;
}

__global__ void __launch_bounds__(kLanes * kWarps)
lstm_bwd_step(const float* __restrict__ dg_next,  // (B, 4H) dgates_{t+1},
                                                  // null at t = T-1
              const float* __restrict__ dh_last,  // (B, H) dh_n
              const float* __restrict__ whT,      // (4H, H)
              const float* __restrict__ dh_out,   // (B, H) dhseq_t
              const float* __restrict__ gates_t,  // (B, 4H), activated
              const float* __restrict__ c_t,      // (B, H)
              const float* __restrict__ c_prev,   // (B, H)
              float* __restrict__ dc,             // (B, H), in place
              float* __restrict__ dg_t,           // (B, 4H)
              int B, int H) {
  __shared__ float partial[kWarps][kRows][kLanes];  // 8 KB
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int j = blockIdx.x * kLanes + lane;
  const int b0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - b0);
  const size_t G = 4 * static_cast<size_t>(H);

  // dg_next is the same for every block: the branch is uniform
  const float carry = dg_next != nullptr
      ? carry_product(dg_next, whT, partial, b0, rows, j, H) : 0.0f;

  const int r = warp;  // elementwise part: warp w finishes row b0 + w
  if (r < rows && j < H) {
    const size_t row = static_cast<size_t>(b0 + r);
    const size_t idx = row * H + j;
    const float dh = dh_out[idx] + (dg_next != nullptr ? carry : dh_last[idx]);
    const float* gt = gates_t + row * G;
    const float gi = gt[j];
    const float gf = gt[H + j];
    const float gg = gt[2 * H + j];
    const float go = gt[3 * H + j];
    const float th = tanhf(c_t[idx]);
    const float d_o = dh * th;
    const float dcv = dc[idx] + dh * go * (1.0f - th * th);
    float* out = dg_t + row * G;
    out[j] = dcv * gg * gi * (1.0f - gi);
    out[H + j] = dcv * c_prev[idx] * gf * (1.0f - gf);
    out[2 * H + j] = dcv * gi * (1.0f - gg * gg);
    out[3 * H + j] = d_o * go * (1.0f - go);
    dc[idx] = dcv * gf;
  }
}

__global__ void __launch_bounds__(kLanes * kWarps)
lstm_bwd_dh0(const float* __restrict__ dg0,  // (B, 4H) dgates_0
             const float* __restrict__ whT,  // (4H, H)
             float* __restrict__ dh0,        // (B, H)
             int B, int H) {
  __shared__ float partial[kWarps][kRows][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int j = blockIdx.x * kLanes + lane;
  const int b0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - b0);
  const float s = carry_product(dg0, whT, partial, b0, rows, j, H);
  if (warp < rows && j < H) dh0[static_cast<size_t>(b0 + warp) * H + j] = s;
}

dim3 grid_of(int B, int H) {
  return dim3((H + kLanes - 1) / kLanes, (B + kRows - 1) / kRows);
}

}  // namespace

// K2: the T-step forward on `stream`. Reads xp (T, B, 4H), wh (H, 4H),
// h0 and c0 (B, H); writes hseq and cseq (T, B, H) and gates (T, B, 4H); hx
// (2, B, Hp) is scratch for route 1 (null for route 2). All f32, contiguous,
// on the current device. `persistent`, `grid`, `units`, `rows` and `smem`
// are the caller's plan. Returns the first CUDA error (0 when the launches
// were accepted); it does not synchronise.
extern "C" int fused_lstm_train_forward(const float* xp, const float* wh,
                                        const float* h0, const float* c0,
                                        float* hseq, float* cseq,
                                        float* gates, float* hx, int T, int B,
                                        int H, int persistent, int grid,
                                        int units, int rows, int smem,
                                        void* stream) {
  return lstm_forward<true>(xp, wh, h0, c0, hseq, cseq, gates, hx, T, B, H,
                            persistent, grid, units, rows, smem,
                            static_cast<cudaStream_t>(stream));
}

// The current device's SM count and opt-in shared memory a block.
extern "C" int fused_lstm_train_limits(int* sms, int* smem_optin) {
  return lstm_device_limits(sms, smem_optin);
}

// K3: the reverse-time backward on `stream`. Reads dhseq (T, B, H), dh_n
// (B, H), gates (T, B, 4H), cseq (T, B, H), c0 (B, H) and the weights `w`:
// on route 1 (`persistent`) wh (H, 4H) with element strides ws0 and ws1, on
// route 2 whT (4H, H), contiguous. dc (B, H) holds dc_n on entry and dc0 on
// return; writes dgates (T, B, 4H) and dh0 (B, H). xbuf (2, grid,
// ceil(B/8), grid, 8, units) is route 1's scratch, any contents (null for
// route 2). All f32 on one device. `persistent`, `grid`, `units`, `rows`
// and `smem` are the caller's plan: one launch on route 1, T + 1 on route
// 2. Returns the first CUDA error (0 when the launches were accepted); it
// does not synchronise.
extern "C" int fused_lstm_backward(const float* dhseq, const float* dhn,
                                   const float* gates, const float* cseq,
                                   const float* c0, const float* w,
                                   float* dc, float* dgates, float* dh0,
                                   float* xbuf, int T, int B, int H,
                                   long long ws0, long long ws1,
                                   int persistent, int grid, int units,
                                   int rows, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (persistent) {
    return lstm_backward_persistent(dhseq, dhn, gates, cseq, c0, w, ws0, ws1,
                                    dc, dgates, dh0, xbuf, T, B, H, grid,
                                    units, rows, smem, s);
  }
  const dim3 block(kLanes * kWarps);
  const size_t bh = static_cast<size_t>(B) * H;
  for (int t = T - 1; t >= 0; --t) {
    const size_t off = static_cast<size_t>(t) * bh;
    const float* dg_next = t == T - 1 ? nullptr : dgates + 4 * (off + bh);
    const float* cp = t == 0 ? c0 : cseq + off - bh;
    lstm_bwd_step<<<grid_of(B, H), block, 0, s>>>(
        dg_next, dhn, w, dhseq + off, gates + 4 * off, cseq + off, cp, dc,
        dgates + 4 * off, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lstm_bwd_dh0<<<grid_of(B, H), block, 0, s>>>(dgates, w, dh0, B, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_lstm_train_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
