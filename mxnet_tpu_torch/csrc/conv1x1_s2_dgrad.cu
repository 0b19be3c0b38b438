// Input gradient of a stride-2, pad-0 NHWC 1x1 convolution, for Hopper
// (sm_90a): the hand-written counterpart of the TPU kernel
// mxnet_tpu/ops/conv_kernels.py::conv1x1_s2_dgrad (_kern).
//
// What it computes. dy (N, Ho, Wo, K) and the kernel matrix w2 (K, C) (the
// OHWI weight of the 1x1 conv, reshaped) give dx (N, 2Ho, 2Wo, C) with
//   dx[:, ::2, ::2, :] = dy @ w2     (f32 accumulation, stored in dy's type)
// and exact zeros everywhere else. It is one GEMM, M = N*Ho*Wo rows of depth K
// and width C, plus an interleaved store. Every element of dx is written
// once, zeros included, with no separate memset.
//
// Three routes, which the wrapper (ops/conv_kernel.py::_k5_route) picks from
// the shape and dtype before the launch and passes in as a plan; a plan a
// route is not built for is refused, never changed:
// - "wgmma" (bf16, K and C multiples of 8): the persistent TMA + wgmma
//   kernel of dgrad_wgmma.cuh, tiles of 128 rows by BN = 128 or 256
//   columns. The six stride-2 sites of a ResNet-50 step take it.
// - "wmma" (bf16 shapes TMA cannot address: K or C not a multiple of 8):
//   tensor cores through WMMA (mma.sync, 16x16x16 bf16 -> f32). A block of
//   8 warps computes a 128x64 tile in steps of 32 along K; each warp holds a
//   32x32 piece in 2x2 fragments. Tiles are staged in shared memory with
//   element-wise masked loads; the accumulators go back through shared
//   memory and each product element is stored with its three zeros.
// - "f32": a 64x64 tile on the CUDA cores, 256 threads of 4x4 outputs, exact
//   f32 (no TF32), for the f32 path and the references that run TF32 off.
//
// What bounds it: see dgrad_wgmma.cuh; the two other routes are off the
// bf16 training path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include "dgrad_wgmma.cuh"

namespace {

using k5::dx_row;

// ------------------------------------------------------------ the wmma route
constexpr int kBM = 128;  // rows of the product per block
constexpr int kBN = 64;   // columns of the product per block
constexpr int kBK = 32;   // depth per shared-memory stage
constexpr int kLdA = kBK + 8;   // padded strides (elements): 16-byte rows,
constexpr int kLdB = kBN + 8;   // 32-byte aligned fragment pointers
constexpr int kLdC = kBN + 4;
constexpr int kThreads = 256;   // 8 warps: 4 along M x 2 along N
constexpr size_t kSmemAB =
    (kBM * kLdA + kBK * kLdB) * sizeof(__nv_bfloat16);
constexpr size_t kSmemC = kBM * kLdC * sizeof(float);
constexpr size_t kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ src,
                                      bool row_ok, int col, int ncols,
                                      __nv_bfloat16* dst) {
  uint4 u = make_uint4(0, 0, 0, 0);  // 8 bf16 = 16 bytes
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (row_ok && col + i < ncols) e[i] = src[i];
  *reinterpret_cast<uint4*>(dst) = u;
}

__global__ void __launch_bounds__(kThreads)
dgrad_bf16(const __nv_bfloat16* __restrict__ dy,  // (M, K)
           const __nv_bfloat16* __restrict__ w2,  // (K, C)
           __nv_bfloat16* __restrict__ dx,        // (N, 2Ho, 2Wo, C)
           int M, int K, int C, int Wo) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kBM * kLdA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp % 4) * 32;
  const int wn = (warp / 4) * 32;
  const int m0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A: 128 x 32 = 512 chunks of 8, two per thread
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / (kBK / 8);
      const int col = (e % (kBK / 8)) * 8;
      const int m = m0 + row;
      load8(dy + static_cast<size_t>(m) * K + k0 + col, m < M, k0 + col, K,
            As + row * kLdA + col);
    }
    // B: 32 x 64 = 256 chunks of 8, one per thread
    {
      const int row = tid / (kBN / 8);
      const int col = (tid % (kBN / 8)) * 8;
      const int k = k0 + row;
      load8(w2 + static_cast<size_t>(k) * C + c0 + col, k < K, c0 + col, C,
            Bs + row * kLdB + col);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wn + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kLdC + wn + 16 * j,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();

  // interleaved store: 128 rows x 64 columns in chunks of 8, four per thread;
  // each chunk writes the value at (2ho, 2wo) and zeros at the other three
  const size_t rowW = 2 * static_cast<size_t>(Wo) * C;  // one row of dx
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = tid + r * kThreads;
    const int row = e / (kBN / 8);
    const int col = (e % (kBN / 8)) * 8;
    const int m = m0 + row;
    const int c = c0 + col;
    if (m >= M || c >= C) continue;
    const size_t p = dx_row(m, Wo, C) + c;
    const float* v = Cs + row * kLdC + col;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = 0; i < 8 && c + i < C; ++i) {
      dx[p + i] = __float2bfloat16(v[i]);
      dx[p + C + i] = zero;
      dx[p + rowW + i] = zero;
      dx[p + rowW + C + i] = zero;
    }
  }
}

// ------------------------------------------------------------- the f32 route
constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;

__global__ void __launch_bounds__(256)
dgrad_f32(const float* __restrict__ dy, const float* __restrict__ w2,
          float* __restrict__ dx, int M, int K, int C, int Wo) {
  __shared__ float As[kFK][kFM + 4];  // transposed: As[k][m]
  __shared__ float Bs[kFK][kFN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 columns each
  const int ty = tid / 16;  // 4 rows each
  const int m0 = blockIdx.x * kFM;
  const int c0 = blockIdx.y * kFN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * 256;
      const int row = e / kFK, kk = e % kFK;  // A: 64 x 16
      const int m = m0 + row, k = k0 + kk;
      As[kk][row] = (m < M && k < K) ? dy[static_cast<size_t>(m) * K + k]
                                     : 0.f;
      const int brow = e / kFN, bcol = e % kFN;  // B: 16 x 64
      const int bk = k0 + brow, c = c0 + bcol;
      Bs[brow][bcol] = (bk < K && c < C) ? w2[static_cast<size_t>(bk) * C + c]
                                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const size_t rowW = 2 * static_cast<size_t>(Wo) * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const size_t base = dx_row(m, Wo, C);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c >= C) continue;
      const size_t p = base + c;
      dx[p] = acc[i][j];
      dx[p + C] = 0.f;
      dx[p + rowW] = 0.f;
      dx[p + rowW + C] = 0.f;
    }
  }
}

}  // namespace

// dy (N*Ho*Wo = M, K) and w2 (K, C) read, dx (N, 2Ho, 2Wo, C) written in
// full (only Wo is needed to place a row); contiguous, on one device, dtype 0 = f32, 1 = bf16. The plan: route
// 0 = f32, 1 = wmma, 2 = wgmma; bn the columns of a tile; stages the depth
// of the TMA ring (1 for the other routes); grid the blocks of the launch;
// smem the dynamic shared memory of a block (0 for the other routes).
// Launches one kernel on `stream` and returns 0 when it was accepted, else
// the reason it was refused: -1 an unknown dtype, -2 a route the dtype or
// shape cannot take, -3 an operand TMA cannot address (not 16-byte
// aligned), -4 no cuTensorMapEncodeTiled in the CUDA driver, -5 a map it
// refused, -6 a plan the route is not built for, or the launch's CUDA
// error. It does not synchronise.
extern "C" int conv1x1_s2_dgrad(const void* dy, const void* w2, void* dx,
                                int M, int K, int C, int Wo,
                                int dtype, int route, int bn, int stages,
                                int grid, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -1;
  if (route == 2) {
    if (dtype != 1 || K < 8 || K % 8 != 0 || C % 8 != 0) return -2;
    if (((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(w2) |
          reinterpret_cast<uintptr_t>(dx)) % 16) != 0)
      return -3;
    if (bn == 256)
      return k5::launch<256>(dy, w2, dx, M, K, C, Wo, stages, grid, smem, s);
    if (bn == 128)
      return k5::launch<128>(dy, w2, dx, M, K, C, Wo, stages, grid, smem, s);
    return -6;
  }
  if (route != 0 && route != 1) return -6;
  if (route != dtype) return -2;  // f32 on the CUDA cores, bf16 on WMMA
  const int bm = route == 1 ? kBM : kFM;
  const dim3 blocks((M + bm - 1) / bm, (C + kBN - 1) / kBN);
  if (bn != kBN || stages != 1 || smem != 0 ||
      grid != static_cast<int>(blocks.x * blocks.y))
    return -6;
  if (route == 1)
    dgrad_bf16<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(w2),
        static_cast<__nv_bfloat16*>(dx), M, K, C, Wo);
  else
    dgrad_f32<<<blocks, 256, 0, s>>>(static_cast<const float*>(dy),
                                     static_cast<const float*>(w2),
                                     static_cast<float*>(dx), M, K, C, Wo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv1x1_s2_dgrad_error_name(int err) {
  if (err == -1) return "unsupported dtype";
  if (err == -2) return "a route the dtype or shape cannot take";
  if (err == -3) return "the wgmma route needs 16-byte aligned dy, w2 and dx";
  if (err == -4) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err == -5) return "cuTensorMapEncodeTiled refused a tensor map";
  if (err == -6) return "a plan the route is not built for";
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
