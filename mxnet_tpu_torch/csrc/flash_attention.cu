// Streaming-softmax attention forward for Hopper (sm_90a): the hand-written
// counterpart of the TPU kernel mxnet_tpu/ops/pallas_kernels.py::
// flash_attention (_flash_fwd -> _flash_fwd_kernel).
//
// What it computes. q [B, Tq, H, D], k and v [B, Tk, H, D] give
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h]) v[b, j, h]
// over the keys j < Tk, and for causal attention only j <= i (absolute
// positions: aligned at the top left when Tq != Tk), with masked scores at
// -1e30 as in the TPU kernel. The running max, the normaliser and the
// accumulator are f32; o is stored in q's type.
//
// Design. The TPU kernel walks a grid (B*H, q blocks, k blocks) in order and
// carries its softmax statistics across the k axis in VMEM scratch. Hopper's
// blocks run in no order, so here one block owns one (b, h, q tile) and the
// k axis is a loop inside it: the tile's statistics and accumulator live in
// registers for the whole sweep, and o is divided by the normaliser once at
// the end (the same function as the TPU kernel's per-block renormalisation).
// With causal attention the loop stops at the tile that holds the diagonal,
// and q tiles are issued last-first so that the longest sweeps start first.
// q, k and v are read in place through their token stride H*D: no transpose.
// Rows past Tq or Tk and columns past D load as zeros; masked scores make the
// padded keys count for nothing.
//
// - bf16: four warps, 64 q rows (16 a warp), 64 keys a step, tensor cores
//   through mma.sync m16n8k16 (bf16 in, f32 accumulation). q.k^T is exact
//   products summed in f32, as the TPU kernel's f32 products of bf16 inputs
//   are. P is not rounded to bf16 for P.V: it is split into a bf16 high part
//   and a bf16 low part, and both go through the tensor cores, so P keeps
//   about 16 bits and the result differs from the f32-math version by
//   summation order before its one rounding to bf16.
// - f32: 256 threads on CUDA-core FMAs, 32 q rows and 64 keys a step, exact
//   f32 (no TF32), for the f32 path and the references that run TF32 off.
// Tiles are staged in dynamic shared memory (52 KB for bf16 at D = 128, 89 KB
// for f32), above the 48 KB default, so the limit is raised before launch.
// D may be anything up to 128.
//
// What bounds it. Per (b, h) it does 4*Tq*Tk*D operations (half of them for
// causal attention) on 4*T*D elements, so from T of about 1024 on, the
// operations bound it: at B=1, H=8, D=128, causal, T=4096 in bf16, 34 GFLOP
// take 35 us at 989 TFLOP/s while the 34 MB take 10 us at 3.35 TB/s. This
// kernel spends 1.5x those operations (the split P.V) on mma.sync, which
// reaches a fraction of the wgmma rate; a wgmma/TMA pipeline, and rounding P
// once where a caller allows it, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------- bf16 path
constexpr int kBM = 64;        // q rows per block, 16 per warp
constexpr int kBN = 64;        // keys per step
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (x0, x1) = hi + lo with hi and lo pairs of bf16 (x0 in the low half)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// c += a (16x16, row major) * b (16x8, column major); bf16 in, f32 out
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [t0, t0 + rows) of one head (token stride rs) into shared memory
// (row stride ld), 16 bytes a thread; zeros past T and past D
template <int kD, bool kVec>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ base,
                                          size_t rs, int t0, int T, int D,
                                          bf16* dst, int ld, int rows) {
  constexpr int kChunks = kD / 8;
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 8;
    const int t = t0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (t < T) {
      const bf16* src = base + static_cast<size_t>(t) * rs + c;
      if (kVec) {
        // D is a multiple of 8: a chunk is wholly inside or outside
        if (c < D) u = *reinterpret_cast<const uint4*>(src);
      } else {
        bf16* ev = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (c + i < D) ev[i] = src[i];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = u;
  }
}

template <int kD, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int Tq,
               int Tk, int H, int D, float scale, int causal) {
  constexpr int kLd = kD + 8;  // 16-byte rows, conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBM * kLd;
  bf16* Vs = Ks + kBN * kLd;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t head = static_cast<size_t>(h) * D;
  const bf16* qb = q + static_cast<size_t>(b) * Tq * rs + head;
  const bf16* kb = k + static_cast<size_t>(b) * Tk * rs + head;
  const bf16* vb = v + static_cast<size_t>(b) * Tk * rs + head;
  bf16* ob = o + static_cast<size_t>(b) * Tq * rs + head;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and column of B fragments)
  const int t4 = lane % 4;  // fragment column pair

  load_tile<kD, kVec>(qb, rs, q0, Tq, D, Qs, kLd, kBM);
  __syncthreads();
  // this warp's 16 q rows as A fragments, for the whole sweep
  uint32_t qf[kD / 16][4];
  const int qr = warp * 16 + g;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const bf16* p = Qs + qr * kLd + ks * 16 + t4 * 2;
    qf[ks][0] = ld32(p);
    qf[ks][1] = ld32(p + 8 * kLd);
    qf[ks][2] = ld32(p + 8);
    qf[ks][3] = ld32(p + 8 * kLd + 8);
  }

  // rows row0 = q0 + qr and row1 = row0 + 8: fragment elements 0-1 and 2-3
  const int row0 = q0 + qr;
  const int row1 = row0 + 8;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int n_tiles = (Tk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBM, Tq) - 1) / kBN + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // the previous step's K and V are no longer read
    load_tile<kD, kVec>(kb, rs, k0, Tk, D, Ks, kLd, kBN);
    load_tile<kD, kVec>(vb, rs, k0, Tk, D, Vs, kLd, kBN);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp, 8 fragments of 8 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const bf16* p = Ks + (nt * 8 + g) * kLd + ks * 16 + t4 * 2;
        mma(s[nt], qf[ks], ld32(p), ld32(p + 8));
      }

    // scale, mask, and the streaming softmax statistics of the two rows
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[nt][e] * scale;
        if (col >= Tk || (causal && row < col)) x = kNeg;
        s[nt][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {  // the 4 lanes that share a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0);
    const float a1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, w);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, w);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }

    // O += P V: the S fragments of two 8-key groups are the A fragment of
    // P for 16 keys; P goes in as a bf16 high and a bf16 low part
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        // B fragment: keys kk*16 + t4*2 + {0, 1} (and + 8), column dt*8 + g
        const bf16* p = Vs + (kk * 16 + t4 * 2) * kLd + dt * 8 + g;
        const uint32_t b0 = pack2(p[0], p[kLd]);
        const uint32_t b1 = pack2(p[8 * kLd], p[9 * kLd]);
        mma(acc[dt], ph, b0, b1);
        mma(acc[dt], pl, b0, b1);
      }
    }
  }

  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row0 : row1;
      const int d = dt * 8 + t4 * 2 + (e & 1);
      if (row < Tq && d < D)
        ob[static_cast<size_t>(row) * rs + d] =
            __float2bfloat16(acc[dt][e] * (e < 2 ? inv0 : inv1));
    }
}

// ----------------------------------------------------------------- f32 path
constexpr int kFM = 32;         // q rows per block
constexpr int kFN = 64;         // keys per step
constexpr int kFThreads = 256;  // 8 threads a row

template <int kD>
__global__ void __launch_bounds__(kFThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Tq,
              int Tk, int H, int D, float scale, int causal) {
  constexpr int kLdQ = kD + 1;  // odd strides: no bank conflicts
  constexpr int kLdP = kFN + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // kFM x kLdQ
  float* Ks = Qs + kFM * kLdQ;                 // kFN x kLdQ
  float* Vs = Ks + kFN * kLdQ;                 // kFN x kD
  float* Ps = Vs + kFN * kD;                   // kFM x kLdP

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFM;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t head = static_cast<size_t>(h) * D;
  const float* qb = q + static_cast<size_t>(b) * Tq * rs + head;
  const float* kb = k + static_cast<size_t>(b) * Tk * rs + head;
  const float* vb = v + static_cast<size_t>(b) * Tk * rs + head;
  float* ob = o + static_cast<size_t>(b) * Tq * rs + head;

  const int tid = threadIdx.x;
  const int r = tid / 8;   // this thread's q row in the tile
  const int c8 = tid % 8;  // its keys c8 + 8j and its columns c8 + 8j
  const int row = q0 + r;

  for (int e = tid; e < kFM * kD; e += kFThreads) {
    const int rr = e / kD, d = e % kD, t = q0 + rr;
    Qs[rr * kLdQ + d] =
        (t < Tq && d < D) ? qb[static_cast<size_t>(t) * rs + d] : 0.f;
  }
  float m = kNeg, l = 0.f;
  float acc[kD / 8];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j] = 0.f;

  int n_tiles = (Tk + kFN - 1) / kFN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kFM, Tq) - 1) / kFN + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFN;
    __syncthreads();
    for (int e = tid; e < kFN * kD; e += kFThreads) {
      const int rr = e / kD, d = e % kD, t = k0 + rr;
      const bool ok = t < Tk && d < D;
      const size_t at = static_cast<size_t>(t) * rs + d;
      Ks[rr * kLdQ + d] = ok ? kb[at] : 0.f;
      Vs[rr * kD + d] = ok ? vb[at] : 0.f;
    }
    __syncthreads();

    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float qv = Qs[r * kLdQ + d];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[j] = fmaf(qv, Ks[(c8 + 8 * j) * kLdQ + d], s[j]);
    }
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + c8 + 8 * j;
      float x = s[j] * scale;
      if (col >= Tk || (causal && row < col)) x = kNeg;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int w = 1; w < 8; w *= 2)  // the 8 lanes of a row
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float mn = fmaxf(m, mx);
    const float a = expf(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = expf(s[j] - mn);
      sum += s[j];
      Ps[r * kLdP + c8 + 8 * j] = s[j];
    }
#pragma unroll
    for (int w = 1; w < 8; w *= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l = l * a + sum;
    m = mn;
    __syncwarp();  // a row's P is written and read by the same 8 lanes
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) acc[j] *= a;
#pragma unroll 4
    for (int kk = 0; kk < kFN; ++kk) {
      const float pv = Ps[r * kLdP + kk];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        acc[j] = fmaf(pv, Vs[kk * kD + c8 + 8 * j], acc[j]);
    }
    __syncwarp();
  }
  if (row < Tq) {
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int d = c8 + 8 * j;
      if (d < D) ob[static_cast<size_t>(row) * rs + d] = acc[j] * inv;
    }
  }
}

// --------------------------------------------------------------- launchers
template <int kD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Tq, int Tk, int H, int D, float scale, int causal,
                cudaStream_t s) {
  constexpr size_t smem = static_cast<size_t>(kBM + 2 * kBN) * (kD + 8) *
                          sizeof(bf16);
  const bool vec = D % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  auto kern = vec ? flash_fwd_bf16<kD, true> : flash_fwd_bf16<kD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kBM - 1) / kBM, B * H);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Tq, Tk, H, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Tq, int Tk, int H, int D, float scale, int causal,
               cudaStream_t s) {
  constexpr size_t smem =
      (static_cast<size_t>(kFM + kFN) * (kD + 1) + kFN * kD + kFM * (kFN + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kFM - 1) / kFM, B * H);
  flash_fwd_f32<kD><<<grid, kFThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Tq, Tk, H, D,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Tq, H, D], k and v [B, Tk, H, D] read, o [B, Tq, H, D] written;
// contiguous, on one device, dtype 0 = f32, 1 = bf16; 1 <= D <= 128,
// Tk >= 1. Launches one kernel on `stream` and returns its launch error (0
// when it was accepted, -1 for an unknown dtype, -2 for D out of range); it
// does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Tq, int Tk, int H,
                                   int D, float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128) return -2;
  if (dtype == 1) {
    if (D <= 32) return launch_bf16<32>(q, k, v, o, B, Tq, Tk, H, D, scale,
                                        causal, s);
    if (D <= 64) return launch_bf16<64>(q, k, v, o, B, Tq, Tk, H, D, scale,
                                        causal, s);
    return launch_bf16<128>(q, k, v, o, B, Tq, Tk, H, D, scale, causal, s);
  }
  if (dtype == 0) {
    if (D <= 32) return launch_f32<32>(q, k, v, o, B, Tq, Tk, H, D, scale,
                                       causal, s);
    if (D <= 64) return launch_f32<64>(q, k, v, o, B, Tq, Tk, H, D, scale,
                                       causal, s);
    return launch_f32<128>(q, k, v, o, B, Tq, Tk, H, D, scale, causal, s);
  }
  return -1;
}

extern "C" const char* flash_attention_error_name(int err) {
  if (err == -1) return "unsupported dtype";
  if (err == -2) return "head dim out of range (1..128)";
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
