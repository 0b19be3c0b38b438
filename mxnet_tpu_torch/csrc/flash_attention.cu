// Streaming-softmax attention forward for Hopper (sm_90a): the hand-written
// counterpart of the TPU kernel mxnet_tpu/ops/pallas_kernels.py::
// flash_attention (_flash_fwd -> _flash_fwd_kernel).
//
// What it computes. q [B, Tq, H, D], k and v [B, Tk, H, D] give
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h]) v[b, j, h]
// over the keys j < Tk, and for causal attention only j <= i (absolute
// positions: aligned at the top left when Tq != Tk), with masked scores at
// -1e30 as in the TPU kernel. The running max, the normaliser and the
// accumulator are f32; o is stored in q's type, rounded once.
//
// Shape of the work. The TPU kernel walks a grid (B*H, q blocks, k blocks)
// in order and carries its softmax statistics across the k axis in VMEM
// scratch. Hopper's blocks run in no order, so one block owns one (b, h, q
// tile) and the k axis is a loop inside it: statistics and accumulator live
// in registers for the whole sweep, and o is divided by the normaliser once
// at the end (the same function as the TPU kernel's per-block
// renormalisation). With causal attention the loop stops at the tile that
// holds the diagonal. q, k and v are read in place through their token
// stride H*D: no transpose, no copy.
//
// What bounds it. Per (b, h) it does 4*Tq*Tk*D operations (half of them for
// causal attention) on 4*T*D elements, so from T of about 1024 on the
// operations bound it: at B=1, H=8, D=128, causal, T=4096, 34 GFLOP take
// 35 us at the bf16 peak of 989 TFLOP/s while the 34 MB take 10 us at
// 3.35 TB/s. The bf16 kernel does 1.5x those operations: P.V runs twice,
// on P's bf16 high part and on its low part, so P keeps about 16 bits and
// the result is the f32-math one before its single rounding (the TPU
// kernel computes both products in f32; P rounded once to bf16 would be
// another function).
//
// bf16: warp-specialised TMA + wgmma.
// - Block: 384 threads. Warpgroups 0 and 1 are consumers of 64 q rows
//   each (wgmma's M) and rise to 240 registers (setmaxnreg); warpgroup 2
//   is the producer: it drops to 24, and one of its threads issues every
//   TMA load while its other warps exit. 128 q rows a block, 128 keys a
//   tile: each K/V tile read serves 128 rows. Grid (B*H, q tiles), the q
//   tiles issued last-first so that the longest causal sweeps start first
//   across all heads. Not persistent: at 160 KB of shared memory one
//   block fills an SM, and 256 blocks at B*H=8, T=4096 make two waves on
//   132 SMs; a persistent scheduler would overlap one tile's epilogue with
//   the next one's loads, left for later.
// - Registers: a consumer thread holds O (64 f32 at D=128), S (64 f32)
//   and then P as bf16 hi/lo fragments (64 registers) while the P.V
//   wgmmas run: ptxas (CUDA 12.9) gives the consumer branch about 200,
//   no spills. 384 threads start at 168 a thread (three warps share each
//   SM sub-partition's 16K registers), so without setmaxnreg, or with a
//   __trap() anywhere in the kernel (ptxas then keeps every branch at the
//   entry budget), the consumers spill and ptxas serialises every wgmma.
// - Loads: TMA (cp.async.bulk.tensor.4d) over [B, T, H, D] maps built on
//   the host per call (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint: no -lcuda), passed as __grid_constant__. The
//   head is a coordinate, the stride H*D the map's. Boxes of 64 columns
//   (128 bytes, the limit of the 128-byte swizzle) by 128 rows, so a D=128
//   tile is two boxes. Rows past Tq or Tk and columns past D come in as
//   zeros (TMA's out-of-bounds fill); the kpos < Tk and causal masks make
//   the padded keys count for nothing. Q is loaded once; K and V go
//   through a ring of 2 stages, each with "full" (TMA bytes) and "empty"
//   (8 consumer warps) mbarriers for K and for V apart, so the next K
//   lands while this tile's P.V still reads V.
// - Products: S = Q K^T is wgmma m64n128k16 with A (Q) and B (K, K-major)
//   as shared-memory descriptors (128-byte swizzle, 1024-byte stride
//   between 8-row groups). The softmax runs in registers on the f32
//   accumulator (a row's max and sum over the quad of lanes that share
//   it; exp2 with the scale folded into log2(e)), masking only the tiles
//   that cross the diagonal or Tk. P's accumulator layout is wgmma's
//   register A-fragment layout, so P goes to bf16 hi/lo pairs without
//   shuffles, and O += P_hi V + P_lo V is wgmma m64nDk16 with A from
//   registers and B = V from shared memory, MN-major (the transpose bit).
//   A stage is released after wgmma.wait_group, so TMA never overwrites a
//   tile that an in-flight wgmma reads.
// - Epilogue: O / l once, rounded to bf16, stored as bf16 pairs for rows
//   below Tq and columns below D.
// - Shared memory at D=128: Q 32 KB + 2 stages x (K 32 KB + V 32 KB) =
//   160 KB plus barriers (D <= 64: 80 KB). D up to 128 (above it bf16
//   takes the CUDA-core kernel below); the TMA maps need
//   a global stride of a multiple of 16 bytes and 16-byte aligned bases,
//   so the wrapper pads D to a multiple of 8 and copies unaligned inputs.
// - Left for later: ping-pong of the two consumer warpgroups and the
//   softmax overlapped with the next tile's Q K^T (each warpgroup now
//   waits for its own products), a persistent tile scheduler, a TMA store.
//
// f32: 256 threads on CUDA-core FMAs, 32 q rows and 64 keys a step, exact
// f32 (no TF32), for the f32 path and the references that run TF32 off;
// 89 KB of dynamic shared memory at D=128, 172.5 KB at D=256. D may be
// anything up to 256. bf16 with D in (128, 256] takes the same kernel,
// widening q, k and v to f32 as it stages them: a simple route, far from
// the tensor cores' rate (the wgmma kernel's 64-row Q tile and two stages
// of 128-key K and V tiles would need 320 KB of shared memory at D=256).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------- bf16 path
constexpr int kBM = 128;        // q rows per block, 64 per consumer warpgroup
constexpr int kBN = 128;        // keys per tile
constexpr int kStages = 2;      // K/V tiles in the ring
constexpr int kThreads = 384;   // 2 consumer warpgroups + the producer
constexpr int kBox = 64;        // bf16 columns per TMA box: one 128-byte row
constexpr int kRow = 2 * kBox;  // bytes per box row
constexpr int kConsumerWarps = 8;

// Byte offsets in the 1024-aligned dynamic shared memory of one block.
template <int kD>
struct Smem {
  static constexpr int kBoxes = kD / kBox;
  static constexpr int kQ = kBoxes * kBM * kRow;   // the Q tile
  static constexpr int kKV = kBoxes * kBN * kRow;  // one K (or V) tile
  static constexpr int kK = kQ;                    // K stages
  static constexpr int kV = kQ + kStages * kKV;    // V stages
  static constexpr int kBar = kV + kStages * kKV;  // mbarriers
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

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

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one box of a [B, T, H, D] map: columns d0.. of head h, rows t0.. of
// batch b, to shared memory at dst; completion counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h, int t0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h),
      "r"(t0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a tile that TMA wrote with the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units),
// layout 1 (128-byte swizzle). Tiles are 1024-aligned, so the base offset
// is 0 for every start address used here.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register accesses across an async wgmma
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (+)= a * b, m64n128k16: A and B from shared memory, K-major
// (accumulate = 0 overwrites d)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a * b, m64n128k16 (64) or m64n64k16 (32 floats a thread): A from
// registers, B from shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(__grid_constant__ const CUtensorMap map_q,
               __grid_constant__ const CUtensorMap map_k,
               __grid_constant__ const CUtensorMap map_v,
               bf16* __restrict__ o, int Tq, int Tk, int H, int D,
               float scale, int causal) {
  typedef Smem<kD> L;
  extern __shared__ unsigned char smem[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023u) &
      ~1023u;
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV;
  // barriers: full Q; per stage full K, full V, empty K, empty V
  const uint32_t full_q = base + L::kBar;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  int n_tiles = (Tk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBM, Tq) - 1) / kBN + 1);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumerWarps);
      mbar_init(empty_v + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer
  if (role == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(full_q, L::kQ);
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load(sQ + x * kBM * kRow, &map_q, full_q, x * kBox, h, q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        const uint32_t lap = (kt / kStages) & 1;
        mbar_wait(empty_k + 8 * s, lap ^ 1);
        mbar_expect_tx(full_k + 8 * s, L::kKV);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(sK + s * L::kKV + x * kBN * kRow, &map_k, full_k + 8 * s,
                   x * kBox, h, kt * kBN, b);
        mbar_wait(empty_v + 8 * s, lap ^ 1);
        mbar_expect_tx(full_v + 8 * s, L::kKV);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(sV + s * L::kKV + x * kBN * kRow, &map_v, full_v + 8 * s,
                   x * kBox, h, kt * kBN, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = role;  // consumer warpgroup: 0 or 1
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;   // accumulator row (and row + 8)
    const int t4 = lane % 4;  // accumulator column pair
    const int q0w = q0 + 64 * cw;
    const int row0 = q0w + 16 * warp + g;
    const int row1 = row0 + 8;
    const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units

    float acc[kD / 2];  // O, 64 x kD, in wgmma's accumulator layout
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    // m: running row max (log2 units); l: this thread's share of the sum
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

    const uint32_t qa = sQ + cw * 64 * kRow;  // this warpgroup's 64 rows
    mbar_wait(full_q, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % kStages;
      const uint32_t lap = (kt / kStages) & 1;
      const int k0 = kt * kBN;

      // S = Q K^T: 64 x 128, k16 steps over D (4 per 64-column box)
      float sc[kBN / 2];
      const uint32_t ka = sK + s * L::kKV;
      mbar_wait(full_k + 8 * s, lap);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        wgmma_ss_n128(
            sc, sdesc(qa + (ks / 4) * kBM * kRow + (ks % 4) * 32, 16, 1024),
            sdesc(ka + (ks / 4) * kBN * kRow + (ks % 4) * 32, 16, 1024),
            ks > 0);
      wgmma_commit_wait();
      pin(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k + 8 * s);

      // scale, mask (only tiles that cross the diagonal or Tk), and the
      // streaming softmax statistics of rows row0 and row1
      const bool edge = k0 + kBN > Tk || (causal && k0 + kBN - 1 > q0w);
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * sl2;
          if (edge) {
            const int col = k0 + 8 * j + 2 * t4 + (e & 1);
            if (col >= Tk || (causal && col > (e < 2 ? row0 : row1)))
              x = kNeg;
          }
          sc[4 * j + e] = x;
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
      const float a0 = exp2f(m0 - mn0);
      const float a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        sc[4 * j + 0] = exp2f(sc[4 * j + 0] - mn0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn1);
        sum0 += sc[4 * j + 0] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        acc[4 * j + 0] *= a0;
        acc[4 * j + 1] *= a0;
        acc[4 * j + 2] *= a1;
        acc[4 * j + 3] *= a1;
      }
      // P as bf16 high and low A fragments, 16 keys each: the accumulator
      // pairs of two 8-key groups are the fragment, in place
      uint32_t ph[kBN / 16][4], pl[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                pl[kk][r]);

      // O += P_hi V + P_lo V; V is MN-major: 16 keys are 2 groups of 8
      // rows 1024 bytes apart, the two 64-column boxes kBN rows apart
      const uint32_t va = sV + s * L::kKV;
      mbar_wait(full_v + 8 * s, lap);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv = sdesc(va + kk * 16 * kRow, kBN * kRow, 1024);
        wgmma_rs(acc, ph[kk], dv);
        wgmma_rs(acc, pl[kk], dv);
      }
      wgmma_commit_wait();
      pin(acc);
      pin(ph);
      pin(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v + 8 * s);
    }

    // O / l, rounded once; bf16 pairs (D is a multiple of 8)
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, w);
      l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;
    const size_t rs = static_cast<size_t>(H) * D;
    bf16* ob = o + static_cast<size_t>(b) * Tq * rs + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < D) {
        if (row0 < Tq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row0 * rs + col) =
              __floats2bfloat162_rn(acc[4 * j] * inv0,
                                    acc[4 * j + 1] * inv0);
        if (row1 < Tq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row1 * rs + col) =
              __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                    acc[4 * j + 3] * inv1);
      }
    }
  }
}

// ------------------------------------------------------- CUDA-core path
// f32 at every head dim, and bf16 above 128 (where the wgmma kernel's
// tiles do not fit): q, k and v are widened to f32 in shared memory, the
// scores, softmax and P.V are f32 on the CUDA cores, and o is rounded
// once to its type. At kD = 256 a block holds 32 q rows, 64 keys and 64
// values in f32 with P: 172.5 KB of its 227 KB.
constexpr int kFM = 32;         // q rows per block
constexpr int kFN = 64;         // keys per step
constexpr int kFThreads = 256;  // 8 threads a row

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kFThreads)
flash_fwd_cc(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk,
             int H, int D, float scale, int causal) {
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
  const T* qb = q + static_cast<size_t>(b) * Tq * rs + head;
  const T* kb = k + static_cast<size_t>(b) * Tk * rs + head;
  const T* vb = v + static_cast<size_t>(b) * Tk * rs + head;
  T* ob = o + static_cast<size_t>(b) * Tq * rs + head;

  const int tid = threadIdx.x;
  const int r = tid / 8;   // this thread's q row in the tile
  const int c8 = tid % 8;  // its keys c8 + 8j and its columns c8 + 8j
  const int row = q0 + r;

  for (int e = tid; e < kFM * kD; e += kFThreads) {
    const int rr = e / kD, d = e % kD, t = q0 + rr;
    Qs[rr * kLdQ + d] =
        (t < Tq && d < D) ? widen(qb[static_cast<size_t>(t) * rs + d]) : 0.f;
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
      Ks[rr * kLdQ + d] = ok ? widen(kb[at]) : 0.f;
      Vs[rr * kD + d] = ok ? widen(vb[at]) : 0.f;
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
      if (d < D) narrow(&ob[static_cast<size_t>(row) * rs + d], acc[j] * inv);
    }
  }
}

template <typename T, int kD>
int launch_cc(const void* q, const void* k, const void* v, void* o, int B,
              int Tq, int Tk, int H, int D, float scale, int causal,
              cudaStream_t s) {
  constexpr size_t smem =
      (static_cast<size_t>(kFM + kFN) * (kD + 1) + kFN * kD + kFM * (kFN + 1)) *
      sizeof(float);
  static_assert(smem <= 227 * 1024, "a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_cc<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kFM - 1) / kFM, B * H);
  flash_fwd_cc<T, kD><<<grid, kFThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, H, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- launchers
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled through the runtime, so that
// the library links no libcuda; null when that driver lacks it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a TMA map over a contiguous bf16 [B, T, H, D] tensor: boxes of 64
// columns x `rows` tokens of one head, 128-byte swizzle, zeros out of bounds
int tensor_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int D,
               int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * T * H * D};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -5;
}

template <int kD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Tq, int Tk, int H, int D, float scale, int causal,
                cudaStream_t s) {
  if (D % 8 != 0 || ((reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) |
                      reinterpret_cast<uintptr_t>(o)) % 16) != 0)
    return -3;
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, B, Tq, H, D, kBM);
  if (!err) err = tensor_map(&mk, k, B, Tk, H, D, kBN);
  if (!err) err = tensor_map(&mv, v, B, Tk, H, D, kBN);
  if (err) return err;
  const int smem = Smem<kD>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Tq + kBM - 1) / kBM);
  flash_fwd_bf16<kD><<<grid, kThreads, smem, s>>>(
      mq, mk, mv, static_cast<bf16*>(o), Tq, Tk, H, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// q [B, Tq, H, D], k and v [B, Tk, H, D] read, o [B, Tq, H, D] written;
// contiguous, on one device, dtype 0 = f32, 1 = bf16; 1 <= D <= 256,
// Tk >= 1; for bf16 with D <= 128 (the wgmma route) D a multiple of 8 and
// every pointer 16-byte aligned.
// Launches one kernel on `stream` and returns 0 when it was accepted, else
// the reason it was refused: -1 an unknown dtype, -2 D out of range, -3 a
// bf16 D or pointer that TMA cannot address, -4 no cuTensorMapEncodeTiled
// in the CUDA driver, -5 a map it refused, or the launch's CUDA error.
// It does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Tq, int Tk, int H,
                                   int D, float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256) return -2;
  if (dtype == 1) {
    if (D <= 64) return launch_bf16<64>(q, k, v, o, B, Tq, Tk, H, D, scale,
                                        causal, s);
    if (D <= 128) return launch_bf16<128>(q, k, v, o, B, Tq, Tk, H, D, scale,
                                          causal, s);
    return launch_cc<bf16, 256>(q, k, v, o, B, Tq, Tk, H, D, scale, causal,
                                s);
  }
  if (dtype == 0) {
    if (D <= 32) return launch_cc<float, 32>(q, k, v, o, B, Tq, Tk, H, D,
                                             scale, causal, s);
    if (D <= 64) return launch_cc<float, 64>(q, k, v, o, B, Tq, Tk, H, D,
                                             scale, causal, s);
    if (D <= 128) return launch_cc<float, 128>(q, k, v, o, B, Tq, Tk, H, D,
                                               scale, causal, s);
    return launch_cc<float, 256>(q, k, v, o, B, Tq, Tk, H, D, scale, causal,
                                 s);
  }
  return -1;
}

// dynamic shared memory of one bf16 wgmma block for head dim D (1..128)
extern "C" int flash_attention_bf16_smem(int D) {
  return D <= 64 ? Smem<64>::kBytes : Smem<128>::kBytes;
}

extern "C" const char* flash_attention_error_name(int err) {
  if (err == -1) return "unsupported dtype";
  if (err == -2) return "head dim out of range (1..256)";
  if (err == -3) return "bf16 needs D a multiple of 8 and 16-byte aligned "
                        "q, k, v and o for its TMA maps";
  if (err == -4) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err == -5) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
