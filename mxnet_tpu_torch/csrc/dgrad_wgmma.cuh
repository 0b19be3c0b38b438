// The bf16 route of K5 (conv1x1_s2_dgrad) for Hopper (sm_90a): a persistent
// TMA + wgmma kernel. Included by conv1x1_s2_dgrad.cu, which holds the C
// entry point and the two other routes (WMMA for bf16 shapes TMA cannot
// address, CUDA cores for f32).
//
// What it computes. dy (M = N*Ho*Wo rows, K) and w2 (K, C) give
// dx (N, 2Ho, 2Wo, C) with dx[:, ::2, ::2] = dy @ w2 (f32 accumulation,
// rounded once to bf16) and exact zeros everywhere else: the TPU kernel
// mxnet_tpu/ops/conv_kernels.py::conv1x1_s2_dgrad (_kern). Every element of
// dx is written once, zeros included, with no memset: the bytes moved are
// read(dy) + read(w2) + write(dx), as on the TPU.
//
// Shape of the work. The product is cut into tiles of 128 rows of M by BN
// columns of C (BN = 128 or 256, chosen by the wrapper from the shape).
// Tiles are numbered row tile by row tile, the C / BN column tiles of one
// row tile consecutive, and block b of the persistent grid (at most one a
// SM) takes tiles b, b + grid, ...: the blocks that share a row tile of dy
// run at the same time, so it comes from HBM once and from the L2 for the
// others, and w2 (at most 4 MB) stays in the L2 throughout.
//
// A block is 384 threads in three warpgroups.
// - Warpgroups 0 and 1 consume: 64 rows of the tile each, on wgmma
//   m64nBNk16 with both operands in shared memory. They rise to 232
//   registers (setmaxnreg); a thread holds BN / 2 f32 accumulators.
// - Warpgroup 2 drops to 40 registers. Its first warp's lane 0 is the
//   producer: it walks the block's tiles and their depth in steps of 64,
//   keeping a ring of stages full by TMA (one dy box of 64 columns by 128
//   rows, and BN / 64 w2 boxes of 64 columns by 64 rows, the 128-byte
//   swizzle), each stage with a full and an empty mbarrier, running ahead
//   across tile boundaries so that a tile's epilogue overlaps the next
//   tile's loads. Its other three warps write the zeros of dx, which do
//   not depend on the product, while the consumers multiply: for product
//   row m = (n, ho, wo) and the tile's columns, warp 1 the BN zeros at
//   (2ho, 2wo + 1), warps 2 and 3 the 2 BN at (2ho + 1, 2wo .. 2wo + 1).
//   They start a tile's zeros once the consumers have started the tile
//   (a tile count in shared memory), so that the zeros, 3/4 of dx, spread
//   over the call instead of crowding dy's loads at its start.
// - Operands: dy is K-major, read as it lies. w2 (K, C) is MN-major: its
//   B descriptor sets wgmma's transpose bit, advances 16 k rows (2048
//   bytes) a k16 step, 8 rows apart by 1024 bytes, and the 64-column
//   boxes 8192 bytes apart. No transposed copy of w2 is made.
// - Epilogue: the accumulators are rounded to bf16 and staged in shared
//   memory (rows padded by 16 bytes: no bank conflicts), then each warp
//   stores whole rows of the tile, 16 bytes a thread: BN * 2 contiguous
//   bytes of dx at (2ho, 2wo) a row. dx[n, 2ho, 2wo] sits at
//   2C (m + (m / Wo) Wo), so a thread walks its rows with one division a
//   tile, not one a row. Every store of dx is marked streaming (evict
//   first): dx, up to 4x the L2, is not read back, dy's row tile and w2
//   are.
// - Edges: TMA fills rows past M, and columns and depth past C and K, with
//   zeros; w2 boxes wholly past C are not loaded (their columns are not
//   stored). Stores are masked to m < M and c < C. K and C are multiples
//   of 8 (TMA's 16-byte strides) and dy, w2 and dx 16-byte aligned: the
//   wrapper routes other shapes to the WMMA kernel.
// - Memory order: the ring is written only by TMA and read only by wgmma
//   (the async proxy, ordered by the mbarriers); the staging buffer only
//   by the consumers' own generic loads and stores, behind named barriers.
//   The tile count orders nothing: it only delays the zero writers.
// - Shared memory: BN = 256, 3 stages of 48 KB and 66 KB of staging
//   (216,128 bytes); BN = 128, 5 stages of 32 KB and 34 KB of staging
//   (199,776 bytes).
//
// What bounds it. dx is four times the product: at ResNet-50's six
// stride-2 sites (batch 128, bf16) the bytes take 18-92 us at 3.35 TB/s
// and the operations (26.3 GFLOP at the downsample sites) 6.7-26.6 us at
// 989 TFLOP/s; only stage 4's downsample (K = 2048) is bound by its
// operations. Measured (mxnet_tpu_torch/tools/k5_breakdown.py, H100 80GB
// HBM3 at 700 W): the five bytes-bound sites at 69-85% of their bound,
// near what this card reaches on a stream that mixes reads and writes
// (dx.zero_() alone writes at 3.2 TB/s); the zeros are what the time
// waits for there (stage 2's downsample: 0.115 ms as built, 0.065
// without the zeros, 0.052 with the ring alone). Stage 4's downsample
// runs at 54% of its operations' bound: its 128-column tiles reread dy
// and w2 from the L2 at about 14 TB/s (0.029 ms for the ring alone, 0.039
// with the products, 0.049 with the stores), and 256-column tiles, which
// would halve that, leave 196 tiles for 132 SMs.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace k5 {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;       // product rows a tile, 64 a consumer warpgroup
constexpr int kBK = 64;        // depth a stage: one 128-byte row of bf16
constexpr int kBox = 64;       // bf16 columns of a TMA box (128 bytes)
constexpr int kRow = 128;      // bytes of a box row
constexpr int kThreads = 384;  // 2 consumer warpgroups + warpgroup 2
constexpr int kConsumerWarps = 8;

// Byte offsets in the 1024-aligned dynamic shared memory of one block.
template <int BN>
struct Layout {
  static constexpr int kStages = BN == 256 ? 3 : 5;
  static constexpr int kA = kBM * kRow;       // the dy box of a stage
  static constexpr int kBBox = kBK * kRow;    // one w2 box: 64 rows of k
  static constexpr int kStage = kA + (BN / kBox) * kBBox;
  static constexpr int kLd = BN + 8;          // staging row, bf16
  static constexpr int kStaging = kStages * kStage;
  static constexpr int kBar = kStaging + kBM * kLd * 2;
  static constexpr int kProgress = kBar + 16 * kStages;  // an int
  static constexpr int kBytes = kProgress + 16 + 1024;
};

// position of dx[n, 2ho, 2wo, 0] for product row m = (n, ho, wo): the
// image rows q = n Ho + ho follow each other across images, so it is
// 2C (2 q Wo + wo) = 2C (m + q Wo), with q = m / Wo
__device__ __forceinline__ size_t dx_row(int m, int Wo, int C) {
  return 2 * static_cast<size_t>(C) *
         (m + static_cast<size_t>(m / Wo) * Wo);
}

// dx_row of the product rows m, m + step, m + 2 step, ... without a
// division a row
struct RowWalk {
  size_t p;  // dx_row(m)
  int wo;    // m's column, m % Wo
  __device__ __forceinline__ RowWalk(int m, int Wo, int C)
      : p(dx_row(m, Wo, C)), wo(m % Wo) {}
  __device__ __forceinline__ void next(int step, int Wo, int C) {
    wo += step;
    p += 2 * static_cast<size_t>(C) * step;
    while (wo >= Wo) {  // into the next image row: skip the odd dx row
      wo -= Wo;
      p += 2 * static_cast<size_t>(Wo) * C;
    }
  }
};

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

// one box of a 2-D map at (column x, row y) to shared memory at dst;
// completion counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma shared-memory descriptor of a tile that TMA wrote with the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units),
// layout 1 (128-byte swizzle). Every start address used here is 1024-aligned
// or 32 bytes into a 1024-aligned row group, so the base offset is 0.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register accesses across an async wgmma
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a barrier of one consumer warpgroup's 128 threads
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// 16 bytes of dx, marked as streaming (evict first): dx is written once
// and not read back here, and is up to 4x the L2, where dy's row tile and
// w2 are reread
__device__ __forceinline__ void store16(bf16* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// one arrival of this warp on an empty barrier
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// d (+)= a * b, m64n128k16: A (K-major) and B (MN-major, the transpose
// bit) from shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_tn(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

// d (+)= a * b, m64n256k16: A (K-major) and B (MN-major, the transpose
// bit) from shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_tn(float (&d)[128], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
dgrad_wgmma(__grid_constant__ const CUtensorMap map_dy,
            __grid_constant__ const CUtensorMap map_w2,
            bf16* __restrict__ dx, int M, int K, int C, int Wo,
            int col_tiles, int tiles) {
  typedef Layout<BN> L;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * L::kStages;
  // the consumers' tile count, which paces the zero writers
  volatile int* progress =
      reinterpret_cast<volatile int*>(smem + (base - raw) + L::kProgress);
  const int ksteps = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *progress = 0;
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8) {
      // ------------------------------------------------------------ producer
      if (lane == 0) {
        int it = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const int m0 = (t / col_tiles) * kBM;
          const int c0 = (t % col_tiles) * BN;
          // w2 boxes with a column below C; the others are not stored
          const int boxes = min(BN / kBox, (C - c0 + kBox - 1) / kBox);
          const uint32_t bytes = L::kA + boxes * L::kBBox;
          for (int kt = 0; kt < ksteps; ++kt, ++it) {
            const int s = it % L::kStages;
            mbar_wait(empty + 8 * s, ((it / L::kStages) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, bytes);
            const uint32_t st = base + s * L::kStage;
            tma_load(st, &map_dy, full + 8 * s, kt * kBK, m0);
            for (int x = 0; x < boxes; ++x)
              tma_load(st + L::kA + x * L::kBBox, &map_w2, full + 8 * s,
                       c0 + x * kBox, kt * kBK);
          }
        }
      }
    } else {
      // -------------------------------------------------------- zero writers
      // warp 9: (2ho, 2wo + 1); warp 10: (2ho + 1, 2wo); warp 11:
      // (2ho + 1, 2wo + 1); BN columns each, 16 bytes a lane
      const size_t row2 = 2 * static_cast<size_t>(Wo) * C;  // a dx row
      const size_t off = warp == 9 ? C : (warp == 10 ? row2 : row2 + C);
      constexpr int kLanes = BN / 8;        // lanes a run: 16 or 32
      constexpr int kRuns = 32 / kLanes;    // runs a warp stores at once
      const int c = (lane % kLanes) * 8;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      int n = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        // a tile's zeros while the consumers work on it, not all at once:
        // spread over the call, they share the memory with dy's loads
        ++n;
        while (*progress < n) __nanosleep(128);
        const int m0 = (t / col_tiles) * kBM;
        const int c0 = (t % col_tiles) * BN;
        if (c0 + c >= C) continue;
        const int rows = min(kBM, M - m0);
        RowWalk row(m0 + lane / kLanes, Wo, C);
        for (int r = lane / kLanes; r < rows;
             r += kRuns, row.next(kRuns, Wo, C))
          store16(dx + row.p + off + c0 + c, zero);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = warp / 4;  // consumer warpgroup: rows 64 cw .. 64 cw + 63
    const int r0 = 16 * (warp % 4) + lane / 4;  // accumulator rows r0, r0 + 8
    const int t4 = lane % 4;                    // accumulator column pair
    const int tid = threadIdx.x % 128;
    bf16* stage = reinterpret_cast<bf16*>(smem + (base - raw) + L::kStaging) +
                  cw * 64 * L::kLd;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    int it = 0, n = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      ++n;
      if (threadIdx.x == 0) *progress = n;
      const int m0 = (t / col_tiles) * kBM + 64 * cw;
      const int c0 = (t % col_tiles) * BN;
      for (int kt = 0; kt < ksteps; ++kt, ++it) {
        const int s = it % L::kStages;
        mbar_wait(full + 8 * s, (it / L::kStages) & 1);
        const uint32_t a = base + s * L::kStage + cw * 64 * kRow;
        const uint32_t b = base + s * L::kStage + L::kA;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          wgmma_tn(acc, sdesc(a + ks * 32, 16, 1024),
                   sdesc(b + ks * 16 * kRow, L::kBBox, 1024),
                   kt > 0 || ks > 0);
        wgmma_commit();
        if (kt > 0) {  // the previous stage's products are done: free it
          wgmma_wait<1>();
          release(empty + 8 * ((it - 1) % L::kStages));
        }
      }
      wgmma_wait<0>();
      pin(acc);
      release(empty + 8 * ((it - 1) % L::kStages));

      // the tile's 64 rows to bf16 in shared memory, then whole rows out
      warpgroup_sync(1 + cw);  // the previous tile's rows are stored
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(stage + r0 * L::kLd + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8) * L::kLd + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
      warpgroup_sync(1 + cw);
      constexpr int kChunks = BN / 8;        // 16-byte chunks of a row
      constexpr int kStep = 128 / kChunks;   // rows from one of a thread's
                                             // rows to its next
      const int c = (tid % kChunks) * 8;
      RowWalk row(m0 + tid / kChunks, Wo, C);
      for (int r = tid / kChunks; r < 64; r += kStep, row.next(kStep, Wo, C))
        if (m0 + r < M && c0 + c < C)
          store16(dx + row.p + c0 + c,
                  *reinterpret_cast<const uint4*>(stage + r * L::kLd + c));
    }
  }
}

// ----------------------------------------------------------------- launcher
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled through the runtime, so that
// the library links no libcuda; null when that driver lacks it
inline EncodeTiled encode_tiled() {
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

// a TMA map over a contiguous bf16 (rows, cols) matrix: boxes of 64
// columns by box_rows rows, 128-byte swizzle, zeros out of bounds;
// 0, -4 (no encoder in the driver) or -5 (a map it refused)
inline int tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                      int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {2ull * cols};
  const cuuint32_t box[2] = {kBox, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -5;
}

// one launch of the persistent kernel on `grid` blocks (1 <= grid <= the
// tiles) with `smem` bytes a block, which must be Layout<BN>'s: -6 for a
// plan the kernel is not built for
template <int BN>
int launch(const void* dy, const void* w2, void* dx, int M, int K, int C,
           int Wo, int stages, int grid, int smem, cudaStream_t s) {
  const int col_tiles = (C + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * col_tiles;
  if (stages != Layout<BN>::kStages || smem != Layout<BN>::kBytes ||
      grid < 1 || grid > tiles)
    return -6;
  CUtensorMap map_dy, map_w2;
  int err = tensor_map(&map_dy, dy, M, K, kBM);
  if (!err) err = tensor_map(&map_w2, w2, K, C, kBK);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      dgrad_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dgrad_wgmma<BN><<<grid, kThreads, smem, s>>>(
      map_dy, map_w2, static_cast<bf16*>(dx), M, K, C, Wo, col_tiles, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k5
