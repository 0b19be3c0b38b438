// The LSTM forward recurrence for Hopper (sm_90a), shared by K1
// (fused_lstm.cu, inference) and K2 (fused_lstm_train.cu, the training
// forward that keeps its residuals). The counterparts of two TPU kernels of
// mxnet_tpu/ops/pallas_kernels.py: _lstm_kernel (K1) and
// _lstm_fwd_train_kernel (K2). Gate order i, f, g, o; all f32:
//   gates_t = xp_t + h_{t-1} @ Wh      (xp = x @ Wx + b comes from the caller)
//   c_t     = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t     = sigmoid(o) * tanh(c_t)
// K2 (kResiduals) also writes c_t for every step and the four activated
// gates [sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)].
//
// Route 1, lstm_persistent: one cooperative launch a layer. The TPU kernels
// walk t on a sequential grid and keep h, c in VMEM between grid steps. Here
// every block of the grid is resident at once (cudaLaunchCooperativeKernel)
// and walks all T steps, with a grid-wide barrier between steps.
//   - Block p owns the hidden units j0 .. j0+u-1 (j0 = p*u) and all four
//     gate columns of each (j, H+j, 2H+j, 3H+j), so the cell update stays
//     in the block. It loads that 4u x H slice of Wh into shared memory once,
//     before step 0 (u = 5 at H = 650 on 130 blocks: 52 KB), so Wh is read
//     from device memory once a layer and not once per step and row tile.
//   - Each step stages h_{t-1} (a tile of up to 64 rows at a time; all B
//     rows when they fit beside the Wh slice) from the L2 into shared memory:
//     the other blocks wrote it during the step before. h_t is exchanged
//     through `hx`, a (2, B, Hp) double buffer whose rows are padded to
//     Hp = H rounded up to 4, so that each 8-row group of a tile is one
//     contiguous bulk copy (cp.async.bulk, the TMA's 1-D form), issued by one
//     thread with its own mbarrier. A warp waits only for the row group of
//     its item, so the product of the first groups overlaps the copies of
//     the later ones.
//   - A warp's work item is 8 rows x one unit's 4 gate columns: 32 sums kept
//     in registers, each lane taking k in chunks of 4 (lane, lane+32, ...),
//     read as float4 from shared memory (conflict-free: a warp reads 512
//     consecutive bytes). A butterfly of 31 shuffles leaves lane l with the
//     sum of row l/4, gate l%4; the four gate lanes of a row meet by shuffle
//     for the cell update, which writes h_t (to hseq and hx) and c_t. 16
//     warps a block: the loop is bound by shared-memory bandwidth (12
//     16-byte loads per 128 FMAs), and more warps hide its latency.
//   - c_t is kept in device memory, read and written each step by the one
//     thread that owns it (K1: the output c, in place after step 0, which
//     reads c0; K2: cseq). So B has no limit here: large B is walked in row
//     tiles inside a step.
//   - Every sum runs in a fixed order (lane chunks in k order, then the
//     butterfly), so two calls on the same inputs give the same bits.
// What bounds it: a step's product is 2*B*H*4H f32 operations (1.6 us at
// B = 32, H = 650 on the CUDA cores at 67 TFLOP/s), spread over the blocks;
// beside it each block re-reads all of h_{t-1} from the L2 (B*H*4 bytes,
// 83 KB at B = 32, ~11 MB a step across 130 blocks) and passes the barrier.
// On an H100 (700 W) at B = 32 a step takes 8.4 us, of which the product
// loop is 4.1, the barrier 1.4 and the copies left unhidden 1.0
// (mxnet_tpu_torch/tools/lstm_step_breakdown.py cuts each out in turn).
//
// Route 2, lstm_step: one launch per time step, for shapes whose Wh slice
// and a tile of h do not fit a block's shared memory (at 132 SMs, H above
// about 1,200). A block covers 32 hidden units (one per lane) for up to 8
// batch rows; its 8 warps split the reduction over k and meet in shared
// memory for the cell update. Wh is read from the L2 once per 8-row tile and
// step.
//
// The route and its plan (grid, units a block, rows a tile, dynamic shared
// memory) are chosen from the shape alone by the caller
// (mxnet_tpu_torch/ops/lstm_kernel.py::_lstm_route). The host functions
// check the plan and return a CUDA error code instead of launching one the
// card cannot hold; they never switch route.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // route 2: hidden units per block, one per lane
constexpr int kWarps = 8;   // route 2: warps a block
constexpr int kRows = 8;    // batch rows of a route-2 block or a warp's item
constexpr int kThreads = kLanes * kWarps;
static_assert(kWarps == kRows, "the route-2 cell update maps warp w to row w");
static_assert(kRows * 4 == kLanes, "an item's 32 sums end one per lane");
constexpr int kPWarps = 16;  // route 1: warps a block
constexpr int kPThreads = kLanes * kPWarps;
constexpr int kMaxGroups = 8;  // route 1: 8-row groups of a tile (64 rows)

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ---------------------------------------------------------------------------
// Route 2: one step, one launch.
// ---------------------------------------------------------------------------
// K1 passes c_prev == c_t (the output c, updated in place; c0 at t = 0) and
// no gates; each element of c is read and written by one thread.
template <bool kResiduals>
__global__ void __launch_bounds__(kThreads)
lstm_step(const float* __restrict__ xp_t,    // (B, 4H): x@Wx + b
          const float* __restrict__ wh,      // (H, 4H)
          const float* __restrict__ h_prev,  // (B, H)
          const float* c_prev,               // (B, H)
          float* __restrict__ h_t,           // (B, H)
          float* c_t,                        // (B, H)
          float* __restrict__ gates_t,       // (B, 4H), activated (K2)
          int B, int H) {
  __shared__ float partial[kWarps][4][kRows][kLanes];  // 32 KB
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int j = blockIdx.x * kLanes + lane;
  const int b0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - b0);
  const size_t G = 4 * static_cast<size_t>(H);

  float acc[4][kRows];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.0f;
  }

  if (j < H) {
    const float* hb = h_prev + static_cast<size_t>(b0) * H;
    for (int k = warp; k < H; k += kWarps) {
      const float* w = wh + static_cast<size_t>(k) * G + j;
      const float wi = w[0];
      const float wf = w[H];
      const float wg = w[2 * H];
      const float wo = w[3 * H];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float hv = hb[static_cast<size_t>(r) * H + k];
          acc[0][r] = fmaf(hv, wi, acc[0][r]);
          acc[1][r] = fmaf(hv, wf, acc[1][r]);
          acc[2][r] = fmaf(hv, wg, acc[2][r]);
          acc[3][r] = fmaf(hv, wo, acc[3][r]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) partial[warp][g][r][lane] = acc[g][r];
  }
  __syncthreads();

  const int r = warp;  // cell update: warp w finishes row b0 + w
  if (r < rows && j < H) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int g = 0; g < 4; ++g) s[g] += partial[w][g][r][lane];
    }
    const size_t row = static_cast<size_t>(b0 + r);
    const float* x = xp_t + row * G;
    const float gi = sigmoid_f(s[0] + x[j]);
    const float gf = sigmoid_f(s[1] + x[H + j]);
    const float gg = tanhf(s[2] + x[2 * H + j]);
    const float go = sigmoid_f(s[3] + x[3 * H + j]);
    const size_t idx = row * H + j;
    const float cn = gf * c_prev[idx] + gi * gg;
    c_t[idx] = cn;
    h_t[idx] = go * tanhf(cn);
    if (kResiduals) {
      float* gt = gates_t + row * G;
      gt[j] = gi;
      gt[H + j] = gf;
      gt[2 * H + j] = gg;
      gt[3 * H + j] = go;
    }
  }
}

// ---------------------------------------------------------------------------
// Route 1: the whole sequence, one cooperative launch.
// ---------------------------------------------------------------------------
// One level of a warp's butterfly reduction of 32 sums: a lane keeps the
// half of acc[0 .. 2S) selected by bit S of its lane id, adds its partner's
// copy of that half, and stores the result in acc[0 .. S).
template <int S>
__device__ __forceinline__ void fold(float (&acc)[kRows * 4], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int a = 0; a < S; ++a) {
    const float send = upper ? acc[a] : acc[a + S];
    const float keep = upper ? acc[a + S] : acc[a];
    acc[a] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// `cout` is K1's c (B, H) or K2's cseq (T, B, H); `gates` (T, B, 4H) is
// K2's and null for K1; `hx` (2, B, Hp) is scratch, any contents.
// Waits for the completion of the mbarrier phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

template <bool kResiduals>
__global__ void __launch_bounds__(kPThreads, 1)
lstm_persistent(const float* __restrict__ xp,  // (T, B, 4H)
                const float* __restrict__ wh,  // (H, 4H)
                const float* __restrict__ h0,  // (B, H)
                const float* __restrict__ c0,  // (B, H)
                float* hseq,                   // (T, B, H)
                float* cout, float* gates, float* hx, int T, int B, int H,
                int units, int tile_rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[kMaxGroups];  // one per row group
  const int Hp = (H + 3) & ~3;
  const int nchunk = Hp / 4;
  const int cols = 4 * units;
  const int j0 = blockIdx.x * units;
  const int uu = min(units, H - j0);  // this block's units
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t BH = static_cast<size_t>(B) * H;
  const size_t BHp = static_cast<size_t>(B) * Hp;
  float* w_s = smem;                 // (4u, Hp): column g*u + jj, k fastest
  float* h_s = smem + cols * Hp;     // (tile_rows <= 64, Hp)

  // Prologue: the block's Wh slice (consecutive threads walk the gate
  // columns of one row k of Wh), zero pads in w_s, h_s and both hx buffers.
  for (int i = tid; i < Hp * cols; i += kPThreads) {
    const int k = i / cols;
    const int col = i - k * cols;
    const int g = col / units;
    const int jj = col - g * units;
    const size_t src = static_cast<size_t>(k) * G +
                       static_cast<size_t>(g) * H + j0 + jj;
    w_s[col * Hp + k] = k < H && jj < uu ? wh[src] : 0.0f;
  }
  for (int i = tid; i < tile_rows * Hp; i += kPThreads) h_s[i] = 0.0f;
  const int pad = Hp - H;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kPThreads + tid;
       i < 2 * static_cast<size_t>(B) * pad;
       i += static_cast<size_t>(gridDim.x) * kPThreads) {
    const size_t row = i / pad;
    hx[row * Hp + H + (i - row * pad)] = 0.0f;
  }
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  if (tid == 0) {
    for (int q = 0; q < kMaxGroups; ++q) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(bar0 + 8 * q), "r"(1u) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // step 0 stages h0 over the zeroed h_s

  const uint32_t h_s_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(h_s));
  uint32_t phases = 0;     // bit q: the parity of row group q's next phase
  const int r = lane / 4;  // after the butterfly: row r, gate g of the item
  const int g = lane % 4;
  for (int t = 0; t < T; ++t) {
    const float* xp_t = xp + static_cast<size_t>(t) * B * G;
    const float* hx_prev = hx + static_cast<size_t>((t + 1) & 1) * BHp;
    float* hx_t = hx + static_cast<size_t>(t & 1) * BHp;
    float* h_t = hseq + static_cast<size_t>(t) * BH;
    const float* c_prev = t == 0 ? c0
        : kResiduals ? cout + static_cast<size_t>(t - 1) * BH : cout;
    float* c_t = kResiduals ? cout + static_cast<size_t>(t) * BH : cout;
    float* g_t = kResiduals ? gates + static_cast<size_t>(t) * B * G : gates;

    for (int r0 = 0; r0 < B; r0 += tile_rows) {
      const int rows = min(tile_rows, B - r0);
      const int groups = (rows + kRows - 1) / kRows;
      if (t == 0) {  // h0 is (B, H), unpadded: every thread copies
        for (int i = tid; i < rows * H; i += kPThreads) {
          const int rr = i / H;
          const int k = i - rr * H;
          h_s[rr * Hp + k] = h0[static_cast<size_t>(r0 + rr) * H + k];
        }
        __syncthreads();
      } else if (tid == 0) {  // one bulk copy per 8-row group of hx_prev
        // order the generic accesses before (other blocks' writes of hx,
        // this block's of h_s) before the async proxy's copies
        asm volatile("fence.proxy.async;\n" ::: "memory");
        for (int q = 0; q < groups; ++q) {
          const uint32_t bytes = 16u * min(kRows, rows - q * kRows) * nchunk;
          const uint32_t bar = bar0 + 8 * q;
          const float* src = hx_prev + (static_cast<size_t>(r0) +
                                        q * kRows) * Hp;
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
              :: "r"(bar), "r"(bytes) : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
              "::bytes [%0], [%1], %2, [%3];\n"
              :: "r"(h_s_addr + 16u * q * kRows * nchunk), "l"(src),
                 "r"(bytes), "r"(bar)
              : "memory");
        }
      }

      const int items = groups * uu;
      for (int item = warp; item < items; item += kPWarps) {
        const int rg = item / uu;
        const int jj = item - rg * uu;
        const int j = j0 + jj;
        const int nr = min(kRows, rows - rg * kRows);
        const bool live = r < nr;
        const size_t b = static_cast<size_t>(r0 + rg * kRows + r);
        // issued before the product, used after it
        const float x = live ? xp_t[b * G + static_cast<size_t>(g) * H + j]
                             : 0.0f;
        const float cp = live && g == 0 ? c_prev[b * H + j] : 0.0f;
        if (t > 0) mbar_wait(bar0 + 8 * rg, (phases >> rg) & 1u);

        float acc[kRows * 4];
#pragma unroll
        for (int a = 0; a < kRows * 4; ++a) acc[a] = 0.0f;
        const float4* hrow = reinterpret_cast<const float4*>(h_s) +
                             static_cast<size_t>(rg) * kRows * nchunk;
        const float4* w4 = reinterpret_cast<const float4*>(w_s);
        for (int c = lane; c < nchunk; c += kLanes) {
          float4 w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) w[q] = w4[(q * units + jj) * nchunk + c];
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            const float4 hv = rr < nr ? hrow[rr * nchunk + c]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float s = acc[rr * 4 + q];
              s = fmaf(hv.x, w[q].x, s);
              s = fmaf(hv.y, w[q].y, s);
              s = fmaf(hv.z, w[q].z, s);
              acc[rr * 4 + q] = fmaf(hv.w, w[q].w, s);
            }
          }
        }
        // lane l ends with the whole sum of acc index l = 4*row + gate
        fold<16>(acc, lane);
        fold<8>(acc, lane);
        fold<4>(acc, lane);
        fold<2>(acc, lane);
        fold<1>(acc, lane);
        const float pre = acc[0] + x;
        const float act = g == 2 ? tanhf(pre) : sigmoid_f(pre);
        if (kResiduals && live) {
          g_t[b * G + static_cast<size_t>(g) * H + j] = act;
        }
        const int base = lane & ~3;
        const float gi = __shfl_sync(0xffffffffu, act, base);
        const float gf = __shfl_sync(0xffffffffu, act, base + 1);
        const float gg = __shfl_sync(0xffffffffu, act, base + 2);
        const float go = __shfl_sync(0xffffffffu, act, base + 3);
        if (live && g == 0) {
          const float cn = gf * cp + gi * gg;
          const float hn = go * tanhf(cn);
          c_t[b * H + j] = cn;
          h_t[b * H + j] = hn;
          hx_t[b * Hp + j] = hn;
        }
      }
      if (t > 0) phases ^= (1u << groups) - 1u;
      __syncthreads();  // the next tile overwrites h_s
    }
    if (t + 1 < T) cooperative_groups::this_grid().sync();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
// The current device's SM count and the shared memory a block may opt in to.
inline int lstm_device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return static_cast<int>(err);
}

// Runs the T-step recurrence on `stream` by the route `persistent` names,
// with the caller's plan (grid, units, tile_rows, smem) for route 1.
// Returns the first CUDA error (0 when every launch was accepted): a plan
// that does not cover H, shared memory short of what the plan needs, or a
// grid the card cannot hold at once is refused before any launch. It does
// not synchronise.
template <bool kResiduals>
int lstm_forward(const float* xp, const float* wh, const float* h0,
                 const float* c0, float* hseq, float* cout, float* gates,
                 float* hx, int T, int B, int H, int persistent, int grid,
                 int units, int tile_rows, int smem, cudaStream_t stream) {
  const size_t BH = static_cast<size_t>(B) * H;
  if (!persistent) {
    const dim3 blocks((H + kLanes - 1) / kLanes, (B + kRows - 1) / kRows);
    for (int t = 0; t < T; ++t) {
      const size_t off = static_cast<size_t>(t) * BH;
      const float* hp = t == 0 ? h0 : hseq + off - BH;
      const float* cp = t == 0 ? c0 : kResiduals ? cout + off - BH : cout;
      lstm_step<kResiduals><<<blocks, kThreads, 0, stream>>>(
          xp + 4 * off, wh, hp, cp, hseq + off,
          kResiduals ? cout + off : cout,
          kResiduals ? gates + 4 * off : gates, B, H);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
  }
  const int Hp = (H + 3) & ~3;
  const size_t need = sizeof(float) * static_cast<size_t>(Hp) *
                      (4 * static_cast<size_t>(units) + tile_rows);
  if (grid < 1 || units < 1 || tile_rows < 1 ||
      tile_rows > kMaxGroups * kRows ||
      static_cast<long long>(grid) * units < H ||
      static_cast<long long>(grid - 1) * units >= H ||
      static_cast<size_t>(smem) < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = (const void*)lstm_persistent<kResiduals>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 0, smem_optin = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = static_cast<cudaError_t>(lstm_device_limits(&sms, &smem_optin));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kPThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid > per_sm * sms) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  void* args[] = {&xp, &wh, &h0, &c0, &hseq, &cout, &gates, &hx,
                  &T, &B, &H, &units, &tile_rows};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kPThreads),
                                    args, static_cast<size_t>(smem), stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace
