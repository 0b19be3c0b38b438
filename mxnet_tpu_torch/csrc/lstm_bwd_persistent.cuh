// K3's persistent route for Hopper (sm_90a): the reverse-time recurrence of
// the LSTM backward as one cooperative launch a layer, the counterpart of
// _lstm_bwd_kernel in mxnet_tpu/ops/pallas_kernels.py (called from
// _lstm_vjp_bwd). Gate order i, f, g, o; gates are post-activation; f32:
//   dh       = dhseq_t + dh_carry            (dh_carry = dh_n at t = T-1)
//   do       = dh * tanh(c_t)
//   dc       = dc_carry + dh * o * (1 - tanh(c_t)^2)   (dc_carry = dc_n first)
//   dgates_t = [dc*g * i(1-i), dc*c_{t-1} * f(1-f), dc*i * (1-g^2), do * o(1-o)]
//   dh_carry = dgates_t @ Wh^T,   dc_carry = dc * f
// and dh0 = the last dh_carry, dc0 = the last dc_carry.
//
// It is K1's design (lstm_persistent.cuh) run in reverse time. The TPU
// kernel walks t on a sequential grid with dh and dc in VMEM scratch; here
// every block of the grid is resident at once (cudaLaunchCooperativeKernel)
// and walks all T steps, with a grid-wide barrier between steps: one launch
// a layer, where the per-step route makes T + 1.
//   - Block p owns the hidden units j0 .. j0+U-1 (j0 = p*U; U = 5 at
//     H = 650 on 130 blocks). Its elementwise part needs, for unit j, only
//     dh_carry[b, j] and column j of each gate, and produces the four
//     columns g*H + j of dgates_t. dc[b, j] is read and written in place in
//     the output dc by the one thread that owns it.
//   - Before step T-1 the block loads the rows of Wh^T that multiply its
//     own dgates columns (Wh[j', g*H + j] for every j', 4U x H, 52 KB at
//     H = 650) into shared memory, once a layer; Wh is read through its
//     strides, so neither layout of Wh is copied.
//   - A step: (1) stage the slab, every writer's partials for this block's
//     units (grid x B x U floats, 83 KB at B = 32), with 16-byte cp.async
//     copies through the L2 (the step's other inputs load meanwhile);
//     (2) sum the writers in writer order, four threads a carry; (3) the
//     elementwise part, dgates_t to the output and to shared memory;
//     (4) the partial product P_p[b, j'] = sum over the block's 4U columns
//     k of dgates_t[b, k] * Wh[j', k], for every unit j' of every owner,
//     one thread an (owner, 8-row group), staged in the slab's shared
//     memory; (5) the staged partials to the exchange buffer `xbuf` with
//     plain float4 stores, each warp writing 512 consecutive bytes;
//     (6) the grid barrier. One more (1)-(2) after step 0 gives dh0.
//   - `xbuf` is laid out (2, owner, writer, 8-row group, 8 rows, U): a
//     writer's part for an owner is contiguous, and so is a tile's rows of
//     it. It is double buffered by step parity, so one barrier a step
//     suffices: a block writes buffer s%2 in step s, and every owner had
//     read that buffer before the barrier that ended step s-1.
//   - Where the slab of all B rows does not fit beside the Wh slice, a step
//     walks the batch in row tiles of whole 8-row groups (64 rows at
//     H = 650).
// Where trouble lies, and what the design does about it:
//   - Memory order: xbuf is written with generic stores and read with
//     cp.async.cg, both in the generic proxy, so the grid barrier alone
//     orders them; TMA bulk copies would need a fence.proxy.async after
//     every barrier, which cost more than the copies (PERF.md §6). The
//     copies bypass the L1, which may hold a line of this buffer from two
//     steps before.
//   - The exchange: the partials a step moves through the L2, B*H*grid
//     floats each way, set the design's floor. They are staged so that
//     each warp stores 512 consecutive bytes: a thread's own 16-byte
//     stores to 130 places, or one TMA bulk store an owner, were several
//     times slower (PERF.md §6).
//   - Residency: every block must be resident (at most one a SM), with its
//     dynamic shared memory opted in; the host side checks the plan and the
//     occupancy and returns an error instead of launching.
//   - Determinism: each partial sums its 4U columns in order, and each
//     carry sums its writers in four interleaved chains combined in a fixed
//     order, so two calls on the same inputs give the same bits.
// What bounds it: a step is 2*B*H*4H f32 operations (1.6 us at B = 32,
// H = 650 on the CUDA cores at 67 TFLOP/s) spread over the blocks; beside
// them every block writes B*H partials and reads as many, 10.8 MB each way
// across the grid a step at B = 32, and passes the barrier. On an H100
// (700 W) a step at B = 32 takes 11.5 us, of which the stores of the
// partials are 2.9, the product loop 2.9, the barrier 2.7, the slab's copy
// 1.7 and the writer sums 0.6 (mxnet_tpu_torch/tools/lstm_step_breakdown.py
// cuts each out in turn; the barrier also waits for the stores to land).
// The plan (grid, units, rows a tile, dynamic shared memory) is chosen from
// the shape alone by mxnet_tpu_torch/ops/lstm_kernel.py::_lstm_bwd_route.
// Where the Wh slice and one row group do not fit, the caller takes the
// per-step route of fused_lstm_train.cu instead; this file never does.
#pragma once

#include "lstm_persistent.cuh"

namespace {

constexpr int kBwdMaxUnits = 9;  // instantiations of lstm_bwd_persistent<U>

// threads a block: 17 warps, so that the product's items, one owner's
// 8-row group each, take whole rounds at H = 650 (130 owners): the 520 at
// B = 32 one round, not two of 512
constexpr int kBwdThreads = 544;
constexpr int kStagePad = 4;  // floats after an owner's staged partials
constexpr int kGroupPad = 4;  // floats after each group's dgates
constexpr int kSumParts = 4;  // threads that share one writer sum, in
                              // different warps (see step 2)

// Floats of one owner's rows in the Wh slice: U units x 4U columns, and 4
// more for an even U, so that owners lie an odd multiple of 16 bytes apart
// modulo 128 and the float4 loads of 8 consecutive owners meet no bank
// twice (for an odd U, 16U^2 is already such a multiple).
__host__ __device__ constexpr int wh_stride(int units) {
  return 4 * units * units + (units % 2 ? 0 : 4);
}

// Bytes of dynamic shared memory the persistent backward needs: the Wh
// slice (grid owners x wh_stride(U) floats); the slab of a tile (grid
// writers x tile_rows x U, rows rounded up to 8), which then holds the
// block's staged partials (kStagePad more floats an owner); and, for each
// 8-row group, its dgates (4U x 8 rows and kGroupPad) and the kSumParts
// partial sums of its carries (8 x U each).
inline size_t lstm_bwd_smem(int grid, int units, int tile_rows) {
  const size_t groups = (tile_rows + kRows - 1) / kRows;
  const size_t slot = static_cast<size_t>(kRows) * units;
  return sizeof(float) *
         (static_cast<size_t>(grid) * wh_stride(units) +
          static_cast<size_t>(grid) * (groups * slot + kStagePad) +
          groups * (4 * slot + kGroupPad + kSumParts * slot));
}

// One (row, unit)'s inputs of a step, which do not depend on the carry:
// dhseq_t, the activated gates, c_t, c_{t-1} and dc_carry.
struct StepInputs {
  float dho, gi, gf, gg, go, ct, cp, dc;
};

template <int U>
__global__ void __launch_bounds__(kBwdThreads, 1)
lstm_bwd_persistent(const float* __restrict__ dhseq,  // (T, B, H)
                    const float* __restrict__ dhn,    // (B, H)
                    const float* __restrict__ gates,  // (T, B, 4H)
                    const float* __restrict__ cseq,   // (T, B, H)
                    const float* __restrict__ c0,     // (B, H)
                    const float* __restrict__ wh,     // (H, 4H), strided
                    float* dc,                        // (B, H), in place
                    float* __restrict__ dgates,       // (T, B, 4H)
                    float* __restrict__ dh0,          // (B, H)
                    float* xbuf,  // (2, grid, grid, ceil(B/8), 8, U)
                    int T, int B, int H, long long ws0, long long ws1,
                    int tile_rows) {
  constexpr int K = 4 * U;         // the block's own dgates columns
  constexpr int WO = wh_stride(U);  // an owner's floats of w_s
  constexpr int SLOT = kRows * U;  // a row group's floats of one writer
  constexpr int DGS = K * kRows + kGroupPad;  // a group's dgates, padded
  extern __shared__ __align__(16) float smem[];
  const int W = gridDim.x;  // owners, and writers
  const int j0 = blockIdx.x * U;
  const int uu = min(U, H - j0);  // this block's units
  const int tid = threadIdx.x;
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t BH = static_cast<size_t>(B) * H;
  // xbuf: a writer's part for one owner (all rows), an owner's (all
  // writers), one buffer
  const size_t wslab = static_cast<size_t>((B + kRows - 1) / kRows) * SLOT;
  const size_t oslab = static_cast<size_t>(W) * wslab;
  const size_t xhalf = static_cast<size_t>(W) * oslab;
  const int max_groups = (tile_rows + kRows - 1) / kRows;
  float* w_s = smem;                 // (W, WO): owner, unit, column
  float* slab_s = w_s + W * WO;      // (W, tile's groups * SLOT), then the
                                     // staged partials (W, ost)
  float* dg_s = slab_s + W * (max_groups * SLOT + kStagePad);  // (g, DGS)
  float* part_s = dg_s + max_groups * DGS;  // (kSumParts, groups * SLOT)

  // Prologue: w_s[o][jj][k] = Wh[j', g*H + j0 + kk] for the unit
  // j' = o*U + jj of owner o and own column k = g*U + kk; zero where j' or
  // j0 + kk is past H. Zero dg_s: a tile's rows past B are never written.
  for (int i = tid; i < W * U * K; i += kBwdThreads) {
    const int jp = i / K;
    const int k = i - jp * K;
    const int g = k / U;
    const int kk = k - g * U;
    const int o = jp / U;
    w_s[o * WO + (jp - o * U) * K + k] =
        jp < H && kk < uu
            ? wh[jp * ws0 + (static_cast<long long>(g) * H + j0 + kk) * ws1]
            : 0.0f;
  }
  for (int i = tid; i < max_groups * DGS; i += kBwdThreads) dg_s[i] = 0.0f;
  __syncthreads();

  const uint32_t slab_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(slab_s));
  for (int s = 0; s <= T; ++s) {
    const int t = T - 1 - s;  // t = -1: the pass that reduces dh0
    // this owner's part of the buffer written in step s - 1; and the
    // buffer of step s
    const float* x_in = xbuf + static_cast<size_t>((s + 1) & 1) * xhalf +
                        blockIdx.x * oslab;
    float* x_out = xbuf + static_cast<size_t>(s & 1) * xhalf;
    const size_t off = static_cast<size_t>(t) * BH;
    for (int r0 = 0; r0 < B; r0 += tile_rows) {
      const int groups = (min(tile_rows, B - r0) + kRows - 1) / kRows;
      const int g0 = r0 / kRows;
      const int tslab = groups * SLOT;  // a writer's floats of the tile
      const int t4 = tslab / 4;
      // an owner's staged partials, padded: tslab is a multiple of 8
      // floats, so owners lie an odd multiple of 16 bytes apart modulo 128
      // and the float4 stores of 8 consecutive owners meet no bank twice
      const int ost = tslab + kStagePad;

      // 1. The slab: every writer's part of the tile for this block's
      // units, 16 bytes a copy through the L2 only (the other blocks wrote
      // it in the step before; the L1 may hold older lines).
      if (s > 0) {
        for (int c = tid; c < W * t4; c += kBwdThreads) {
          const int p = c / t4;
          const int a = c - p * t4;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                       :: "r"(slab_addr + 16u * c),
                          "l"(x_in + p * wslab + g0 * SLOT + 4 * a)
                       : "memory");
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      // the inputs of this thread's first elementwise item, (group, row,
      // unit) e = tid, loaded meanwhile: they do not depend on the carry
      auto load_inputs = [&](int e, StepInputs& in) {
        const int g = e / SLOT;
        const int pair = e - g * SLOT;
        const int r = pair / U;
        const int jj = pair - r * U;
        const int b = r0 + g * kRows + r;
        if (b < B && jj < uu && t >= 0) {
          const size_t bj = static_cast<size_t>(b) * H + j0 + jj;
          const float* gt = gates + 4 * off + static_cast<size_t>(b) * G +
                            j0 + jj;
          in.dho = dhseq[off + bj];
          in.gi = gt[0];
          in.gf = gt[H];
          in.gg = gt[2 * H];
          in.go = gt[3 * H];
          in.ct = cseq[off + bj];
          in.cp = t == 0 ? c0[bj] : cseq[off - BH + bj];
          in.dc = dc[bj];
        }
      };
      StepInputs first{};
      if (tid < tslab) load_inputs(tid, first);
      if (s > 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // the slab has landed

      // 2. The writer sums: kSumParts threads a (group, row, unit) e, each
      // summing every kSumParts-th writer in order. A warp's lanes take
      // consecutive e of one part: lanes of one e in one warp would read
      // addresses tslab floats apart, often in one bank.
      if (s > 0) {
        for (int item = tid; item < kSumParts * tslab; item += kBwdThreads) {
          const int part = item / tslab;
          const int e = item - part * tslab;
          const float* src = slab_s + e;
          float sum = 0.0f;
#pragma unroll 4
          for (int p = part; p < W; p += kSumParts) sum += src[p * tslab];
          part_s[item] = sum;
        }
      }
      __syncthreads();  // the partial sums are whole; the slab is read

      // 3. The elementwise part, item (group, row, unit) e.
      for (int e = tid; e < tslab; e += kBwdThreads) {
        const int g = e / SLOT;
        const int pair = e - g * SLOT;
        const int r = pair / U;
        const int jj = pair - r * U;
        const int b = r0 + g * kRows + r;
        if (b >= B || jj >= uu) continue;
        const size_t bj = static_cast<size_t>(b) * H + j0 + jj;
        const float carry =
            s == 0 ? dhn[bj]
                   : (part_s[e] + part_s[tslab + e]) +
                         (part_s[2 * tslab + e] + part_s[3 * tslab + e]);
        if (t < 0) {
          dh0[bj] = carry;
          continue;
        }
        StepInputs in = first;
        if (e != tid) load_inputs(e, in);
        const float dh = in.dho + carry;
        const float th = tanhf(in.ct);
        const float d_o = dh * th;
        const float dcv = in.dc + dh * in.go * (1.0f - th * th);
        const float dg[4] = {dcv * in.gg * in.gi * (1.0f - in.gi),
                             dcv * in.cp * in.gf * (1.0f - in.gf),
                             dcv * in.gi * (1.0f - in.gg * in.gg),
                             d_o * in.go * (1.0f - in.go)};
        float* out = dgates + 4 * off + static_cast<size_t>(b) * G + j0 + jj;
        float* dgr = dg_s + g * DGS + jj * kRows + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          out[q * H] = dg[q];
          dgr[q * U * kRows] = dg[q];
        }
        dc[bj] = dcv * in.gf;
      }
      __syncthreads();  // dg_s is whole
      if (t < 0) continue;

      // 4. The partial product, item (group g, owner o): 8 rows x U units
      // of owner o over this block's K columns, 4 columns at a time (one
      // float4 of w_s a unit serves 8 rows), staged at owner o's place in
      // slab_s.
      for (int item = tid; item < groups * W; item += kBwdThreads) {
        const int g = item / W;
        const int o = item - g * W;
        float acc[kRows * U];
#pragma unroll
        for (int a = 0; a < kRows * U; ++a) acc[a] = 0.0f;
        const float4* d4 = reinterpret_cast<const float4*>(dg_s + g * DGS);
        const float4* w4 = reinterpret_cast<const float4*>(w_s + o * WO);
#pragma unroll
        for (int k0 = 0; k0 < K; k0 += 4) {  // columns k0 .. k0+3, in order
          float d[4][kRows];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 lo = d4[2 * (k0 + kk)];
            const float4 hi = d4[2 * (k0 + kk) + 1];
            d[kk][0] = lo.x; d[kk][1] = lo.y; d[kk][2] = lo.z; d[kk][3] = lo.w;
            d[kk][4] = hi.x; d[kk][5] = hi.y; d[kk][6] = hi.z; d[kk][7] = hi.w;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float4 w = w4[(u * K + k0) / 4];
            const float wk[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                acc[r * U + u] = fmaf(d[kk][r], wk[kk], acc[r * U + u]);
              }
            }
          }
        }
        float4* dst = reinterpret_cast<float4*>(slab_s + o * ost + g * SLOT);
#pragma unroll
        for (int a = 0; a < 2 * U; ++a) {
          dst[a] = make_float4(acc[4 * a], acc[4 * a + 1], acc[4 * a + 2],
                               acc[4 * a + 3]);
        }
      }
      __syncthreads();

      // 5. The staged partials to xbuf, float4 by float4: a warp writes 512
      // consecutive bytes of shared memory to one or two owners' parts.
      for (int c = tid; c < W * t4; c += kBwdThreads) {
        const int o = c / t4;
        const int a = c - o * t4;
        reinterpret_cast<float4*>(x_out + o * oslab + blockIdx.x * wslab +
                                  g0 * SLOT)[a] =
            reinterpret_cast<const float4*>(slab_s + o * ost)[a];
      }
      __syncthreads();  // the next tile's copies overwrite slab_s
    }
    if (t >= 0) cooperative_groups::this_grid().sync();
  }
}

template <int U>
const void* lstm_bwd_kernel_of(int units) {
  if constexpr (U > kBwdMaxUnits) {
    return nullptr;
  } else {
    return units == U ? (const void*)lstm_bwd_persistent<U>
                      : lstm_bwd_kernel_of<U + 1>(units);
  }
}

// Runs the persistent backward on `stream` with the caller's plan (grid,
// units, tile_rows, smem). Returns the first CUDA error (0 when the launch
// was accepted): a plan that does not cover H, a unit count with no
// instantiation, shared memory short of what the plan needs, or a grid the
// card cannot hold at once is refused before any launch. It does not
// synchronise.
inline int lstm_backward_persistent(
    const float* dhseq, const float* dhn, const float* gates,
    const float* cseq, const float* c0, const float* wh, long long ws0,
    long long ws1, float* dc, float* dgates, float* dh0, float* xbuf, int T,
    int B, int H, int grid, int units, int tile_rows, int smem,
    cudaStream_t stream) {
  const void* kernel = units >= 1 ? lstm_bwd_kernel_of<1>(units) : nullptr;
  if (kernel == nullptr || grid < 1 || tile_rows < 1 ||
      (tile_rows < B && tile_rows % kRows != 0) ||
      static_cast<long long>(grid) * units < H ||
      static_cast<long long>(grid - 1) * units >= H || smem < 0 ||
      static_cast<size_t>(smem) < lstm_bwd_smem(grid, units, tile_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 0, smem_optin = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = static_cast<cudaError_t>(lstm_device_limits(&sms, &smem_optin));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBwdThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid > per_sm * sms) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  void* args[] = {&dhseq, &dhn, &gates, &cseq, &c0, &wh, &dc, &dgates,
                  &dh0, &xbuf, &T, &B, &H, &ws0, &ws1, &tile_rows};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kBwdThreads),
                                    args, static_cast<size_t>(smem), stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace
