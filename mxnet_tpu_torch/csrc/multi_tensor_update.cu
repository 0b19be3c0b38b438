// One launch that applies an optimizer update to a whole list of tensors,
// for Hopper (sm_90a): U1, the counterpart of the one compiled program of
// mxnet_tpu/optimizer.py::FusedApplier (an XLA program, not a TPU kernel).
//
// What it computes. For every tensor k of the list, elementwise, the update
// of mxnet_tpu_torch/ops/optimizer_ops.py named by the formula:
//   0 sgd         w = w - lr*g'
//   1 sgd_mom     mom = momentum*mom - lr*g';  w = w + mom
//   2 mp_sgd      w32 = w32 - lr*g';  w = round(w32)
//   3 mp_sgd_mom  mom = momentum*mom - lr*g';  w32 = w32 + mom;  w = round(w32)
//   4 adam        m = b1*m + (1-b1)*g';  v = b2*v + (1-b2)*g'^2;
//                 w = w - lr*m / (sqrt(v) + eps)
//   5 mp_adam     adam on the f32 master copy w32;  w = round(w32)
// with g' = clip(rescale * float(g)) + wd * w (w32 for the mp formulas), all
// in f32 and in that order, the new weight rounded once to its dtype (f32 or
// bf16, round to nearest even). lr and wd are per tensor and come from a
// device vector the wrapper fills each step (Adam's bias correction is in the
// lr); rescale, clip and the formula's constants are kernel arguments.
// Every product and sum is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, ...), which nvcc never contracts into an FMA, and sqrt and
// division are IEEE (__fsqrt_rn, __fdiv_rn): the kernel rounds where the
// plain version's separate PyTorch ops round.
//
// The list. A device table holds, for each tensor, its pointers (weight,
// gradient, up to three f32 states) and element count; a second device array
// lists (tensor, chunk) pairs, one block each, so a 64-element BatchNorm
// bias and a 2.4M-element convolution weight share the launch. Nothing that
// changes from step to step is in the launch's arguments but the scalars
// above, so the launch can be captured in a CUDA graph.
//
// What bounds it: bytes. Each value is read and written once (sgd f32: 8 B
// read, 4 written; mp_sgd_mom bf16: 10 and 10; adam f32: 16 and 12; mp_adam
// bf16: 14 and 14, the master read in place of the weight), at far
// below one operation a byte. A block streams its chunk with 16-byte loads
// (8-byte for bf16 weights and gradients) where the tensor's pointers allow,
// elementwise otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Formula {
  kSgd = 0,
  kSgdMom = 1,
  kMpSgd = 2,
  kMpSgdMom = 3,
  kAdam = 4,
  kMpAdam = 5
};

// One tensor of the list, as ops/multi_tensor.py packs it: six int64s.
struct Entry {
  void* w;
  const void* g;
  float* s0;
  float* s1;
  float* s2;
  long long n;
};

struct Hyper {
  float rescale, clip, momentum, beta1, one_minus_beta1, beta2,
      one_minus_beta2, eps;
};

constexpr int kThreads = 256;
constexpr int kVec = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 u;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint2*>(p) = u;
}

// The moments a formula carries (mom; or Adam's mean and var) and whether it
// keeps an f32 master copy of the weight, which is its last state.
template <int F> struct Traits {
  static constexpr int kMoments = (F == kSgdMom || F == kMpSgdMom)
                                      ? 1
                                      : ((F == kAdam || F == kMpAdam) ? 2 : 0);
  static constexpr bool kMaster = F == kMpSgd || F == kMpSgdMom ||
                                  F == kMpAdam;
};

// The new weight (f32) from the old one, the raw gradient and the moments,
// which it updates.
template <int F>
__device__ __forceinline__ float update(float w32, float g, float* st,
                                        float lr, float wd, const Hyper& h) {
  g = __fmul_rn(g, h.rescale);
  if (h.clip > 0.f) g = g < -h.clip ? -h.clip : (g > h.clip ? h.clip : g);
  g = __fadd_rn(g, __fmul_rn(wd, w32));
  if (F == kSgd || F == kMpSgd) return __fsub_rn(w32, __fmul_rn(lr, g));
  if (F == kSgdMom || F == kMpSgdMom) {
    const float m = __fsub_rn(__fmul_rn(h.momentum, st[0]), __fmul_rn(lr, g));
    st[0] = m;
    return __fadd_rn(w32, m);
  }
  const float m = __fadd_rn(__fmul_rn(h.beta1, st[0]),
                            __fmul_rn(h.one_minus_beta1, g));
  const float v = __fadd_rn(__fmul_rn(h.beta2, st[1]),
                            __fmul_rn(h.one_minus_beta2, __fmul_rn(g, g)));
  st[0] = m;
  st[1] = v;
  return __fsub_rn(w32, __fdiv_rn(__fmul_rn(lr, m),
                                  __fadd_rn(__fsqrt_rn(v), h.eps)));
}

template <int F, typename W>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_kernel(const Entry* __restrict__ table,
                        const int2* __restrict__ chunks,
                        const float* __restrict__ lrwd, int chunk, Hyper h) {
  using T = Traits<F>;
  const int2 c = chunks[blockIdx.x];
  const Entry e = table[c.x];
  const float lr = lrwd[2 * c.x], wd = lrwd[2 * c.x + 1];
  W* w = static_cast<W*>(e.w);
  const W* g = static_cast<const W*>(e.g);
  float* mom[2] = {e.s0, e.s1};
  float* master = T::kMaster
                      ? (F == kMpSgd ? e.s0 : (F == kMpSgdMom ? e.s1 : e.s2))
                      : nullptr;
  const long long begin = static_cast<long long>(c.y) * chunk;
  const long long end = min(e.n, begin + chunk);

  uintptr_t wide = reinterpret_cast<uintptr_t>(mom[0]) |
                   reinterpret_cast<uintptr_t>(master);
  if (T::kMoments == 2) wide |= reinterpret_cast<uintptr_t>(mom[1]);
  const uintptr_t narrow = reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(g);
  const bool vec = (wide % 16) == 0 && (narrow % (kVec * sizeof(W))) == 0;

  for (long long i = begin + threadIdx.x * kVec; i < end;
       i += kThreads * kVec) {
    if (vec && i + kVec <= end) {
      float wv[kVec], gv[kVec], st[2][kVec] = {};
      if (T::kMaster) load4(master + i, wv); else load4(w + i, wv);
      load4(g + i, gv);
#pragma unroll
      for (int k = 0; k < T::kMoments; ++k) load4(mom[k] + i, st[k]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float s[2] = {st[0][j], st[1][j]};
        wv[j] = update<F>(wv[j], gv[j], s, lr, wd, h);
        st[0][j] = s[0];
        st[1][j] = s[1];
      }
#pragma unroll
      for (int k = 0; k < T::kMoments; ++k) store4(mom[k] + i, st[k]);
      if (T::kMaster) store4(master + i, wv);
      store4(w + i, wv);
    } else {
      for (long long j = i; j < min(end, i + kVec); ++j) {
        float s[2] = {0.f, 0.f};
        for (int k = 0; k < T::kMoments; ++k) s[k] = mom[k][j];
        const float w32 = T::kMaster ? master[j] : to_f32(w[j]);
        const float nw = update<F>(w32, to_f32(g[j]), s, lr, wd, h);
        for (int k = 0; k < T::kMoments; ++k) mom[k][j] = s[k];
        if (T::kMaster) master[j] = nw;
        from_f32(nw, w + j);
      }
    }
  }
}

template <typename W>
int launch(int formula, const Entry* table, const int2* chunks, int n_chunks,
           const float* lrwd, int chunk, const Hyper& h, cudaStream_t s) {
  const dim3 grid(n_chunks), block(kThreads);
  switch (formula) {
    case kSgd:
      multi_tensor_kernel<kSgd, W><<<grid, block, 0, s>>>(table, chunks, lrwd,
                                                          chunk, h);
      break;
    case kSgdMom:
      multi_tensor_kernel<kSgdMom, W><<<grid, block, 0, s>>>(
          table, chunks, lrwd, chunk, h);
      break;
    case kMpSgd:
      multi_tensor_kernel<kMpSgd, W><<<grid, block, 0, s>>>(
          table, chunks, lrwd, chunk, h);
      break;
    case kMpSgdMom:
      multi_tensor_kernel<kMpSgdMom, W><<<grid, block, 0, s>>>(
          table, chunks, lrwd, chunk, h);
      break;
    case kAdam:
      multi_tensor_kernel<kAdam, W><<<grid, block, 0, s>>>(
          table, chunks, lrwd, chunk, h);
      break;
    case kMpAdam:
      multi_tensor_kernel<kMpAdam, W><<<grid, block, 0, s>>>(
          table, chunks, lrwd, chunk, h);
      break;
    default:
      return -2;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// formula: 0-5 as above; wdtype: 0 f32, 1 bf16 (weights and gradients);
// table: n tensors' Entry records; chunks: n_chunks (tensor, chunk) int32
// pairs; lrwd: 2n f32 (lr, wd of each tensor); chunk: elements a chunk, a
// multiple of 4. All pointers are device pointers. Returns 0, a negative
// code (multi_tensor_update_error_name) or a cudaError_t.
extern "C" int multi_tensor_update(int formula, int wdtype, const void* table,
                                   const void* chunks, int n_chunks,
                                   const void* lrwd, int chunk, float rescale,
                                   float clip, float momentum, float beta1,
                                   float one_minus_beta1, float beta2,
                                   float one_minus_beta2, float eps,
                                   void* stream) {
  if (chunk <= 0 || chunk % kVec != 0) return -3;
  if (n_chunks <= 0) return -4;
  const Hyper h{rescale, clip, momentum, beta1, one_minus_beta1,
                beta2, one_minus_beta2, eps};
  const Entry* t = static_cast<const Entry*>(table);
  const int2* c = static_cast<const int2*>(chunks);
  const float* lw = static_cast<const float*>(lrwd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wdtype == 0) return launch<float>(formula, t, c, n_chunks, lw, chunk, h, s);
  if (wdtype == 1)
    return launch<__nv_bfloat16>(formula, t, c, n_chunks, lw, chunk, h, s);
  return -1;
}

extern "C" const char* multi_tensor_update_error_name(int err) {
  if (err == -1) return "unsupported weight dtype";
  if (err == -2) return "unknown formula";
  if (err == -3) return "the chunk is not a positive multiple of 4";
  if (err == -4) return "an empty list";
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
