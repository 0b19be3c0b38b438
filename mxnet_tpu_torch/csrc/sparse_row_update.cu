// The lazy row-sparse optimizer update in one launch, for Hopper (sm_90a):
// S1. It replaces no TPU kernel: it is the counterpart of the one compiled
// XLA program that mxnet_tpu/optimizer.py::_sparse_row_update jits per
// (formula, shape, nnz bucket), and of reference MXNet's GPU kernels
// SGDUpdateRspImpl, AdamUpdateRspImpl and AdagradUpdateRspImpl. Run eagerly in
// PyTorch, lazy Adam is about 18 launches a push (gathers, elementwise ops,
// scatters); here it is one, whatever nnz is.
//
// What it computes. A compact row-sparse gradient (values[nnz, d], row ids
// idx[nnz], unique) updates only the rows it names. For each stored row
// r = idx[i] and column c, in f32 and in this order:
//   g = float(values[i, c]) * rescale, clipped to [-clip, clip] when clipping,
//   g = g + wd * float(w[r, c]);
//   0 sgd      u = -lr * g
//   1 sgd_mom  m[r] = momentum * m[r] + g;                 u = -lr * m[r]
//   2 adam     m[r] = beta1 * m[r] + (1 - beta1) * g;
//              v[r] = beta2 * v[r] + ((1 - beta2) * g) * g;
//              u = -(lr * m[r] / (sqrt(v[r]) + eps))     (lr bias-corrected)
//   3 adagrad  h[r] = h[r] + g * g;                        u = -(lr * g / (sqrt(h[r]) + eps))
//   w[r, c] = w[r, c] + round_w(u), the sum rounded to w's dtype (f32 or bf16,
//   round to nearest even); states are f32.
// Every product and sum is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn), which nvcc never contracts into an FMA, and sqrt and division
// are IEEE (__fsqrt_rn, __fdiv_rn): the kernel rounds where the plain
// version's separate PyTorch ops round (ops/sparse_update.py), so the two
// agree bit for bit. No other row of the weight or the states is read or
// written. The row ids are unique (the producers sort and deduplicate them),
// so no two threads write one element and no atomics are needed.
//
// Layout. A block is (columns, rows): threadIdx.x walks a row's d columns,
// threadIdx.y picks one of the block's rows, and the blocks stride over the
// nnz rows. Bytes bound it: each touched value is read and written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { kSgd = 0, kSgdMom = 1, kAdam = 2, kAdagrad = 3 };

struct Hyper {
  float lr, wd, rescale, clip, momentum, beta1, one_minus_beta1, beta2,
      one_minus_beta2, eps;
  int has_clip;
};

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

template <int K, typename W, typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    sparse_row_update_kernel(W* __restrict__ w, float* __restrict__ s0,
                             float* __restrict__ s1,
                             const V* __restrict__ vals,
                             const I* __restrict__ idx, long long nnz,
                             long long d, Hyper h) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       i < nnz; i += static_cast<long long>(gridDim.x) * blockDim.y) {
    const long long row = static_cast<long long>(idx[i]) * d;
    const V* grow = vals + i * d;
    for (long long c = threadIdx.x; c < d; c += blockDim.x) {
      const long long at = row + c;
      float g = __fmul_rn(to_f32(grow[c]), h.rescale);
      if (h.has_clip) {
        g = g < -h.clip ? -h.clip : g;
        g = g > h.clip ? h.clip : g;
      }
      const float w0 = to_f32(w[at]);
      g = __fadd_rn(g, __fmul_rn(h.wd, w0));
      float u;
      if (K == kSgd) {
        u = __fmul_rn(-h.lr, g);
      } else if (K == kSgdMom) {
        const float m = __fadd_rn(__fmul_rn(h.momentum, s0[at]), g);
        s0[at] = m;
        u = __fmul_rn(-h.lr, m);
      } else if (K == kAdam) {
        const float m = __fadd_rn(__fmul_rn(h.beta1, s0[at]),
                                  __fmul_rn(h.one_minus_beta1, g));
        const float v =
            __fadd_rn(__fmul_rn(h.beta2, s1[at]),
                      __fmul_rn(__fmul_rn(h.one_minus_beta2, g), g));
        s0[at] = m;
        s1[at] = v;
        u = -__fdiv_rn(__fmul_rn(h.lr, m), __fadd_rn(__fsqrt_rn(v), h.eps));
      } else {
        const float hh = __fadd_rn(s0[at], __fmul_rn(g, g));
        s0[at] = hh;
        u = -__fdiv_rn(__fmul_rn(h.lr, g), __fadd_rn(__fsqrt_rn(hh), h.eps));
      }
      store(__fadd_rn(w0, round_to(u, w)), w + at);
    }
  }
}

template <int K, typename W, typename V, typename I>
int launch_typed(void* w, void* s0, void* s1, const void* vals,
                 const void* idx, long long nnz, long long d, const Hyper& h,
                 cudaStream_t s) {
  const int cols = d >= kThreads ? kThreads
                                 : static_cast<int>((d + 31) / 32 * 32);
  const dim3 block(cols, kThreads / cols);
  long long blocks = (nnz + block.y - 1) / block.y;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sparse_row_update_kernel<K, W, V, I>
      <<<static_cast<unsigned>(blocks), block, 0, s>>>(
          static_cast<W*>(w), static_cast<float*>(s0),
          static_cast<float*>(s1), static_cast<const V*>(vals),
          static_cast<const I*>(idx), nnz, d, h);
  return static_cast<int>(cudaGetLastError());
}

template <int K, typename W, typename V>
int launch_idx(int idtype, void* w, void* s0, void* s1, const void* vals,
               const void* idx, long long nnz, long long d, const Hyper& h,
               cudaStream_t s) {
  if (idtype == 0)
    return launch_typed<K, W, V, long long>(w, s0, s1, vals, idx, nnz, d, h,
                                            s);
  if (idtype == 1)
    return launch_typed<K, W, V, int>(w, s0, s1, vals, idx, nnz, d, h, s);
  return -3;
}

template <int K, typename W>
int launch_vals(int vdtype, int idtype, void* w, void* s0, void* s1,
                const void* vals, const void* idx, long long nnz, long long d,
                const Hyper& h, cudaStream_t s) {
  if (vdtype == 0)
    return launch_idx<K, W, float>(idtype, w, s0, s1, vals, idx, nnz, d, h,
                                   s);
  if (vdtype == 1)
    return launch_idx<K, W, __nv_bfloat16>(idtype, w, s0, s1, vals, idx, nnz,
                                           d, h, s);
  return -2;
}

template <int K>
int launch_kind(int wdtype, int vdtype, int idtype, void* w, void* s0,
                void* s1, const void* vals, const void* idx, long long nnz,
                long long d, const Hyper& h, cudaStream_t s) {
  if (wdtype == 0)
    return launch_vals<K, float>(vdtype, idtype, w, s0, s1, vals, idx, nnz, d,
                                 h, s);
  if (wdtype == 1)
    return launch_vals<K, __nv_bfloat16>(vdtype, idtype, w, s0, s1, vals, idx,
                                         nnz, d, h, s);
  return -1;
}

}  // namespace

// kind: 0 sgd, 1 sgd_mom, 2 adam, 3 adagrad; wdtype and vdtype (weight,
// values): 0 f32, 1 bf16; idtype: 0 int64, 1 int32. w: the weight (rows, d),
// contiguous; s0, s1: its f32 states of the same shape (unused ones null);
// vals: (nnz, d) contiguous; idx: nnz unique row ids. All pointers are device
// pointers. nnz must be positive. Returns 0, a negative code
// (sparse_row_update_error_name) or a cudaError_t.
extern "C" int sparse_row_update(int kind, int wdtype, int vdtype, int idtype,
                                 void* w, void* s0, void* s1,
                                 const void* vals, const void* idx,
                                 long long nnz, long long d, float lr,
                                 float wd, float rescale, int has_clip,
                                 float clip, float momentum, float beta1,
                                 float one_minus_beta1, float beta2,
                                 float one_minus_beta2, float eps,
                                 void* stream) {
  if (nnz <= 0 || d <= 0) return -5;
  const Hyper h{lr,    wd,    rescale,         clip, momentum,
                beta1, one_minus_beta1, beta2, one_minus_beta2,
                eps,   has_clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSgd:
      return launch_kind<kSgd>(wdtype, vdtype, idtype, w, s0, s1, vals, idx,
                               nnz, d, h, s);
    case kSgdMom:
      return launch_kind<kSgdMom>(wdtype, vdtype, idtype, w, s0, s1, vals,
                                  idx, nnz, d, h, s);
    case kAdam:
      return launch_kind<kAdam>(wdtype, vdtype, idtype, w, s0, s1, vals, idx,
                                nnz, d, h, s);
    case kAdagrad:
      return launch_kind<kAdagrad>(wdtype, vdtype, idtype, w, s0, s1, vals,
                                   idx, nnz, d, h, s);
    default:
      return -4;
  }
}

extern "C" const char* sparse_row_update_error_name(int err) {
  if (err == -1) return "unsupported weight dtype";
  if (err == -2) return "unsupported values dtype";
  if (err == -3) return "unsupported index dtype";
  if (err == -4) return "unknown formula";
  if (err == -5) return "empty rows or columns";
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
