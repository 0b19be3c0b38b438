// Greedy non-maximum suppression over a batch of score-sorted boxes, for
// Hopper (sm_90a): N1.
//
// It replaces no TPU kernel. The JAX package's greedy_nms_keep
// (mxnet_tpu/ops/contrib_ops.py) is a lax.fori_loop over every candidate,
// which XLA compiles into one while loop on the device; run eagerly in
// PyTorch the same loop is a few launches per candidate (tens of thousands
// at Proposal's rpn_pre_nms_top_n of 6000). box_nms, MultiBoxDetection and
// Proposal all call it, so the port does the loop in two launches here, as
// reference MXNet has its own NMS kernel for the GPU
// (src/operator/contrib/proposal.cu, multibox_detection.cu).
//
// What it computes. boxes (B, N, 4) f32 corners already in descending score
// order, valid (B, N) bytes, optional class ids (B, N) f32, thresh. Row i
// suppresses every later j with IoU(i, j) > thresh (IoU taken as 0 across
// classes unless class ids are absent) only if i is still kept; invalid rows
// suppress nothing. The output is keep (B, N) bytes in the sorted order: the
// keep mask of greedy_nms_keep before its un-permute.
//
// The design. Pass 1 (nms_mask) is parallel: a grid of 64x64 tiles of the
// upper triangle, one thread a row, writes row i's suppression bits for the
// 64 columns j > i of its tile as one uint64 word. Pass 2 (nms_sweep) is one
// block an image: it keeps the removed-bitmask in shared memory (N/8 bytes,
// 4 KB at N = 32768), resolves the 64 rows of a word one after another from
// their diagonal words staged in shared memory, and ORs the kept rows' words
// into the later words of the mask, one word a thread. Only the bitmask,
// N*N/8 bytes an image (4.5 MB at N = 6000), goes through device memory; the
// (N, N) f32 IoU matrix that the JAX function builds never exists.
//
// Rounding. The IoU takes the plain version's operations in its order
// (box_iou_xyxy: corners by max/min, width and height clamped at 0, the
// intersection, both areas, the union, inter / max(union, 1e-12)), each an
// explicitly rounded intrinsic that nvcc never contracts into an FMA, so the
// keep mask equals the plain version's bit for bit, even at the threshold.
//
// What bounds it. The IoU arithmetic (about 20 operations a pair of the
// upper triangle) over the card's f32 rate, or the bytes of boxes and masks;
// at these sizes neither: the sweep's chain of N/64 dependent steps, each a
// block barrier and a 64-step scan, is its latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kSweepThreads = 256;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ float iou_of(float4 a, float area_a, float4 b,
                                        float area_b) {
  const float tlx = fmaxf(a.x, b.x);
  const float tly = fmaxf(a.y, b.y);
  const float brx = fminf(a.z, b.z);
  const float bry = fminf(a.w, b.w);
  const float w = fmaxf(__fsub_rn(brx, tlx), 0.f);
  const float h = fmaxf(__fsub_rn(bry, tly), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f));
}

// grid (column tiles, row tiles, B), kTile threads: thread t of tile
// (cb, rb) writes mask[b][rb*64 + t][cb]. Tiles below the diagonal exit: the
// sweep never reads their words.
__global__ void nms_mask(const float4* __restrict__ boxes,
                         const float* __restrict__ cls, int n, int words,
                         float thresh,
                         unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  __shared__ float4 sbox[kTile];
  __shared__ float sarea[kTile];
  __shared__ float scls[kTile];
  const int t = threadIdx.x;
  const int j0 = cb * kTile;
  const float4* bb = boxes + (size_t)b * n;
  const float* cc = cls ? cls + (size_t)b * n : nullptr;
  if (j0 + t < n) {
    const float4 c = bb[j0 + t];
    sbox[t] = c;
    sarea[t] = area_of(c);
    scls[t] = cc ? cc[j0 + t] : 0.f;
  }
  __syncthreads();
  const int i = rb * kTile + t;
  if (i >= n) return;
  const float4 a = bb[i];
  const float area_a = area_of(a);
  const float ca = cc ? cc[i] : 0.f;
  const int kmax = min(kTile, n - j0);
  unsigned long long bits = 0ull;
  for (int k = 0; k < kmax; ++k) {
    if (j0 + k <= i) continue;
    float iou = iou_of(a, area_a, sbox[k], sarea[k]);
    if (cc && scls[k] != ca) iou = 0.f;
    if (iou > thresh) bits |= 1ull << k;
  }
  mask[((size_t)b * n + i) * words + cb] = bits;
}

// one block an image, kSweepThreads threads, words * 8 bytes of dynamic
// shared memory for the removed-bitmask.
__global__ void nms_sweep(const unsigned long long* __restrict__ mask,
                          const unsigned char* __restrict__ valid, int n,
                          int words, unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long diag[kTile];
  const int b = blockIdx.x;
  const unsigned long long* m = mask + (size_t)b * n * words;
  const unsigned char* v = valid + (size_t)b * n;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned long long r = 0ull;
    for (int k = 0; k < kTile; ++k) {
      const int i = w * kTile + k;
      if (i >= n || !v[i]) r |= 1ull << k;
    }
    removed[w] = r;
  }
  __syncthreads();
  for (int wb = 0; wb < words; ++wb) {
    if (threadIdx.x < kTile) {
      const int i = wb * kTile + threadIdx.x;
      diag[threadIdx.x] = i < n ? m[(size_t)i * words + wb] : 0ull;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long r = removed[wb];
      for (int k = 0; k < kTile; ++k)
        if (!((r >> k) & 1ull)) r |= diag[k];
      removed[wb] = r;
    }
    __syncthreads();
    const unsigned long long kept = ~removed[wb];
    if (kept) {
      const unsigned long long* rows = m + (size_t)wb * kTile * words;
      for (int w = wb + 1 + threadIdx.x; w < words; w += blockDim.x) {
        unsigned long long acc = 0ull, kb = kept;
        while (kb) {
          const int k = __ffsll((long long)kb) - 1;
          kb &= kb - 1;
          acc |= rows[(size_t)k * words + w];
        }
        removed[w] |= acc;
      }
    }
    __syncthreads();
  }
  unsigned char* kk = keep + (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    kk[i] = ((removed[i >> 6] >> (i & 63)) & 1ull) ? 0 : 1;
}

}  // namespace

// boxes (B, n, 4) f32, 16-byte aligned; cls (B, n) f32 or null; valid and
// keep (B, n) bytes; mask B * n * ceil(n / 64) uint64 of scratch. Returns 0
// or the launch's error.
extern "C" int greedy_nms(const void* boxes, const void* cls,
                          const void* valid, int batch, int n, float thresh,
                          void* mask, void* keep, void* stream) {
  if (batch <= 0 || n <= 0) return -1;
  if (n > 32768 || batch > 65535) return -2;
  const int words = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(words, words, batch);
  nms_mask<<<grid, kTile, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(cls), n,
      words, thresh, static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep<<<batch, kSweepThreads, words * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const unsigned char*>(valid), n, words,
      static_cast<unsigned char*>(keep));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* greedy_nms_error_name(int err) {
  if (err == -1) return "an empty batch";
  if (err == -2) return "more than 32768 boxes an image or 65535 images";
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
