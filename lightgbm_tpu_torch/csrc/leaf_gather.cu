// Score update by leaf gather (K3) for sm_90a, with a plain C interface
// loaded by ctypes (lightgbm_tpu_torch/ops/predict.py).
//
// Replaces the TPU kernel lightgbm_tpu/ops/predict.py:64
// leaf_gather_pallas, which computes table[leaf_ids] by sweeping the
// table with L compare-and-selects per row (a TPU gather of a small
// table by 11M indices is a slow scalar loop). On the card a gather
// from a table held in shared memory is one load per row, so the kernel
// fuses the whole score update instead:
//
//     scores[i] = fmaf(table[leaf[i]], shrink, scores[i])   for leaf[i]
//                                                           in [0, L)
//
// and leaves scores[i] unchanged for ids outside [0, L) ("adds
// nothing"). ``table`` is the tree's leaf outputs and ``shrink`` its
// shrinkage, fused into the add with one rounding, as XLA contracts the
// JAX package's score update.
//
// What bounds it on an H100: bytes, 12 per row (the leaf id read, the
// score read and written), 0.039 ms at 11M rows and 3.35 TB/s. To come
// near that the kernel keeps many wide loads in flight: each thread
// takes kUnroll groups of 4 rows, starts all their loads (16-byte score
// loads, 16-byte id loads through the read-only path) before any store,
// and the grid is sized so that every thread does exactly that much; the
// table (L <= 4096 floats) is staged once per block in shared memory.
// ``scores`` may be a row of a [K, N] matrix, so it need not start on
// 16 bytes: the rows before its first 16-byte boundary (the head, at
// most 3) and after its last whole group of 4 (the tail, at most 3) are
// done one at a time by the first threads of the grid. When the ids are
// not 16-byte aligned where the scores are, they are read as 4 words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 4096;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // groups of 4 rows per thread

// rows before p's first 16-byte boundary (at most 3, at most n)
int head_rows(const float* p, long long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int h = (int)(((16 - (a & 15)) & 15) / 4);
  return n < h ? (int)n : h;
}

__device__ __forceinline__ float add_one(const float* s_tab, int L,
                                         float shrink, int l, float s) {
  return (unsigned)l < (unsigned)L ? fmaf(s_tab[l], shrink, s) : s;
}

template <bool IDS_ALIGNED>
__global__ void __launch_bounds__(kThreads)
leaf_gather_add_kernel(float* __restrict__ scores,
                       const int* __restrict__ leaf,
                       const float* __restrict__ table, int L, float shrink,
                       int64_t n, int head, int64_t groups) {
  __shared__ float s_tab[kMaxLeaves];
  for (int k = threadIdx.x; k < L; k += blockDim.x) s_tab[k] = table[k];
  __syncthreads();
  // the head and the tail, one row per thread of the first block
  if (blockIdx.x == 0) {
    const int64_t tail0 = head + 4 * groups;
    const int t = threadIdx.x;
    int64_t i = -1;
    if (t < head) i = t;
    else if (t >= 4 && t - 4 < n - tail0) i = tail0 + t - 4;
    if (i >= 0)
      scores[i] = add_one(s_tab, L, shrink, __ldg(leaf + i), scores[i]);
  }
  float4* sv = reinterpret_cast<float4*>(scores + head);
  const int* lv = leaf + head;
  const int64_t g0 =
      (int64_t)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  float4 s[kUnroll];
  int4 l[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t q = g0 + u * kThreads;
    if (q < groups) {
      s[u] = sv[q];
      if (IDS_ALIGNED) {
        l[u] = __ldg(reinterpret_cast<const int4*>(lv) + q);
      } else {
        l[u] = make_int4(__ldg(lv + 4 * q), __ldg(lv + 4 * q + 1),
                         __ldg(lv + 4 * q + 2), __ldg(lv + 4 * q + 3));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t q = g0 + u * kThreads;
    if (q < groups) {
      float4 o;
      o.x = add_one(s_tab, L, shrink, l[u].x, s[u].x);
      o.y = add_one(s_tab, L, shrink, l[u].y, s[u].y);
      o.z = add_one(s_tab, L, shrink, l[u].z, s[u].z);
      o.w = add_one(s_tab, L, shrink, l[u].w, s[u].w);
      sv[q] = o;
    }
  }
}

}  // namespace

extern "C" int leaf_gather_add_launch(float* scores, const int* leaf,
                                      const float* table, int L,
                                      float shrink, long long n,
                                      void* stream) {
  if (L < 1 || L > kMaxLeaves || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // rows before scores' first 16-byte boundary, then whole groups of 4
  const int head = head_rows(scores, n);
  const long long groups = (n - head) / 4;
  const bool ids_aligned =
      ((reinterpret_cast<uintptr_t>(leaf + head)) & 15) == 0;
  long long blocks = (groups + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (ids_aligned)
    leaf_gather_add_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        scores, leaf, table, L, shrink, n, head, groups);
  else
    leaf_gather_add_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        scores, leaf, table, L, shrink, n, head, groups);
  return (int)cudaGetLastError();
}
