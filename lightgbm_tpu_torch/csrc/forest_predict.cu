// Forest traversal for Hopper (sm_90a): the port's counterpart of the JAX
// package's fused forest kernel, lightgbm_tpu/ops/stacked_predict.py:1048
// forest_predict_pallas (TPU) and :1157 forest_predict_pallas_gpu (its
// Pallas-Triton twin).
//
// What it computes: per row, per tree in model order, the leaf the row
// reaches and, in score mode, the sum of those leaves' values per class
// (tree t belongs to class t % K); in leaf mode, the leaf indices. Inputs
// are the feature-major global bin codes [F, N] that the host or the
// device binning produced, and per-node tables built on the host:
//   nodes [T, S] int4 = {feature, left child, right child, table offset of
//         the feature}, children < 0 are leaves ~leaf;
//   dec   [T, S, Wn] u8 = the node's decision (1 = left) at each local bin
//         code of its feature, the same tables the JAX package builds
//         (_node_table), so missing values, default-left, the zero band and
//         categorical bitsets decide identically;
//   leaf  [T, L] f32, root [T] i32 (0, or -1 = ~0 for a single-leaf tree).
//
// What bounds it: N*T*depth dependent lookups (node record, then the
// row's code of that node's feature, then one decision byte), plus 4F
// bytes read and 4K bytes written per row. The lookups, not the bytes,
// set the time: each step waits on the one before it. The TPU kernel
// turned the walk into two one-hot matrix products because a TPU has no
// cheap gather; a GPU has one, so this is the plain walk, one thread per
// row. Neighbouring threads start on the same root record (a broadcast
// load) and read neighbouring codes (coalesced); the per-node tables are
// laid out [T, S, Wn] so a node's decisions are contiguous, and at the
// HIGGS shape (500 trees, 254 nodes, 257 codes) they total 33 MB and stay
// in the 50 MB L2 cache. Scores add in f32 in model order with no
// multiply, so the result is bit-equal to the plain PyTorch walk in
// lightgbm_tpu_torch/ops/forest.py.
//
// Built by nvcc into a shared library with a plain C interface (ops/forest.py
// loads it with ctypes). Each entry launches on the stream it is given,
// on the calling thread's current device (the caller makes the tensors'
// device current), allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int walk(const int* __restrict__ codes,
                                    long long n_rows, long long row,
                                    const int4* __restrict__ nodes,
                                    const uint8_t* __restrict__ dec,
                                    int wn, int node) {
  while (node >= 0) {
    const int4 nd = __ldg(nodes + node);
    const int code = __ldg(codes + (long long)nd.x * n_rows + row);
    node = __ldg(dec + (long long)node * wn + (code - nd.w)) ? nd.y : nd.z;
  }
  return ~node;
}

__global__ void __launch_bounds__(kThreads)
forest_scores_kernel(const int* __restrict__ codes,
                     const int4* __restrict__ nodes,
                     const uint8_t* __restrict__ dec,
                     const float* __restrict__ leaf,
                     const int* __restrict__ root, float* __restrict__ out,
                     int n_rows, int s, int wn, int l, int t0, int t1,
                     int k) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  for (int c = 0; c < k; ++c) {
    float acc = 0.0f;
    // the trees of class c, in model order
    for (int t = t0 + ((c - t0 % k) % k + k) % k; t < t1; t += k) {
      const int lf = walk(codes, n_rows, row, nodes + (long long)t * s,
                          dec + (long long)t * s * wn, wn, __ldg(root + t));
      acc = __fadd_rn(acc, __ldg(leaf + (long long)t * l + lf));
    }
    out[row * k + c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
forest_leaves_kernel(const int* __restrict__ codes,
                     const int4* __restrict__ nodes,
                     const uint8_t* __restrict__ dec,
                     const int* __restrict__ root, int* __restrict__ out,
                     int n_rows, int s, int wn, int t0, int t1) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int nt = t1 - t0;
  for (int t = t0; t < t1; ++t) {
    out[row * nt + (t - t0)] =
        walk(codes, n_rows, row, nodes + (long long)t * s,
             dec + (long long)t * s * wn, wn, __ldg(root + t));
  }
}

}  // namespace

extern "C" int forest_predict_scores(const void* codes, const void* nodes,
                                     const void* dec, const void* leaf,
                                     const void* root, void* out,
                                     int n_rows, int s, int wn, int l,
                                     int t0, int t1, int k,
                                     void* stream) {
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  forest_scores_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)codes, (const int4*)nodes, (const uint8_t*)dec,
      (const float*)leaf, (const int*)root, (float*)out, n_rows, s, wn, l,
      t0, t1, k);
  return (int)cudaGetLastError();
}

extern "C" int forest_predict_leaves(const void* codes, const void* nodes,
                                     const void* dec, const void* root,
                                     void* out, int n_rows, int s, int wn,
                                     int t0, int t1, void* stream) {
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  forest_leaves_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)codes, (const int4*)nodes, (const uint8_t*)dec,
      (const int*)root, (int*)out, n_rows, s, wn, t0, t1);
  return (int)cudaGetLastError();
}
