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
//     scores[i] += table[leaf[i]]   for leaf[i] in [0, L)
//
// and leaves scores[i] unchanged for ids outside [0, L) ("adds
// nothing"). ``table`` is the tree's leaf outputs with the shrinkage
// already folded in. What bounds it: bytes, 12 per row (the leaf id
// read, the score read and written); the table (L <= 4096 floats) is
// staged once per block in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 4096;

__global__ void leaf_gather_add_kernel(float* __restrict__ scores,
                                       const int* __restrict__ leaf,
                                       const float* __restrict__ table,
                                       int L, int64_t n) {
  __shared__ float s_tab[kMaxLeaves];
  for (int k = threadIdx.x; k < L; k += blockDim.x) s_tab[k] = table[k];
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int l = leaf[i];
    if ((unsigned)l < (unsigned)L) scores[i] += s_tab[l];
  }
}

}  // namespace

extern "C" int leaf_gather_add_launch(float* scores, const int* leaf,
                                      const float* table, int L,
                                      long long n, void* stream) {
  if (L < 1 || L > kMaxLeaves) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  leaf_gather_add_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      scores, leaf, table, L, n);
  return (int)cudaGetLastError();
}
