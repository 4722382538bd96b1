// Wave histograms (K2) and the fused partition + histogram pass (K1)
// for sm_90a, with a plain C interface loaded by ctypes
// (lightgbm_tpu_torch/ops/hist_wave.py).
//
// Replaces the TPU kernels
//   K2 lightgbm_tpu/ops/hist_wave.py:482 wave_histogram_pallas
//      (and its Pallas-Triton twin :1263 wave_histogram_pallas_gpu),
//   K1 lightgbm_tpu/ops/hist_wave.py:984 fused_partition_histogram_pallas
//      (and :1454 fused_partition_histogram_pallas_gpu).
// Both produce [W, F, B, 3] f32 histograms (sum g, sum h, count) of the
// rows in each of W wave slots; K1 first applies the wave's W splits to
// the rows' leaf ids and counts each slot's smaller child only.
//
// What bounds them on an H100: the bytes are few (each row's F bin
// bytes, g, h, leaf id, mask: ~48 B/row at 28 features, 0.16 ms per
// pass at 11M rows and 3.35 TB/s). The TPU kernel turns the scatter into
// one-hot matrix products for the MXU; the card has no such need, and
// its GPU twin adds through global f32 atomics whose order, and so whose
// rounding, changes from run to run. This design keeps every sum in a
// fixed order so that two launches on the same input give the same bits:
//
//   1. a slot pass, one thread per row, writes each row's wave slot
//      (W = not counted) as one byte; for K1 it also moves the row to
//      its new leaf (row_goes_right on its slot's split feature) and
//      keeps it only if it lies in the slot's smaller child and in bag;
//   2. a histogram pass, one block per (feature, row range): the block
//      stages a tile of rows' (slot, bin, g, h) in shared memory and
//      adds them into a shared [W, B, 3] tile. Warp w owns the slots
//      s with s % kWarps == w. It walks the staged rows 32 at a time,
//      one row per lane; __match_any_sync groups the lanes whose rows
//      fall in the same cell, and the group's lowest lane adds the
//      group's rows to that cell in lane order. Groups of one warp
//      touch distinct cells, warps own distinct slots, and a warp's
//      32-row steps run in order, so every cell receives its rows in
//      row order;
//   3. a reduction pass adds the per-range partial tiles in range order.
//
// K1 is thus two data passes (slot, then histogram) rather than one; the
// pair is the K1 port and is timed as one. The histogram pass is bound
// by the instructions it executes, not by bytes: each of a block's
// kWarps warps looks at every staged row (a match, a compare and, for
// one lane per cell, the adds), about N * F * kWarps / 32 warp steps
// per pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 1024;   // rows staged per shared-memory tile
constexpr int kWarps = 4;         // warps per histogram block
constexpr int kMaxWave = 64;      // slot ids fit a byte, W is the dump
constexpr int kMaxBins = 256;     // bins are uint8
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr uint16_t kNone = 0xFFFF;

__host__ __device__ inline int64_t i64min(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// packed split table of K1, [kTblRows, W] int32 (ops/hist_wave.py TBL_*)
constexpr int kTblParent = 0, kTblNew = 1, kTblFeat = 2, kTblBin = 3,
              kTblDleft = 4, kTblMiss = 5, kTblDefbin = 6, kTblNumbin = 7,
              kTblSmall = 8, kTblRows = 9;

__global__ void wave_slots_kernel(const int* __restrict__ leaf,
                                  const int* __restrict__ wl, int W,
                                  int64_t n, uint8_t* __restrict__ slot) {
  __shared__ int s_wl[kMaxWave];
  for (int k = threadIdx.x; k < W; k += blockDim.x) s_wl[k] = wl[k];
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int l = leaf[i];
    int s = W;
    for (int k = 0; k < W; ++k) {
      if (s_wl[k] >= 0 && s_wl[k] == l) { s = k; break; }
    }
    slot[i] = (uint8_t)s;
  }
}

__global__ void partition_slots_kernel(const uint8_t* __restrict__ bins,
                                       const float* __restrict__ mask,
                                       const int* __restrict__ leaf,
                                       const int* __restrict__ tbl, int W,
                                       int64_t n, int* __restrict__ leaf_out,
                                       uint8_t* __restrict__ slot) {
  __shared__ int s_tbl[kTblRows * kMaxWave];
  for (int e = threadIdx.x; e < kTblRows * W; e += blockDim.x)
    s_tbl[e] = tbl[e];
  __syncthreads();
  const int* parent = s_tbl + kTblParent * W;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int l = leaf[i];
    int out = l, s = W;
    for (int k = 0; k < W; ++k) {
      if (parent[k] < 0 || parent[k] != l) continue;
      const int col = bins[(int64_t)s_tbl[kTblFeat * W + k] * n + i];
      const int miss = s_tbl[kTblMiss * W + k];
      const bool is_missing =
          (miss == kMissingNan && col == s_tbl[kTblNumbin * W + k] - 1) ||
          (miss == kMissingZero && col == s_tbl[kTblDefbin * W + k]);
      const bool right = is_missing ? s_tbl[kTblDleft * W + k] == 0
                                    : col > s_tbl[kTblBin * W + k];
      const int new_id = s_tbl[kTblNew * W + k];
      const int small = s_tbl[kTblSmall * W + k];
      if (right) out = new_id;
      if (small >= 0 && right == (small == new_id) && mask[i] > 0.0f) s = k;
      break;
    }
    leaf_out[i] = out;
    slot[i] = (uint8_t)s;
  }
}

// part[r][f][w][b][c] = sums over rows of range r in slot w with bin b
__global__ void __launch_bounds__(kWarps * 32)
slot_histogram_kernel(const uint8_t* __restrict__ bins,
                      const float* __restrict__ g,
                      const float* __restrict__ h,
                      const uint8_t* __restrict__ slot, int64_t n, int F,
                      int B, int W, int64_t rows_per_range,
                      float* __restrict__ part) {
  extern __shared__ float smem[];
  float* tile = smem;                                   // [W][B][3]
  float* s_g = tile + W * B * 3;                        // [kTileRows]
  float* s_h = s_g + kTileRows;                         // [kTileRows]
  uint16_t* s_code = (uint16_t*)(s_h + kTileRows);      // slot << 8 | bin
  const int f = blockIdx.x;
  const int r = blockIdx.y;
  const int64_t r0 = (int64_t)r * rows_per_range;
  const int64_t r1 = i64min(n, r0 + rows_per_range);
  for (int e = threadIdx.x; e < W * B * 3; e += blockDim.x) tile[e] = 0.0f;
  const uint8_t* frow = bins + (int64_t)f * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t t0 = r0; t0 < r1; t0 += kTileRows) {
    const int cnt = (int)i64min(kTileRows, r1 - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      const int64_t i = t0 + j;
      const int s = slot[i];
      s_code[j] = s < W ? (uint16_t)((s << 8) | frow[i]) : kNone;
      s_g[j] = g[i];
      s_h[j] = h[i];
    }
    __syncthreads();
    for (int base = 0; base < cnt; base += 32) {
      const int j = base + lane;
      unsigned c = j < cnt ? s_code[j] : kNone;
      if (c != kNone && (int)(c >> 8) % kWarps != warp) c = kNone;
      const unsigned same = __match_any_sync(0xFFFFFFFFu, c);
      if (c != kNone && lane == __ffs(same) - 1) {
        // this lane leads the rows of one cell: add them in row order
        float* cell = tile + ((int)(c >> 8) * B + (int)(c & 0xFF)) * 3;
        float sg = cell[0], sh = cell[1], sc = cell[2];
        for (unsigned m = same; m; m &= m - 1) {
          const int jj = base + __ffs(m) - 1;
          sg += s_g[jj];
          sh += s_h[jj];
          sc += 1.0f;
        }
        cell[0] = sg;
        cell[1] = sh;
        cell[2] = sc;
      }
    }
  }
  __syncthreads();
  float* dst = part + ((int64_t)r * F + f) * W * B * 3;
  for (int e = threadIdx.x; e < W * B * 3; e += blockDim.x) dst[e] = tile[e];
}

// out[w][f][b][c] = sum over r, in range order, of part[r][f][w][b][c]
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       int R, int F, int B, int W,
                                       float* __restrict__ out) {
  const int64_t per = (int64_t)F * W * B * 3;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < per;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % 3);
    int64_t q = e / 3;
    const int bb = (int)(q % B);
    q /= B;
    const int f = (int)(q % F);
    const int w = (int)(q / F);
    const int64_t src = (((int64_t)f * W + w) * B + bb) * 3 + c;
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) acc += part[r * per + src];
    out[e] = acc;
  }
}

int hist_smem_bytes(int W, int B) {
  return W * B * 3 * (int)sizeof(float) +
         kTileRows * (2 * (int)sizeof(float) + (int)sizeof(uint16_t));
}

int launch_histogram(const uint8_t* bins, const float* g, const float* h,
                     const uint8_t* slot, int64_t n, int F, int B, int W,
                     int R, int64_t rows_per_range, float* part, float* out,
                     cudaStream_t stream) {
  const int smem = hist_smem_bytes(W, B);
  cudaError_t err = cudaFuncSetAttribute(
      slot_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  slot_histogram_kernel<<<dim3(F, R), kWarps * 32, smem, stream>>>(
      bins, g, h, slot, n, F, B, W, rows_per_range, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t per = (int64_t)F * W * B * 3;
  const int blocks = (int)i64min((per + 255) / 256, 4096);
  reduce_partials_kernel<<<blocks, 256, 0, stream>>>(part, R, F, B, W, out);
  return (int)cudaGetLastError();
}

int row_blocks(int64_t n) {
  return (int)i64min((n + 255) / 256, 132 * 16);
}

bool bad_shape(int W, int B) {
  return W < 1 || W > kMaxWave || B < 1 || B > kMaxBins;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one histogram block asks for.
int hist_wave_smem_bytes(int W, int B) { return hist_smem_bytes(W, B); }

// K2: [W, F, B, 3] histograms of the rows whose leaf id is wl[k].
// slot: [n] scratch; part: [R, F, W, B, 3] scratch; out: [W, F, B, 3].
int wave_histogram_launch(const uint8_t* bins, const float* g,
                          const float* h, const int* leaf, const int* wl,
                          int W, long long n, int F, int B, uint8_t* slot,
                          float* part, int R, long long rows_per_range,
                          float* out, void* stream) {
  if (bad_shape(W, B)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  wave_slots_kernel<<<row_blocks(n), 256, 0, s>>>(leaf, wl, W, n, slot);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_histogram(bins, g, h, slot, n, F, B, W, R, rows_per_range,
                          part, out, s);
}

// K1: applies the wave's splits (tbl, [9, W] int32) to leaf -> leaf_out
// and builds the [W, F, B, 3] histograms of each slot's smaller child
// over in-bag rows (mask > 0).
int fused_partition_histogram_launch(const uint8_t* bins, const float* g,
                                     const float* h, const float* mask,
                                     const int* leaf, const int* tbl,
                                     int W, long long n, int F, int B,
                                     int* leaf_out, uint8_t* slot,
                                     float* part, int R,
                                     long long rows_per_range, float* out,
                                     void* stream) {
  if (bad_shape(W, B)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  partition_slots_kernel<<<row_blocks(n), 256, 0, s>>>(
      bins, mask, leaf, tbl, W, n, leaf_out, slot);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_histogram(bins, g, h, slot, n, F, B, W, R, rows_per_range,
                          part, out, s);
}

}  // extern "C"
