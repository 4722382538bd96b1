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
// Variants, as in the TPU kernels:
//   - int8 tier (K2q, K1q): g and h are int8 (quantized, |v| <= 127) and
//     the sums are exact int32, [W, F, B, C] with C = 3 (sum g, sum h,
//     count) or, in count-proxy mode, C = 2 (sum g, sum h); K1q in
//     count-proxy mode also counts each slot's in-bag rows moved right;
//   - packed4: bins are [ceil(F/2), N] bytes holding two 4-bit bins,
//     feature f in byte row f/2, low nibble when f is even. Only how a
//     bin is read changes, so a packed launch adds in the same order as
//     the unpacked one and gives the same bits;
//   - categorical rows (CAT, the TPU kernel's static any_cat,
//     hist_wave.py:838-855 and K1g :1392-1401): K1's split table grows
//     from 9 rows to 18, a categorical flag and an 8-word bitset over
//     bins per slot. A categorical slot sends a row right when its bin's
//     bit is not set, whatever the missing rule. Only the slot pass
//     reads them: the histogram passes see which slot a row lands in and
//     nothing else, so every variant of K1 takes them unchanged, and a
//     launch without categorical features (CAT = false) runs the
//     instructions it ran before.
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
// The int8 tier needs none of that: integer adds do not depend on their
// order, so its histogram pass (one block per (feature, row range), 512
// threads over the range's rows) adds each row into a shared int32
// [W, B, C] tile with shared atomics and flushes the tile's non-zero
// cells into the zeroed output with global atomics. Every launch gives
// the same bits, and so does any order of the same adds.
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
constexpr int kIntThreads = 512;  // threads per int8-tier histogram block
constexpr int kMaxWave = 64;      // slot ids fit a byte, W is the dump
constexpr int kMaxBins = 256;     // bins are uint8
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr uint16_t kNone = 0xFFFF;

__host__ __device__ inline int64_t i64min(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// feature f's bin of row i: its own byte row, or a nibble of byte row
// f/2 (low nibble for even f) when the bins are packed two per byte
template <bool PACKED>
__device__ __forceinline__ int read_bin(const uint8_t* __restrict__ bins,
                                        int f, int64_t n, int64_t i) {
  if (!PACKED) return bins[(int64_t)f * n + i];
  const int byte = bins[(int64_t)(f >> 1) * n + i];
  return (f & 1) ? byte >> 4 : byte & 15;
}

// packed split table of K1, [kTblRows, W] int32 (ops/hist_wave.py TBL_*):
// the numerical rows, then the categorical flag and bitset words (read
// only by the CAT launch, which is given all kTblRows rows)
constexpr int kTblParent = 0, kTblNew = 1, kTblFeat = 2, kTblBin = 3,
              kTblDleft = 4, kTblMiss = 5, kTblDefbin = 6, kTblNumbin = 7,
              kTblSmall = 8, kTblNumRows = 9, kTblIscat = 9, kTblCatw = 10,
              kTblRows = 18;

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

// K1's slot pass: each row's new leaf id, and its slot when it lies in
// the slot's smaller child and in bag (W otherwise). With cnt_r, also
// each slot's in-bag rows moved right (count-proxy mode), added per
// block in shared memory and then once per slot into cnt_r. With CAT,
// categorical slots decide by their left-set bitset.
template <bool PACKED, bool CAT>
__global__ void partition_slots_kernel(const uint8_t* __restrict__ bins,
                                       const float* __restrict__ mask,
                                       const int* __restrict__ leaf,
                                       const int* __restrict__ tbl, int W,
                                       int64_t n, int* __restrict__ leaf_out,
                                       uint8_t* __restrict__ slot,
                                       int* __restrict__ cnt_r) {
  constexpr int rows = CAT ? kTblRows : kTblNumRows;
  __shared__ int s_tbl[rows * kMaxWave];
  __shared__ int s_cnt[kMaxWave];
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x)
    s_tbl[e] = tbl[e];
  for (int k = threadIdx.x; k < W; k += blockDim.x) s_cnt[k] = 0;
  __syncthreads();
  const int* parent = s_tbl + kTblParent * W;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int l = leaf[i];
    int out = l, s = W;
    for (int k = 0; k < W; ++k) {
      if (parent[k] < 0 || parent[k] != l) continue;
      const int col = read_bin<PACKED>(bins, s_tbl[kTblFeat * W + k], n, i);
      const int miss = s_tbl[kTblMiss * W + k];
      const bool is_missing =
          (miss == kMissingNan && col == s_tbl[kTblNumbin * W + k] - 1) ||
          (miss == kMissingZero && col == s_tbl[kTblDefbin * W + k]);
      bool right = is_missing ? s_tbl[kTblDleft * W + k] == 0
                              : col > s_tbl[kTblBin * W + k];
      if (CAT && s_tbl[kTblIscat * W + k] != 0) {
        // the bin's bit in the slot's left set: set goes left
        const unsigned word = (unsigned)s_tbl[(kTblCatw + (col >> 5)) * W + k];
        right = ((word >> (col & 31)) & 1u) == 0u;
      }
      const int new_id = s_tbl[kTblNew * W + k];
      const int small = s_tbl[kTblSmall * W + k];
      const bool in_bag = mask[i] > 0.0f;
      if (right) out = new_id;
      if (small >= 0 && right == (small == new_id) && in_bag) s = k;
      if (cnt_r != nullptr && right && in_bag) atomicAdd(&s_cnt[k], 1);
      break;
    }
    leaf_out[i] = out;
    slot[i] = (uint8_t)s;
  }
  if (cnt_r == nullptr) return;
  __syncthreads();
  for (int k = threadIdx.x; k < W; k += blockDim.x)
    if (s_cnt[k] != 0) atomicAdd(&cnt_r[k], s_cnt[k]);
}

// part[r][f][w][b][c] = sums over rows of range r in slot w with bin b
template <bool PACKED>
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
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t t0 = r0; t0 < r1; t0 += kTileRows) {
    const int cnt = (int)i64min(kTileRows, r1 - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      const int64_t i = t0 + j;
      const int s = slot[i];
      s_code[j] = s < W
          ? (uint16_t)((s << 8) | read_bin<PACKED>(bins, f, n, i))
          : kNone;
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

// out[w][f][b][c] += the exact int32 sums of the rows of range r in slot
// w with bin b: (gq, hq, 1) for C = 3, (gq, hq) for C = 2
template <bool PACKED, int C>
__global__ void __launch_bounds__(kIntThreads)
int_histogram_kernel(const uint8_t* __restrict__ bins,
                     const int8_t* __restrict__ gq,
                     const int8_t* __restrict__ hq,
                     const uint8_t* __restrict__ slot, int64_t n, int F,
                     int B, int W, int64_t rows_per_range,
                     int* __restrict__ out) {
  extern __shared__ int itile[];                        // [W][B][C]
  const int f = blockIdx.x;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_range;
  const int64_t r1 = i64min(n, r0 + rows_per_range);
  const int cells = W * B * C;
  for (int e = threadIdx.x; e < cells; e += blockDim.x) itile[e] = 0;
  __syncthreads();
  for (int64_t i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const int s = slot[i];
    if (s >= W) continue;
    int* cell = itile + (s * B + read_bin<PACKED>(bins, f, n, i)) * C;
    atomicAdd(cell, (int)gq[i]);
    atomicAdd(cell + 1, (int)hq[i]);
    if (C == 3) atomicAdd(cell + 2, 1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cells; e += blockDim.x) {
    const int v = itile[e];
    if (v == 0) continue;
    const int c = e % C;
    const int q = e / C;
    atomicAdd(out + (((int64_t)(q / B) * F + f) * B + q % B) * C + c, v);
  }
}

int hist_smem_bytes(int W, int B) {
  return W * B * 3 * (int)sizeof(float) +
         kTileRows * (2 * (int)sizeof(float) + (int)sizeof(uint16_t));
}

int row_blocks(int64_t n) {
  return (int)i64min((n + 255) / 256, 132 * 16);
}

template <bool PACKED>
int launch_histogram_t(const uint8_t* bins, const float* g, const float* h,
                       const uint8_t* slot, int64_t n, int F, int B, int W,
                       int R, int64_t rows_per_range, float* part,
                       float* out, cudaStream_t stream) {
  const int smem = hist_smem_bytes(W, B);
  cudaError_t err = cudaFuncSetAttribute(
      slot_histogram_kernel<PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  slot_histogram_kernel<PACKED><<<dim3(F, R), kWarps * 32, smem, stream>>>(
      bins, g, h, slot, n, F, B, W, rows_per_range, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t per = (int64_t)F * W * B * 3;
  const int blocks = (int)i64min((per + 255) / 256, 4096);
  reduce_partials_kernel<<<blocks, 256, 0, stream>>>(part, R, F, B, W, out);
  return (int)cudaGetLastError();
}

int launch_histogram(bool packed, const uint8_t* bins, const float* g,
                     const float* h, const uint8_t* slot, int64_t n, int F,
                     int B, int W, int R, int64_t rows_per_range,
                     float* part, float* out, cudaStream_t stream) {
  return packed ? launch_histogram_t<true>(bins, g, h, slot, n, F, B, W, R,
                                           rows_per_range, part, out, stream)
                : launch_histogram_t<false>(bins, g, h, slot, n, F, B, W, R,
                                            rows_per_range, part, out,
                                            stream);
}

template <bool PACKED, int C>
int launch_int_t(const uint8_t* bins, const int8_t* gq, const int8_t* hq,
                 const uint8_t* slot, int64_t n, int F, int B, int W, int R,
                 int64_t rows_per_range, int* out, cudaStream_t stream) {
  const int smem = W * B * C * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      int_histogram_kernel<PACKED, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int_histogram_kernel<PACKED, C>
      <<<dim3(F, R), kIntThreads, smem, stream>>>(
          bins, gq, hq, slot, n, F, B, W, rows_per_range, out);
  return (int)cudaGetLastError();
}

// zeroes out [W, F, B, C] int32, then adds every range's tile into it
int launch_int_histogram(bool packed, int C, const uint8_t* bins,
                         const int8_t* gq, const int8_t* hq,
                         const uint8_t* slot, int64_t n, int F, int B, int W,
                         int R, int64_t rows_per_range, int* out,
                         cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)W * F * B * C * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (C == 2)
    return packed ? launch_int_t<true, 2>(bins, gq, hq, slot, n, F, B, W, R,
                                          rows_per_range, out, stream)
                  : launch_int_t<false, 2>(bins, gq, hq, slot, n, F, B, W, R,
                                           rows_per_range, out, stream);
  return packed ? launch_int_t<true, 3>(bins, gq, hq, slot, n, F, B, W, R,
                                        rows_per_range, out, stream)
                : launch_int_t<false, 3>(bins, gq, hq, slot, n, F, B, W, R,
                                         rows_per_range, out, stream);
}

template <bool PACKED, bool CAT>
void launch_partition_t(const uint8_t* bins, const float* mask,
                        const int* leaf, const int* tbl, int W, int64_t n,
                        int* leaf_out, uint8_t* slot, int* cnt_r,
                        cudaStream_t stream) {
  partition_slots_kernel<PACKED, CAT><<<row_blocks(n), 256, 0, stream>>>(
      bins, mask, leaf, tbl, W, n, leaf_out, slot, cnt_r);
}

int launch_partition(bool packed, bool any_cat, const uint8_t* bins,
                     const float* mask, const int* leaf, const int* tbl,
                     int W, int64_t n, int* leaf_out, uint8_t* slot,
                     int* cnt_r, cudaStream_t stream) {
  if (cnt_r != nullptr) {
    const cudaError_t err =
        cudaMemsetAsync(cnt_r, 0, (size_t)W * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (packed && any_cat)
    launch_partition_t<true, true>(bins, mask, leaf, tbl, W, n, leaf_out,
                                   slot, cnt_r, stream);
  else if (packed)
    launch_partition_t<true, false>(bins, mask, leaf, tbl, W, n, leaf_out,
                                    slot, cnt_r, stream);
  else if (any_cat)
    launch_partition_t<false, true>(bins, mask, leaf, tbl, W, n, leaf_out,
                                    slot, cnt_r, stream);
  else
    launch_partition_t<false, false>(bins, mask, leaf, tbl, W, n, leaf_out,
                                     slot, cnt_r, stream);
  return (int)cudaGetLastError();
}

bool bad_shape(int W, int B, bool packed) {
  return W < 1 || W > kMaxWave || B < 1 || B > (packed ? 16 : kMaxBins);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one f32 histogram block asks for.
int hist_wave_smem_bytes(int W, int B) { return hist_smem_bytes(W, B); }

// K2: [W, F, B, 3] histograms of the rows whose leaf id is wl[k].
// bins: [F, n], or [ceil(F/2), n] when packed; slot: [n] scratch;
// part: [R, F, W, B, 3] scratch; out: [W, F, B, 3].
int wave_histogram_launch(const uint8_t* bins, const float* g,
                          const float* h, const int* leaf, const int* wl,
                          int W, long long n, int F, int B, int packed,
                          uint8_t* slot, float* part, int R,
                          long long rows_per_range, float* out,
                          void* stream) {
  if (bad_shape(W, B, packed)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  wave_slots_kernel<<<row_blocks(n), 256, 0, s>>>(leaf, wl, W, n, slot);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_histogram(packed, bins, g, h, slot, n, F, B, W, R,
                          rows_per_range, part, out, s);
}

// K1: applies the wave's splits (tbl, [9, W] int32, or [18, W] with
// any_cat) to leaf -> leaf_out and builds the [W, F, B, 3] histograms of
// each slot's smaller child over in-bag rows (mask > 0).
int fused_partition_histogram_launch(const uint8_t* bins, const float* g,
                                     const float* h, const float* mask,
                                     const int* leaf, const int* tbl,
                                     int W, long long n, int F, int B,
                                     int packed, int any_cat, int* leaf_out,
                                     uint8_t* slot, float* part, int R,
                                     long long rows_per_range, float* out,
                                     void* stream) {
  if (bad_shape(W, B, packed)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_partition(packed, any_cat, bins, mask, leaf, tbl,
                                   W, n, leaf_out, slot, nullptr, s);
  if (err != 0) return err;
  return launch_histogram(packed, bins, g, h, slot, n, F, B, W, R,
                          rows_per_range, part, out, s);
}

// K2q: as K2 on int8 gq, hq; out: [W, F, B, C] int32 exact sums (C = 3:
// g, h, count; C = 2: g, h).
int wave_histogram_int_launch(const uint8_t* bins, const int8_t* gq,
                              const int8_t* hq, const int* leaf,
                              const int* wl, int W, long long n, int F,
                              int B, int C, int packed, uint8_t* slot,
                              int R, long long rows_per_range, int* out,
                              void* stream) {
  if (bad_shape(W, B, packed) || (C != 2 && C != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  wave_slots_kernel<<<row_blocks(n), 256, 0, s>>>(leaf, wl, W, n, slot);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_int_histogram(packed, C, bins, gq, hq, slot, n, F, B, W, R,
                              rows_per_range, out, s);
}

// K1q: as K1 on int8 gq, hq into [W, F, B, C] int32; with cnt_r (count
// proxy, [W] int32), also each slot's in-bag rows moved right.
int fused_partition_histogram_int_launch(
    const uint8_t* bins, const int8_t* gq, const int8_t* hq,
    const float* mask, const int* leaf, const int* tbl, int W, long long n,
    int F, int B, int C, int packed, int any_cat, int* leaf_out,
    uint8_t* slot, int* cnt_r, int R, long long rows_per_range, int* out,
    void* stream) {
  if (bad_shape(W, B, packed) || (C != 2 && C != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_partition(packed, any_cat, bins, mask, leaf, tbl,
                                   W, n, leaf_out, slot, cnt_r, s);
  if (err != 0) return err;
  return launch_int_histogram(packed, C, bins, gq, hq, slot, n, F, B, W, R,
                              rows_per_range, out, s);
}

}  // extern "C"
