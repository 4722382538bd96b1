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
//     nothing else.
//
// What bounds them on an H100: the bytes are few (each row's F bin
// bytes, g, h, leaf id, mask: ~48 B/row at 28 features, 0.16 ms per
// pass at 11M rows and 3.35 TB/s). The TPU kernel turns the scatter into
// one-hot matrix products for the MXU; the card has no such need, and
// its GPU twin adds through global f32 atomics whose order, and so whose
// rounding, changes from run to run. Here every f32 sum is taken in one
// fixed order, so that two launches on the same input give the same
// bits. What bounds the f32 pass is then not bytes but the instructions
// and latencies of those ordered adds and of staging the rows for them,
// so the design stages each row once for a group of features, drops the
// rows no slot counts before the adds, and gives every warp only rows it
// adds:
//
//   1. a slot pass, one thread per row, writes each row's wave slot
//      (W = not counted) as one byte, found through a leaf -> slot table
//      in shared memory (ids below kMapLeaves; a linear scan of the W
//      slots beyond). For K1 it also moves the row to its new leaf
//      (row_goes_right on its slot's split feature) and keeps it only if
//      it lies in the slot's smaller child and in bag;
//   2. the f32 histogram pass, group_histogram_kernel. A block walks
//      work items (feature group, row range): Fg features, whose Fg
//      [W, B, 3] tiles sit in shared memory, over one range of rows (the
//      ranges of ops/hist_wave.py row_ranges). It takes its range one
//      tile of kTileRows rows at a time:
//        a. stage: every thread loads its rows' slot, g and h into
//           registers and their Fg bins into shared memory, all loads of
//           the tile at once; __match_any_sync on each row's slot class
//           (slot % K, K a power of two) gives its rank within its
//           32-row chunk and the chunk's count per class, and one warp
//           per class scans the counts. Each counted row's g, h, slot
//           and index then go to its place in its class's list, in row
//           order; rows no slot counts stop here;
//        b. add: warp j takes the jobs (feature, class) j, j + warps, ...
//           and walks that class's list 32 rows at a time, one row per
//           lane; __match_any_sync groups the lanes whose rows fall in
//           the same cell, and the group's lowest lane adds the group's
//           rows to the cell in lane order. A job's cells are its
//           feature's cells of its class's slots, so no two warps touch
//           one cell, and every lane of a step holds a counted row.
//      A block stages a row once for Fg features. At W = 1 (K2's root
//      pass) there is one class and the jobs split by feature alone, so
//      every warp adds. The plan (Fg, K, 4, 8 or 16 warps, the ranges)
//      comes from ops/hist_wave.py hist_plan, which gives the most
//      resident warps an SM can hold within its shared memory and the
//      64 registers a thread of this kernel may use;
//   3. a reduction pass adds the per-range partial tiles in range order.
//   The grid is one wave of resident blocks
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs, from
//   ops/hist_wave.py launch_plan); the work items outnumber it (about
//   four a block) and each block loops over them.
//
// Order of addition: a cell's partial starts at 0.0f and takes its
// range's rows in row order (tiles in order; a class list keeps row
// order; a warp's 32-row steps run in order; a group adds in lane
// order), and the reduction adds the partials in range order from 0.0f.
// The plain version run on the CPU one range at a time (ops/hist_wave.py
// ``kernel_order``, ``scatter_in_ranges``) gives the same bits.
//
// The int8 tier needs none of that: integer adds do not depend on their
// order, so its histogram pass (one block per (feature, row range), 512
// threads over the range's rows) adds each row into a shared int32
// [W, B, C] tile with shared atomics and flushes the tile's non-zero
// cells into the zeroed output with global atomics. Every launch gives
// the same bits, and so does any order of the same adds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTileRows = 1024;   // rows staged per shared-memory tile
constexpr int kChunks = kTileRows / 32;
constexpr int kMaxClasses = 16;   // slot classes per feature (a power of 2)
constexpr int kIntThreads = 512;  // threads per int8-tier histogram block
constexpr int kMaxWave = 64;      // slot ids fit a byte, W is the dump
constexpr int kMaxBins = 256;     // bins are uint8
constexpr int kMapLeaves = 4096;  // leaf ids the slot passes map directly
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;

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

// fills s_map (kMapLeaves bytes) so that s_map[l] is the first slot k
// with leaf[k] == l, W for none; ends with a __syncthreads
__device__ void build_slot_map(uint8_t* s_map, const int* s_leaf, int W) {
  uint32_t* words = reinterpret_cast<uint32_t*>(s_map);
  const uint32_t none = 0x01010101u * (uint32_t)W;
  for (int e = threadIdx.x; e < kMapLeaves / 4; e += blockDim.x)
    words[e] = none;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = W - 1; k >= 0; --k) {
      const int l = s_leaf[k];
      if (l >= 0 && l < kMapLeaves) s_map[l] = (uint8_t)k;
    }
  }
  __syncthreads();
}

// the first slot whose leaf is l (W for none): the table for ids below
// kMapLeaves, a scan of the W slots above
__device__ __forceinline__ int slot_of(const uint8_t* s_map,
                                       const int* s_leaf, int W, int l) {
  if (l < 0) return W;
  if (l < kMapLeaves) return s_map[l];
  for (int k = 0; k < W; ++k)
    if (s_leaf[k] == l) return k;
  return W;
}

__global__ void wave_slots_kernel(const int* __restrict__ leaf,
                                  const int* __restrict__ wl, int W,
                                  int64_t n, uint8_t* __restrict__ slot) {
  __shared__ int s_wl[kMaxWave];
  __shared__ __align__(4) uint8_t s_map[kMapLeaves];
  for (int k = threadIdx.x; k < W; k += blockDim.x) s_wl[k] = wl[k];
  __syncthreads();
  build_slot_map(s_map, s_wl, W);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    slot[i] = (uint8_t)slot_of(s_map, s_wl, W, leaf[i]);
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
  __shared__ __align__(4) uint8_t s_map[kMapLeaves];
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x)
    s_tbl[e] = tbl[e];
  for (int k = threadIdx.x; k < W; k += blockDim.x) s_cnt[k] = 0;
  __syncthreads();
  const int* parent = s_tbl + kTblParent * W;
  build_slot_map(s_map, parent, W);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int l = leaf[i];
    int out = l, s = W;
    const int k = slot_of(s_map, parent, W, l);
    if (k < W) {
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
    }
    leaf_out[i] = out;
    slot[i] = (uint8_t)s;
  }
  if (cnt_r == nullptr) return;
  __syncthreads();
  for (int k = threadIdx.x; k < W; k += blockDim.x)
    if (s_cnt[k] != 0) atomicAdd(&cnt_r[k], s_cnt[k]);
}

// part[r][f][w][b][c] = sums over rows of range r in slot w with bin b,
// each cell in row order from 0.0f. Work item q is (range q / G, feature
// group q % G) with G = ceil(F / Fg); K slot classes (a power of two,
// K <= WARPS). A thread keeps kTileRows / (32 WARPS) rows of a tile in
// registers; the launch bounds let two (16 warps), four (8 warps) or six
// (4 warps: 8 rows a thread, 80 registers) blocks share an SM's
// registers (ops/hist_wave.py THREAD_REGISTERS).
template <bool PACKED, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 ? 6 : 32 / WARPS)
group_histogram_kernel(const uint8_t* __restrict__ bins,
                       const float* __restrict__ g,
                       const float* __restrict__ h,
                       const uint8_t* __restrict__ slot, int64_t n, int F,
                       int B, int W, int Fg, int K, int R,
                       int64_t rows_per_range, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int cells = W * B * 3;                          // one feature's tile
  float* tile = smem;                                   // [Fg][W][B][3]
  float* s_g = tile + Fg * cells;                       // [kTileRows]
  float* s_h = s_g + kTileRows;                         // [kTileRows]
  int* s_cnt = reinterpret_cast<int*>(s_h + kTileRows); // [kChunks][K]
  int* s_tot = s_cnt + kChunks * K;                     // [K]
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(s_tot + K);
  uint8_t* s_slot = reinterpret_cast<uint8_t*>(s_idx + kTileRows);
  uint8_t* s_bin = s_slot + kTileRows;                  // [Fg][kTileRows]
  constexpr int kThreads = WARPS * 32;
  constexpr int kRows = kTileRows / kThreads;           // rows per thread
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = (F + Fg - 1) / Fg;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int e = threadIdx.x; e < kChunks * K; e += kThreads) s_cnt[e] = 0;
  for (int q = blockIdx.x; q < G * R; q += gridDim.x) {
    const int r = q / G;
    const int f0 = (q - r * G) * Fg;
    const int nf = min(Fg, F - f0);
    const int64_t r0 = (int64_t)r * rows_per_range;
    const int64_t r1 = i64min(n, r0 + rows_per_range);
    __syncthreads();  // the previous item's tiles are flushed
    for (int e = threadIdx.x; e < nf * cells; e += kThreads) tile[e] = 0.0f;
    for (int64_t t0 = r0; t0 < r1; t0 += kTileRows) {
      const int cnt = (int)i64min(kTileRows, r1 - t0);
      const int rows = ((cnt + 31) >> 5) << 5;          // whole chunks
      __syncthreads();  // the previous tile's adds are done
      // a. every load of the tile at once: each row's slot, g, h (kept
      // in registers) and bins (to s_bin); each row's rank among the
      // rows of its slot class in its 32-row chunk, and each class's
      // count per chunk
      int rs[kRows], rk[kRows];
      float rg[kRows], rh[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int j = threadIdx.x + u * kThreads;
        rs[u] = W;
        if (j < rows) {
          if (j < cnt) {
            const int64_t i = t0 + j;
            rs[u] = slot[i];
            rg[u] = g[i];
            rh[u] = h[i];
            for (int fl = 0; fl < nf; ++fl)
              s_bin[fl * kTileRows + j] =
                  (uint8_t)read_bin<PACKED>(bins, f0 + fl, n, i);
          }
          const int cls = rs[u] < W ? (rs[u] & (K - 1)) : K;
          const unsigned same = __match_any_sync(0xFFFFFFFFu, cls);
          rk[u] = __popc(same & lanes_below);
          if (cls < K && rk[u] == 0) s_cnt[(j >> 5) * K + cls] = __popc(same);
        }
      }
      __syncthreads();
      // a. the block prefix, one warp per class: chunk ch's rows of class
      // c start at s_cnt[ch][c] within the class's list, which holds
      // s_tot[c] rows; the lists follow each other in class order
      if (warp < K) {
        const int v = lane < (rows >> 5) ? s_cnt[lane * K + warp] : 0;
        int incl = v;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
          if (lane >= o) incl += y;
        }
        if (lane < (rows >> 5)) s_cnt[lane * K + warp] = incl - v;
        if (lane == 31) s_tot[warp] = incl;
      }
      __syncthreads();
      // a. each counted row's g, h, slot and index to its place
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int j = threadIdx.x + u * kThreads;
        if (j < rows && rs[u] < W) {
          const int cls = rs[u] & (K - 1);
          int p = s_cnt[(j >> 5) * K + cls] + rk[u];
          for (int c = 0; c < cls; ++c) p += s_tot[c];
          s_g[p] = rg[u];
          s_h[p] = rh[u];
          s_slot[p] = (uint8_t)rs[u];
          s_idx[p] = (uint16_t)j;
        }
      }
      __syncthreads();
      // the counts are read; zero them for the next tile
      for (int e = threadIdx.x; e < kChunks * K; e += kThreads) s_cnt[e] = 0;
      // b. the adds: job (feature fl, class c) walks class c's list
      for (int job = warp; job < nf * K; job += WARPS) {
        const int fl = job / K;
        const int c = job - fl * K;
        int beg = 0;
        for (int cc = 0; cc < c; ++cc) beg += s_tot[cc];
        const int end = beg + s_tot[c];
        float* t = tile + fl * cells;
        const uint8_t* bn = s_bin + fl * kTileRows;
        for (int base = beg; base < end; base += 32) {
          const int p = base + lane;
          const int code = p < end ? (int)s_slot[p] * B + bn[s_idx[p]] : -1;
          const unsigned same = __match_any_sync(0xFFFFFFFFu, code);
          if (code >= 0 && lane == __ffs(same) - 1) {
            // this lane leads the rows of one cell: add them in row order
            float* cell = t + code * 3;
            float sg = cell[0], sh = cell[1], sc = cell[2];
            for (unsigned m = same; m; m &= m - 1) {
              const int pp = base + __ffs(m) - 1;
              sg += s_g[pp];
              sh += s_h[pp];
              sc += 1.0f;
            }
            cell[0] = sg;
            cell[1] = sh;
            cell[2] = sc;
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    float* dst = part + ((int64_t)r * F + f0) * cells;
    for (int e = threadIdx.x; e < nf * cells; e += kThreads) dst[e] = tile[e];
  }
}

// out[w][f][b][c] = sum over r, in range order from 0.0f, of
// part[r][f][w][b][c]
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
#pragma unroll 8
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

// raises a kernel's dynamic shared memory limit to kSmemMax, once per
// kernel and device (the limit is a property of the function, not of a
// launch)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done->load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess) done->fetch_or(bit);
  return err;
}

std::atomic<unsigned> g_group_smem[6];
std::atomic<unsigned> g_int_smem[4];

// events an f32 launch records on its stream when set
// (hist_wave_pass_events): before the slot pass, after it, after the
// histogram pass and after the reduction
std::atomic<void* const*> g_pass_events{nullptr};

void record_pass(int k, cudaStream_t stream) {
  void* const* events = g_pass_events.load(std::memory_order_relaxed);
  if (events != nullptr) cudaEventRecord((cudaEvent_t)events[k], stream);
}

using GroupKernel = void (*)(const uint8_t*, const float*, const float*,
                             const uint8_t*, int64_t, int, int, int, int,
                             int, int, int64_t, float*);

// the f32 histogram kernel of a launch: warps is 4, 8 or 16
template <bool PACKED>
GroupKernel group_kernel(int warps) {
  return warps == 4   ? group_histogram_kernel<PACKED, 4>
         : warps == 8 ? group_histogram_kernel<PACKED, 8>
                      : group_histogram_kernel<PACKED, 16>;
}

bool good_warps(int warps) { return warps == 4 || warps == 8 || warps == 16; }

cudaError_t allow_group_smem(bool packed, int warps) {
  const int k = 3 * (int)packed + (warps == 4 ? 0 : warps == 8 ? 1 : 2);
  return packed ? allow_smem(group_kernel<true>(warps), &g_group_smem[k])
                : allow_smem(group_kernel<false>(warps), &g_group_smem[k]);
}

int group_smem_bytes(int W, int B, int Fg, int K) {
  return Fg * W * B * 3 * (int)sizeof(float) +
         kTileRows * 2 * (int)sizeof(float) +
         (kChunks + 1) * K * (int)sizeof(int) +
         kTileRows * ((int)sizeof(uint16_t) + 1) + Fg * kTileRows;
}

int row_blocks(int64_t n) {
  return (int)i64min((n + 255) / 256, 132 * 16);
}

bool bad_plan(int F, int W, int B, int Fg, int K, int warps, int grid) {
  return Fg < 1 || Fg > F || K < 1 || K > kMaxClasses || (K & (K - 1)) ||
         !good_warps(warps) || warps < K || grid < 1 ||
         group_smem_bytes(W, B, Fg, K) > kSmemMax;
}

int launch_histogram(bool packed, const uint8_t* bins, const float* g,
                     const float* h, const uint8_t* slot, int64_t n, int F,
                     int B, int W, int Fg, int K, int warps, int grid, int R,
                     int64_t rows_per_range, float* part, float* out,
                     cudaStream_t stream) {
  const int smem = group_smem_bytes(W, B, Fg, K);
  cudaError_t err = allow_group_smem(packed, warps);
  if (err != cudaSuccess) return (int)err;
  const GroupKernel kernel =
      packed ? group_kernel<true>(warps) : group_kernel<false>(warps);
  record_pass(1, stream);
  kernel<<<grid, warps * 32, smem, stream>>>(bins, g, h, slot, n, F, B, W,
                                             Fg, K, R, rows_per_range, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  record_pass(2, stream);
  const int64_t per = (int64_t)F * W * B * 3;
  const int blocks = (int)i64min((per + 255) / 256, 4096);
  reduce_partials_kernel<<<blocks, 256, 0, stream>>>(part, R, F, B, W, out);
  record_pass(3, stream);
  return (int)cudaGetLastError();
}

template <bool PACKED, int C>
int launch_int_t(const uint8_t* bins, const int8_t* gq, const int8_t* hq,
                 const uint8_t* slot, int64_t n, int F, int B, int W, int R,
                 int64_t rows_per_range, int* out, cudaStream_t stream) {
  const int smem = W * B * C * (int)sizeof(int);
  cudaError_t err = allow_smem(int_histogram_kernel<PACKED, C>,
                               &g_int_smem[2 * PACKED + (C - 2)]);
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

// Bytes of dynamic shared memory one f32 histogram block asks for, with
// Fg features of [W, B, 3] tiles and K slot classes.
int hist_wave_smem_bytes(int W, int B, int Fg, int K) {
  return group_smem_bytes(W, B, Fg, K);
}

// Blocks of the f32 histogram pass resident on one SM with ``warps``
// warps and the shared memory of (W, B, Fg, K); 0 when none fit, -1 on
// an error.
int hist_wave_resident_blocks(int packed, int W, int B, int Fg, int K,
                              int warps) {
  if (!good_warps(warps) ||
      allow_group_smem(packed != 0, warps) != cudaSuccess)
    return -1;
  int blocks = 0;
  const GroupKernel kernel =
      packed ? group_kernel<true>(warps) : group_kernel<false>(warps);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, warps * 32, group_smem_bytes(W, B, Fg, K));
  return err == cudaSuccess ? blocks : -1;
}

// Sets (events: 4 cudaEvent_t) or clears (nullptr) the events every f32
// launch records at its pass boundaries, for timing the passes apart.
void hist_wave_pass_events(void* const* events) {
  g_pass_events.store(events);
}

// K2: [W, F, B, 3] histograms of the rows whose leaf id is wl[k].
// bins: [F, n], or [ceil(F/2), n] when packed; slot: [n] scratch;
// part: [R, F, W, B, 3] scratch; out: [W, F, B, 3]. The histogram pass
// runs ``grid`` blocks of ``warps`` warps over groups of Fg features and
// K slot classes (ops/hist_wave.py hist_plan).
int wave_histogram_launch(const uint8_t* bins, const float* g,
                          const float* h, const int* leaf, const int* wl,
                          int W, long long n, int F, int B, int packed,
                          int Fg, int K, int warps, int grid, uint8_t* slot,
                          float* part, int R, long long rows_per_range,
                          float* out, void* stream) {
  if (bad_shape(W, B, packed) || bad_plan(F, W, B, Fg, K, warps, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  record_pass(0, s);
  wave_slots_kernel<<<row_blocks(n), 256, 0, s>>>(leaf, wl, W, n, slot);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_histogram(packed, bins, g, h, slot, n, F, B, W, Fg, K,
                          warps, grid, R, rows_per_range, part, out, s);
}

// K1: applies the wave's splits (tbl, [9, W] int32, or [18, W] with
// any_cat) to leaf -> leaf_out and builds the [W, F, B, 3] histograms of
// each slot's smaller child over in-bag rows (mask > 0).
int fused_partition_histogram_launch(
    const uint8_t* bins, const float* g, const float* h, const float* mask,
    const int* leaf, const int* tbl, int W, long long n, int F, int B,
    int packed, int any_cat, int Fg, int K, int warps, int grid,
    int* leaf_out, uint8_t* slot, float* part, int R,
    long long rows_per_range, float* out, void* stream) {
  if (bad_shape(W, B, packed) || bad_plan(F, W, B, Fg, K, warps, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  record_pass(0, s);
  const int err = launch_partition(packed, any_cat, bins, mask, leaf, tbl,
                                   W, n, leaf_out, slot, nullptr, s);
  if (err != 0) return err;
  return launch_histogram(packed, bins, g, h, slot, n, F, B, W, Fg, K,
                          warps, grid, R, rows_per_range, part, out, s);
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
