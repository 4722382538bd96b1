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
//      [W, B] tiles (g and h in double, a count) sit in shared memory,
//      over one range of rows (the ranges of ops/hist_wave.py
//      row_ranges). It takes its range one tile of kTileRows rows at a
//      time:
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
// Order of addition: a cell's partial starts at 0.0 and takes its
// range's rows in row order (tiles in order; a class list keeps row
// order; a warp's 32-row steps run in order; a group adds in lane
// order), g and h in double, rounded once to f32 at the end of the
// range; the count is an integer. The reduction adds the f32 partials in
// range order from 0.0 in double and rounds once. A range holds up to
// ~10^5 rows of a cell: summed in f32 one after another, their rounding
// errors lean one way where g takes few values (binary logloss's first
// iteration) and a cell's sum drifted by 1.5e-3 of itself on a one-hot
// column's zero bin; in double each cell stays within about 2^-24 of
// its sum of |g| (two f32 roundings). The shared-memory tile is 20 bytes
// a cell (two doubles and a count) against 12 for three f32 sums. The
// plain version run on the CPU one range at a time in float64
// (ops/hist_wave.py ``kernel_order``, ``scatter_in_ranges``) gives the
// same bits.
//
// The int8 tier needs no fixed order: integer adds give the same bits in
// any order, so its pass adds with shared atomics. What bounds it is
// staging and the latency of the adds, not bytes: each row's F bin
// bytes, gq, hq and slot byte (~31 B a row at 28 features) are read, a
// few hundred MB a launch, and the counted rows' adds are few. Its
// histogram pass, int_group_histogram_kernel:
//   - gives a block of 16 warps a unit, a group of Fg features and a
//     slot class c (the slots s with s % K == c, K a power of two), and
//     a part of the rows. The unit's tile of C planes of [Fg][W/K][B]
//     int32 cells stays in shared memory while the block walks its rows,
//     and is written out once, as the item's partial tile. Each unit
//     reads every row's slot, gq and hq again, so the plan takes the
//     largest groups the tile allows: Fg up to 8 (16 packed) features;
//   - lets each warp walk its own steps of 256 rows, 8 a lane, with no
//     block barrier: the slot, gq, hq and each bin byte row as one 8-byte
//     load a lane (byte loads where an array is not 8-byte aligned, and
//     for a part's ragged end), the next step's loads issued before this
//     step's adds;
//   - has each lane add its own counted rows (slot < W, class c) from
//     registers. Compacting the counted rows into a shared list first,
//     and grouping a warp's lanes by cell with __match_any_sync, both
//     measured slower on the H100 (PERF.md);
//   - keeps ``copies`` copies of each cell side by side, lane l adding
//     into copy l % copies: where a feature's tile is small (the root
//     pass at W = 1), a warp's lanes would otherwise meet on one cell,
//     by chance or because most rows share a bin, and wait on each
//     other;
//   - a reduction pass (the flush) adds the items' partial tiles into
//     the [W, F, B, C] output, every cell written.
// The grid is one wave of resident blocks; the plan (Fg, K, copies, row
// parts) is ops/hist_wave.py int_plan, a pure function of the shapes,
// and the grid its launch_int_plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTileRows = 1024;   // rows staged per shared-memory tile
constexpr int kChunks = kTileRows / 32;
constexpr int kMaxClasses = 16;   // slot classes per feature (a power of 2)
constexpr int kIntWarps = 16;     // warps per int8-tier histogram block
constexpr int kIntThreads = kIntWarps * 32;
constexpr int kIntLaneRows = 8;   // rows a lane loads a step: 8-byte vectors
constexpr int kIntStep = 32 * kIntLaneRows;  // rows a warp takes a step
constexpr int kIntByteRows = 8;   // bin byte rows a block stages
constexpr int kIntCopies = 16;    // most copies of a cell
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
// block in shared memory, each lane into its own counter of the slot (so
// the lanes of a warp never add to one address), and then once per slot
// into cnt_r. With CAT, categorical slots decide by their left-set
// bitset.
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
  __shared__ int s_cnt[kMaxWave * 32];     // [slot][lane]
  __shared__ __align__(4) uint8_t s_map[kMapLeaves];
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x)
    s_tbl[e] = tbl[e];
  if (cnt_r != nullptr)
    for (int e = threadIdx.x; e < W * 32; e += blockDim.x) s_cnt[e] = 0;
  __syncthreads();
  const int* parent = s_tbl + kTblParent * W;
  build_slot_map(s_map, parent, W);
  const int lane = threadIdx.x & 31;
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
      if (cnt_r != nullptr && right && in_bag)
        atomicAdd(&s_cnt[k * 32 + lane], 1);
    }
    leaf_out[i] = out;
    slot[i] = (uint8_t)s;
  }
  if (cnt_r == nullptr) return;
  __syncthreads();
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    int v = 0;
    for (int j = 0; j < 32; ++j) v += s_cnt[k * 32 + ((j + k) & 31)];
    if (v != 0) atomicAdd(&cnt_r[k], v);
  }
}

// part[r][f][w][b][c] = sums over rows of range r in slot w with bin b,
// each cell's g and h in row order from 0.0 in double and rounded once to
// f32, its count an integer. Work item q is (range q / (G S), slot part
// (q / G) % S, feature group q % G) with G = ceil(F / Fg): a part holds
// Wp = ceil(W / S) consecutive slots, S > 1 only where Fg = 1 of all W
// slots overflows shared memory; K slot classes of a part's slots (a
// power of two, K <= WARPS). A thread keeps kTileRows / (32 WARPS) rows of a tile in
// registers; the launch bounds let two (16 warps), four (8 warps) or six
// (4 warps: 8 rows a thread, 80 registers) blocks share an SM's
// registers (ops/hist_wave.py THREAD_REGISTERS).
template <bool PACKED, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 ? 6 : 32 / WARPS)
group_histogram_kernel(const uint8_t* __restrict__ bins,
                       const float* __restrict__ g,
                       const float* __restrict__ h,
                       const uint8_t* __restrict__ slot, int64_t n, int F,
                       int B, int W, int Fg, int K, int S, int R,
                       int64_t rows_per_range, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Wp = (W + S - 1) / S;                       // slots a part
  const int cells = Wp * B;                             // one feature's
  double2* tile = reinterpret_cast<double2*>(smem);     // [Fg][W][B] g, h
  double* s_g = reinterpret_cast<double*>(tile + Fg * cells);  // [kTileRows]
  double* s_h = s_g + kTileRows;                        // [kTileRows]
  unsigned* tile_n = reinterpret_cast<unsigned*>(s_h + kTileRows);
  int* s_cnt = reinterpret_cast<int*>(tile_n + Fg * cells);  // [kChunks][K]
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
  for (int q = blockIdx.x; q < G * S * R; q += gridDim.x) {
    const int r = q / (G * S);
    const int sp = (q / G) % S;
    const int f0 = (q % G) * Fg;
    const int nf = min(Fg, F - f0);
    const int s0 = sp * Wp;                              // the part's slots
    const int wn = min(Wp, W - s0);                      // s0 .. s0 + wn - 1
    const int64_t r0 = (int64_t)r * rows_per_range;
    const int64_t r1 = i64min(n, r0 + rows_per_range);
    __syncthreads();  // the previous item's tiles are flushed
    for (int e = threadIdx.x; e < nf * cells; e += kThreads) {
      tile[e] = make_double2(0.0, 0.0);
      tile_n[e] = 0u;
    }
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
        rs[u] = wn;                                     // not counted
        if (j < rows) {
          if (j < cnt) {
            const int64_t i = t0 + j;
            const int ls = (int)slot[i] - s0;          // the part's slot
            rs[u] = ls >= 0 && ls < wn ? ls : wn;
            rg[u] = g[i];
            rh[u] = h[i];
            for (int fl = 0; fl < nf; ++fl)
              s_bin[fl * kTileRows + j] =
                  (uint8_t)read_bin<PACKED>(bins, f0 + fl, n, i);
          }
          const int cls = rs[u] < wn ? (rs[u] & (K - 1)) : K;
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
      // a. each counted row's g, h (widened to double once), slot and
      // index to its place
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int j = threadIdx.x + u * kThreads;
        if (j < rows && rs[u] < wn) {
          const int cls = rs[u] & (K - 1);
          int p = s_cnt[(j >> 5) * K + cls] + rk[u];
          for (int c = 0; c < cls; ++c) p += s_tot[c];
          s_g[p] = (double)rg[u];
          s_h[p] = (double)rh[u];
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
        double2* t = tile + fl * cells;
        unsigned* tn = tile_n + fl * cells;
        const uint8_t* bn = s_bin + fl * kTileRows;
        for (int base = beg; base < end; base += 32) {
          const int p = base + lane;
          const int code = p < end ? (int)s_slot[p] * B + bn[s_idx[p]] : -1;
          const unsigned same = __match_any_sync(0xFFFFFFFFu, code);
          if (code >= 0 && lane == __ffs(same) - 1) {
            // this lane leads the rows of one cell: add them in row order
            double2 sum = t[code];
            for (unsigned m = same; m; m &= m - 1) {
              const int pp = base + __ffs(m) - 1;
              sum.x += s_g[pp];
              sum.y += s_h[pp];
            }
            t[code] = sum;
            tn[code] += (unsigned)__popc(same);
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    const int per_f = wn * B * 3;              // one feature's part cells
    for (int e = threadIdx.x; e < nf * per_f; e += kThreads) {
      const int fl = e / per_f, k = e - fl * per_f;
      const int cell = fl * cells + k / 3, ch = k % 3;
      const double2 v = tile[cell];
      part[(((int64_t)r * F + f0 + fl) * W + s0) * B * 3 + k] =
          ch == 0 ? (float)v.x : ch == 1 ? (float)v.y : (float)tile_n[cell];
    }
  }
}

// out[w][f][b][c] = sum over r, in range order from 0.0 in double,
// of part[r][f][w][b][c], rounded once to f32
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
    double acc = 0.0;
#pragma unroll 8
    for (int r = 0; r < R; ++r) acc += (double)part[r * per + src];
    out[e] = (float)acc;
  }
}

// 8 bytes from p[i, i + valid): one vector load when VEC (p + i 8-byte
// aligned) and the 8 are all there, else byte loads; missing bytes 0
template <bool VEC>
__device__ __forceinline__ uint2 load8(const uint8_t* __restrict__ p,
                                       int64_t i, int valid) {
  if (VEC && valid == kIntLaneRows)
    return __ldg(reinterpret_cast<const uint2*>(p + i));
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int u = 0; u < kIntLaneRows; ++u)
    if (u < valid) w[u >> 2] |= (uint32_t)__ldg(p + i + u) << (8 * (u & 3));
  return make_uint2(w[0], w[1]);
}

// byte u (a constant once unrolled) of an 8-byte vector
__device__ __forceinline__ int byte_of(const uint2& v, int u) {
  return (int)(((u < 4 ? v.x : v.y) >> (8 * (u & 3))) & 0xFFu);
}

// one lane's rows of a warp step: slot, gq, hq and the group's NR bin
// byte rows
template <int NR>
struct IntRows {
  uint2 s, g, h, b[NR];
};

// feature fl's bin (fl, u constants once unrolled) in row u of a lane's
// rows: its own byte row, or a nibble of byte row fl / 2 when packed
template <bool PACKED, int NR>
__device__ __forceinline__ int bin_of(const IntRows<NR>& r, int fl, int u) {
  return PACKED ? (byte_of(r.b[fl >> 1], u) >> (4 * (fl & 1))) & 15
                : byte_of(r.b[fl], u);
}

template <bool VEC, int NR>
__device__ __forceinline__ void load_rows(IntRows<NR>& r,
                                          const uint8_t* __restrict__ slot,
                                          const uint8_t* __restrict__ g8,
                                          const uint8_t* __restrict__ h8,
                                          const uint8_t* __restrict__ brow,
                                          int64_t n, int nrows, int64_t i,
                                          int valid) {
  r.s = load8<VEC>(slot, i, valid);
  r.g = load8<VEC>(g8, i, valid);
  r.h = load8<VEC>(h8, i, valid);
#pragma unroll
  for (int j = 0; j < NR; ++j)
    r.b[j] = j < nrows ? load8<VEC>(brow + (int64_t)j * n, i, valid)
                       : make_uint2(0u, 0u);
}

// Dynamic shared memory of one int8-tier histogram block: the unit's
// tile, C planes of [Fg][ceil(W/K)][B] int32 cells with ``copies`` copies
// of each cell side by side.
__host__ __device__ inline int int_smem_bytes(int W, int B, int C, int Fg,
                                              int K, int copies) {
  return copies * C * Fg * ((W + K - 1) / K) * B * (int)sizeof(int);
}

// part[q] = the exact int32 sums of work item q = (row part r, unit u),
// q = r * U + u: the rows of part r in unit u's slots (class c = u % K,
// slot s at s / K) and features (group u / K: features f0 .. f0 + Fg),
// (gq, hq, 1) for C = 3, (gq, hq) for C = 2, laid out [Fg][W/K][B][C]
// (a short last group leaves its missing features' cells unwritten).
// Each warp takes steps of kIntStep rows of the part, kIntLaneRows a
// lane, independently of the other warps: it loads the next step's rows
// while it adds this step's, each lane its own counted rows. Lane l adds
// into copy l % copies of a cell, the copies of a cell in consecutive
// banks, so that lanes of different copies never wait on one another.
template <bool PACKED, int C, bool VEC, int NR, int MINB>
__global__ void __launch_bounds__(kIntThreads, MINB)
int_group_histogram_kernel(const uint8_t* __restrict__ bins,
                           const int8_t* __restrict__ gq,
                           const int8_t* __restrict__ hq,
                           const uint8_t* __restrict__ slot, int64_t n,
                           int F, int B, int W, int Fg, int K, int copies,
                           int P, int64_t rows_per_part,
                           int* __restrict__ part) {
  constexpr int kGroup = PACKED ? 2 * NR : NR;
  extern __shared__ int ismem[];
  const int Wc = (W + K - 1) / K;
  const int fcells = Wc * B;                 // a feature's cells a channel
  const int plane = Fg * fcells;             // a channel's cells
  int* tile = ismem;                         // [C][Fg][Wc][B][copies]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int U = (F + Fg - 1) / Fg * K;
  const int shift = __ffs(K) - 1;            // log2 K
  const int mine = lane & (copies - 1);
  const int cstride = copies * plane;        // between channels
  const uint8_t* g8 = reinterpret_cast<const uint8_t*>(gq);
  const uint8_t* h8 = reinterpret_cast<const uint8_t*>(hq);
  for (int q = blockIdx.x; q < U * P; q += gridDim.x) {
    const int r = q / U;
    const int grp = (q - r * U) >> shift;
    const int c = (q - r * U) & (K - 1);
    const int f0 = grp * Fg;                 // even when PACKED
    const int nf = min(Fg, F - f0);
    const int nrows = PACKED ? (nf + 1) >> 1 : nf;
    const uint8_t* brow = bins + (int64_t)(PACKED ? f0 >> 1 : f0) * n;
    const int64_t r0 = (int64_t)r * rows_per_part;
    const int64_t r1 = i64min(n, r0 + rows_per_part);
    __syncthreads();  // the previous item's tile is written out
    for (int e = threadIdx.x; e < copies * C * plane; e += kIntThreads)
      tile[e] = 0;
    __syncthreads();
    int64_t s0 = r0 + (int64_t)warp * kIntStep;
    IntRows<NR> cur;
    if (s0 < r1) {
      const int64_t i = s0 + lane * kIntLaneRows;
      load_rows<VEC, NR>(cur, slot, g8, h8, brow, n, nrows, i,
                         (int)i64min(kIntLaneRows, i < r1 ? r1 - i : 0));
    }
    for (; s0 < r1; s0 += (int64_t)kIntWarps * kIntStep) {
      // a. the next step's loads, in flight while this step is added
      const int64_t s1 = s0 + (int64_t)kIntWarps * kIntStep;
      IntRows<NR> nxt;
      if (s1 < r1) {
        const int64_t i = s1 + lane * kIntLaneRows;
        load_rows<VEC, NR>(nxt, slot, g8, h8, brow, n, nrows, i,
                           (int)i64min(kIntLaneRows, i < r1 ? r1 - i : 0));
      }
      // b. each lane adds its own rows that the unit counts (slot < W,
      // in class c)
      const int64_t i = s0 + lane * kIntLaneRows;
      const int valid = (int)i64min(kIntLaneRows, i < r1 ? r1 - i : 0);
#pragma unroll
      for (int u = 0; u < kIntLaneRows; ++u) {
        const int sl = byte_of(cur.s, u);
        if (u < valid && sl < W && (sl & (K - 1)) == c) {
          const int gv = (int)(int8_t)byte_of(cur.g, u);
          const int hv = (int)(int8_t)byte_of(cur.h, u);
          const int sb = (sl >> shift) * B;
#pragma unroll
          for (int fl = 0; fl < kGroup; ++fl) {
            if (fl < nf) {
              const int at =
                  (fl * fcells + sb + bin_of<PACKED, NR>(cur, fl, u)) *
                      copies +
                  mine;
              atomicAdd(tile + at, gv);
              atomicAdd(tile + at + cstride, hv);
              if (C == 3) atomicAdd(tile + at + 2 * cstride, 1);
            }
          }
        }
      }
      cur = nxt;
    }
    __syncthreads();
    // the item's partial tile, [Fg][Wc][B][C]: each cell's copies added
    int* dst = part + (int64_t)q * C * plane;
    for (int e = threadIdx.x; e < nf * fcells * C; e += kIntThreads) {
      const int* src = tile + (e % C) * cstride + e / C * copies;
      int v = 0;
      for (int k = 0; k < copies; ++k) v += src[(k + e) & (copies - 1)];
      dst[e] = v;
    }
  }
}

// the flush: out[w][f][b][ch] = the sum over row parts r of the partial
// tiles' cell (feature f, slot w, bin b, channel ch)
__global__ void reduce_int_partials_kernel(const int* __restrict__ part,
                                           int P, int F, int B, int W,
                                           int C, int Fg, int K,
                                           int* __restrict__ out) {
  const int Wc = (W + K - 1) / K;
  const int64_t ucells = (int64_t)Fg * Wc * B * C;
  const int64_t U = (int64_t)(F + Fg - 1) / Fg * K;
  const int shift = __ffs(K) - 1;
  const int64_t per = (int64_t)W * F * B * C;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < per;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int ch = (int)(e % C);
    int64_t q = e / C;
    const int b = (int)(q % B);
    q /= B;
    const int f = (int)(q % F);
    const int w = (int)(q / F);
    const int grp = f / Fg;
    const int64_t u = (int64_t)grp * K + (w & (K - 1));
    const int64_t src = u * ucells +
                        (((int64_t)(f - grp * Fg) * Wc + (w >> shift)) * B +
                         b) * C + ch;
    int acc = 0;
#pragma unroll 4
    for (int r = 0; r < P; ++r) acc += part[r * U * ucells + src];
    out[e] = acc;
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
std::atomic<unsigned> g_int_smem[32];

// events a launch records on its stream when set
// (hist_wave_pass_events): before the slot pass, after it, after the
// histogram pass and after the reduction (the int8 tier's flush)
std::atomic<void* const*> g_pass_events{nullptr};

void record_pass(int k, cudaStream_t stream) {
  void* const* events = g_pass_events.load(std::memory_order_relaxed);
  if (events != nullptr) cudaEventRecord((cudaEvent_t)events[k], stream);
}

using GroupKernel = void (*)(const uint8_t*, const float*, const float*,
                             const uint8_t*, int64_t, int, int, int, int,
                             int, int, int, int64_t, float*);

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
  return Fg * W * B * (2 * (int)sizeof(double) + (int)sizeof(unsigned)) +
         kTileRows * 2 * (int)sizeof(double) +
         (kChunks + 1) * K * (int)sizeof(int) +
         kTileRows * ((int)sizeof(uint16_t) + 1) + Fg * kTileRows;
}

int row_blocks(int64_t n) {
  return (int)i64min((n + 255) / 256, 132 * 16);
}

// a slot part's slots: ceil(W / S)
int part_slots(int W, int S) { return (W + S - 1) / S; }

bool bad_plan(int F, int W, int B, int Fg, int K, int S, int warps,
              int grid) {
  return Fg < 1 || Fg > F || K < 1 || K > kMaxClasses || (K & (K - 1)) ||
         S < 1 || S > W || !good_warps(warps) || warps < K || grid < 1 ||
         group_smem_bytes(part_slots(W, S), B, Fg, K) > kSmemMax;
}

int launch_histogram(bool packed, const uint8_t* bins, const float* g,
                     const float* h, const uint8_t* slot, int64_t n, int F,
                     int B, int W, int Fg, int K, int S, int warps,
                     int grid, int R, int64_t rows_per_range, float* part,
                     float* out, cudaStream_t stream) {
  const int smem = group_smem_bytes(part_slots(W, S), B, Fg, K);
  cudaError_t err = allow_group_smem(packed, warps);
  if (err != cudaSuccess) return (int)err;
  const GroupKernel kernel =
      packed ? group_kernel<true>(warps) : group_kernel<false>(warps);
  record_pass(1, stream);
  kernel<<<grid, warps * 32, smem, stream>>>(bins, g, h, slot, n, F, B, W,
                                             Fg, K, S, R, rows_per_range,
                                             part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  record_pass(2, stream);
  const int64_t per = (int64_t)F * W * B * 3;
  const int blocks = (int)i64min((per + 255) / 256, 4096);
  reduce_partials_kernel<<<blocks, 256, 0, stream>>>(part, R, F, B, W, out);
  record_pass(3, stream);
  return (int)cudaGetLastError();
}

using IntKernel = void (*)(const uint8_t*, const int8_t*, const int8_t*,
                           const uint8_t*, int64_t, int, int, int, int, int,
                           int, int, int64_t, int*);

template <bool PACKED, bool VEC, int NR, int MINB>
IntKernel int_kernel_c(int C) {
  return C == 2 ? int_group_histogram_kernel<PACKED, 2, VEC, NR, MINB>
                : int_group_histogram_kernel<PACKED, 3, VEC, NR, MINB>;
}

template <int NR, int MINB>
IntKernel int_kernel_m(bool packed, int C, bool vec) {
  if (packed) return vec ? int_kernel_c<true, true, NR, MINB>(C)
                         : int_kernel_c<true, false, NR, MINB>(C);
  return vec ? int_kernel_c<false, true, NR, MINB>(C)
             : int_kernel_c<false, false, NR, MINB>(C);
}

// the instance of the plan's byte rows (kIntByteRows / 2 or kIntByteRows)
// and blocks an SM (1: 128 registers a thread, 2: 64)
int int_instance(int byte_rows, int blocks) {
  return 2 * (int)(byte_rows == kIntByteRows) + (int)(blocks == 2);
}

IntKernel int_kernel(bool packed, int C, bool vec, int byte_rows,
                     int blocks) {
  switch (int_instance(byte_rows, blocks)) {
    case 0: return int_kernel_m<kIntByteRows / 2, 1>(packed, C, vec);
    case 1: return int_kernel_m<kIntByteRows / 2, 2>(packed, C, vec);
    case 2: return int_kernel_m<kIntByteRows, 1>(packed, C, vec);
    default: return int_kernel_m<kIntByteRows, 2>(packed, C, vec);
  }
}

cudaError_t allow_int_smem(bool packed, int C, bool vec, int byte_rows,
                           int blocks) {
  return allow_smem(int_kernel(packed, C, vec, byte_rows, blocks),
                    &g_int_smem[8 * int_instance(byte_rows, blocks) +
                                4 * (int)packed + 2 * (int)vec + (C - 2)]);
}

// vec asks for 8-byte loads: every array and bin row must allow them (a
// single bin row of any length does: its ragged end takes byte loads)
bool bad_vec(bool vec, const void* bins, const void* gq, const void* hq,
             int64_t n, int rows) {
  const auto off = [](const void* p) { return (uintptr_t)p % kIntLaneRows; };
  return vec && (off(bins) || off(gq) || off(hq) ||
                 (rows > 1 && n % kIntLaneRows));
}

bool bad_int_plan(int F, int W, int B, int C, bool packed, int Fg, int K,
                  int copies, int byte_rows, int blocks, int P,
                  int64_t rows_per_part, int grid) {
  const int most = packed ? 2 * byte_rows : byte_rows;
  return (C != 2 && C != 3) ||
         (byte_rows != kIntByteRows / 2 && byte_rows != kIntByteRows) ||
         (blocks != 1 && blocks != 2) || Fg < 1 || Fg > F || Fg > most ||
         (packed && (Fg & 1) && Fg < F) || K < 1 || K > kMaxClasses ||
         (K & (K - 1)) || copies < 1 || copies > kIntCopies ||
         (copies & (copies - 1)) || P < 1 || grid < 1 ||
         rows_per_part < 1 || rows_per_part % kIntLaneRows ||
         int_smem_bytes(W, B, C, Fg, K, copies) > kSmemMax;
}

// the int8 tier's histogram pass over the rows' slots, then its flush,
// which writes every cell of out [W, F, B, C]
int launch_int_histogram(bool packed, int C, bool vec, const uint8_t* bins,
                         const int8_t* gq, const int8_t* hq,
                         const uint8_t* slot, int64_t n, int F, int B, int W,
                         int Fg, int K, int copies, int byte_rows,
                         int blocks, int grid, int P, int64_t rows_per_part,
                         int* part, int* out, cudaStream_t stream) {
  const int smem = int_smem_bytes(W, B, C, Fg, K, copies);
  cudaError_t err = allow_int_smem(packed, C, vec, byte_rows, blocks);
  if (err != cudaSuccess) return (int)err;
  const IntKernel kernel = int_kernel(packed, C, vec, byte_rows, blocks);
  record_pass(1, stream);
  kernel<<<grid, kIntThreads, smem, stream>>>(bins, gq, hq, slot, n, F, B, W,
                                              Fg, K, copies, P,
                                              rows_per_part, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  record_pass(2, stream);
  const int64_t per = (int64_t)W * F * B * C;
  const int flush = (int)i64min((per + 255) / 256, 4096);
  reduce_int_partials_kernel<<<flush, 256, 0, stream>>>(part, P, F, B, W, C,
                                                        Fg, K, out);
  record_pass(3, stream);
  return (int)cudaGetLastError();
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
// Fg features of [W, B] tiles (W the slots of a slot part) and K slot
// classes.
int hist_wave_smem_bytes(int W, int B, int Fg, int K) {
  return group_smem_bytes(W, B, Fg, K);
}

// Blocks of the f32 histogram pass resident on one SM with ``warps``
// warps and the shared memory of (W, B, Fg, K), W the slots of a part;
// 0 when none fit, -1 on an error.
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

// Bytes of dynamic shared memory one int8-tier histogram block asks
// for: ``copies`` tiles of Fg features, ceil(W / K) slots, B bins and C
// channels.
int hist_wave_int_smem_bytes(int W, int B, int C, int Fg, int K,
                             int copies) {
  return int_smem_bytes(W, B, C, Fg, K, copies);
}

// Blocks of the int8-tier histogram pass resident on one SM with that
// shared memory, in the kernel's instance of ``byte_rows`` bin byte rows
// and the registers of ``blocks`` blocks an SM; 0 when none fit, -1 on an
// error.
int hist_wave_int_resident_blocks(int packed, int C, int vec, int W, int B,
                                  int Fg, int K, int copies, int byte_rows,
                                  int blocks) {
  const int smem = int_smem_bytes(W, B, C, Fg, K, copies);
  if ((C != 2 && C != 3) ||
      (byte_rows != kIntByteRows / 2 && byte_rows != kIntByteRows) ||
      (blocks != 1 && blocks != 2) ||
      allow_int_smem(packed != 0, C, vec != 0, byte_rows, blocks) !=
          cudaSuccess)
    return -1;
  int got = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &got, int_kernel(packed != 0, C, vec != 0, byte_rows, blocks),
      kIntThreads, smem);
  return err == cudaSuccess ? got : -1;
}

// Sets (events: 4 cudaEvent_t) or clears (nullptr) the events every
// launch records at its pass boundaries, for timing the passes apart.
void hist_wave_pass_events(void* const* events) {
  g_pass_events.store(events);
}

// K2: [W, F, B, 3] histograms of the rows whose leaf id is wl[k].
// bins: [F, n], or [ceil(F/2), n] when packed; slot: [n] scratch;
// part: [R, F, W, B, 3] scratch; out: [W, F, B, 3]. The histogram pass
// runs ``grid`` blocks of ``warps`` warps over groups of Fg features, S
// parts of the slots and K slot classes (ops/hist_wave.py hist_plan).
int wave_histogram_launch(const uint8_t* bins, const float* g,
                          const float* h, const int* leaf, const int* wl,
                          int W, long long n, int F, int B, int packed,
                          int Fg, int K, int S, int warps, int grid,
                          uint8_t* slot, float* part, int R,
                          long long rows_per_range, float* out,
                          void* stream) {
  if (bad_shape(W, B, packed) ||
      bad_plan(F, W, B, Fg, K, S, warps, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  record_pass(0, s);
  wave_slots_kernel<<<row_blocks(n), 256, 0, s>>>(leaf, wl, W, n, slot);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_histogram(packed, bins, g, h, slot, n, F, B, W, Fg, K, S,
                          warps, grid, R, rows_per_range, part, out, s);
}

// K1: applies the wave's splits (tbl, [9, W] int32, or [18, W] with
// any_cat) to leaf -> leaf_out and builds the [W, F, B, 3] histograms of
// each slot's smaller child over in-bag rows (mask > 0).
int fused_partition_histogram_launch(
    const uint8_t* bins, const float* g, const float* h, const float* mask,
    const int* leaf, const int* tbl, int W, long long n, int F, int B,
    int packed, int any_cat, int Fg, int K, int S, int warps, int grid,
    int* leaf_out, uint8_t* slot, float* part, int R,
    long long rows_per_range, float* out, void* stream) {
  if (bad_shape(W, B, packed) ||
      bad_plan(F, W, B, Fg, K, S, warps, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  record_pass(0, s);
  const int err = launch_partition(packed, any_cat, bins, mask, leaf, tbl,
                                   W, n, leaf_out, slot, nullptr, s);
  if (err != 0) return err;
  return launch_histogram(packed, bins, g, h, slot, n, F, B, W, Fg, K, S,
                          warps, grid, R, rows_per_range, part, out, s);
}

// K2q: as K2 on int8 gq, hq; out: [W, F, B, C] int32 exact sums (C = 3:
// g, h, count; C = 2: g, h). The histogram pass runs ``grid`` blocks over
// P row parts of ``rows_per_part`` rows (a multiple of 8) and units of Fg
// features and one of K slot classes, with ``copies`` copies of each
// cell, in the kernel's instance of ``byte_rows`` (4 or 8) bin byte rows
// a group and ``blocks`` (1 or 2) blocks an SM (ops/hist_wave.py
// int_plan); vec: bins, gq, hq and every bin row (n % 8 == 0, or one
// row) 8-byte aligned, read 8 bytes at a time.
// part: [P, ceil(F / Fg) * K, Fg, ceil(W / K), B, C] int32 scratch.
int wave_histogram_int_launch(const uint8_t* bins, const int8_t* gq,
                              const int8_t* hq, const int* leaf,
                              const int* wl, int W, long long n, int F,
                              int B, int C, int packed, int vec, int Fg,
                              int K, int copies, int byte_rows, int blocks,
                              int grid, uint8_t* slot, int* part, int P,
                              long long rows_per_part, int* out,
                              void* stream) {
  if (bad_shape(W, B, packed) ||
      bad_int_plan(F, W, B, C, packed, Fg, K, copies, byte_rows, blocks, P,
                   rows_per_part, grid) ||
      bad_vec(vec != 0, bins, gq, hq, n, packed ? (F + 1) / 2 : F))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  record_pass(0, s);
  wave_slots_kernel<<<row_blocks(n), 256, 0, s>>>(leaf, wl, W, n, slot);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_int_histogram(packed, C, vec != 0, bins, gq, hq, slot, n, F,
                              B, W, Fg, K, copies, byte_rows, blocks, grid,
                              P, rows_per_part, part, out, s);
}

// K1q: as K1 on int8 gq, hq into [W, F, B, C] int32; with cnt_r (count
// proxy, [W] int32), also each slot's in-bag rows moved right. The plan
// arguments as for K2q.
int fused_partition_histogram_int_launch(
    const uint8_t* bins, const int8_t* gq, const int8_t* hq,
    const float* mask, const int* leaf, const int* tbl, int W, long long n,
    int F, int B, int C, int packed, int any_cat, int vec, int Fg, int K,
    int copies, int byte_rows, int blocks, int grid, int* leaf_out,
    uint8_t* slot, int* cnt_r, int* part, int P, long long rows_per_part,
    int* out, void* stream) {
  if (bad_shape(W, B, packed) ||
      bad_int_plan(F, W, B, C, packed, Fg, K, copies, byte_rows, blocks, P,
                   rows_per_part, grid) ||
      bad_vec(vec != 0, bins, gq, hq, n, packed ? (F + 1) / 2 : F))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  record_pass(0, s);
  const int err = launch_partition(packed, any_cat, bins, mask, leaf, tbl,
                                   W, n, leaf_out, slot, cnt_r, s);
  if (err != 0) return err;
  return launch_int_histogram(packed, C, vec != 0, bins, gq, hq, slot, n, F,
                              B, W, Fg, K, copies, byte_rows, blocks, grid,
                              P, rows_per_part, part, out, s);
}

}  // extern "C"
