// Forest traversal for Hopper (sm_90a): the port's counterpart of the JAX
// package's fused forest kernel, lightgbm_tpu/ops/stacked_predict.py:1048
// forest_predict_pallas (TPU) and :1157 forest_predict_pallas_gpu (its
// Pallas-Triton twin).
//
// What it computes: per row, per tree t of [first, last) in model order,
// the leaf the row reaches and, in score mode, the f32 sum of those
// leaves' values per class (tree t belongs to class t % K); in leaf mode
// the leaf indices, out[row, t - first]. Inputs: the feature-major
// global bin codes [F, N] int32 that the host or the device binning
// produced, and the compact tables ops/stacked_predict.py
// ``compact_tables`` builds from the per-node decision rows (and checks,
// every node at every code, against them):
//   feat [Fu] int4: per feature the walk reads, its row of codes, its
//        code offset, its width w and its zero band (lo | hi << 16, or
//        -1). A row's codes are staged as local codes; the last code
//        (NaN, or a categorical feature's negative/NaN code) as kNan,
//        the band as kBand, every other code as itself.
//   rec  [C, S, 32] records, tree-interleaved: record s of tree 32c + j
//        at [c, s, j]. 8 bytes: children as int16 (node, or ~leaf), the
//        byte offset of the node's feature in a staged row, and meta;
//        16 bytes where a model outgrows those fields (Rec8, Rec16).
//        meta: the decisions of kNan and kBand, whether the node is a
//        bitset row, and the threshold (left iff code < it) or the bitset
//        row's word offset within the tree's words (bits_base[t]).
//   leaf [C, L, 32] f32 leaf values, interleaved the same way; root [T].
//   In the model's last chunk, when it holds m <= 16 trees, column j >= m
//   holds a copy of tree j % m (``tail``).
//
// What bounds it: N * T * depth dependent lookups (record, then the
// row's code of the record's feature), not bytes (4F bytes read and 4K
// written a row). The TPU kernel turned the walk into two one-hot matrix
// products because a TPU has no cheap gather; at the HIGGS shape those
// products alone are ~1.7e16 int8 operations, so here the walk stays a
// walk, laid out so that every lookup is a conflict-free shared-memory
// load:
//   - one lane per tree: a warp takes the 32 trees of a chunk for its
//     rows. Record s of lane j sits at slot s * 32 + j, so a lane only
//     ever reads its own bank pair, whichever node it is at;
//   - a block stages its tile's rows as u8 or u16 local codes, row-major,
//     so the lanes on one row read that row's few words (a broadcast);
//   - a chunk (records, and in score mode its leaf values) arrives by a
//     TMA bulk copy that completes on an mbarrier: a forest that fits is
//     loaded once a block; a larger one streams through a ring of
//     ``buffers`` slots (the plan takes one: each chunk loads after the
//     last is walked; two, the next chunk loading while this one is
//     walked, read slower: PERF.md); a tree too large for shared memory
//     is read from global memory (``buffers`` 0);
//   - 32 warps a block: each step is a chain of two dependent
//     shared-memory loads, and the measured time falls inversely with
//     the warps in flight;
//   - ordered sums: each lane writes its tree's leaf value for each row
//     of a batch into the warp's [batch, 32] buffer, and one lane per
//     row then adds the chunk's values in model order into the row's
//     sum for class t % K (shared memory, carried across the chunks), so
//     the f32 sums have exactly ops/forest.py forest_predict_plain's
//     order, and its bits.
//
// K4 from rows (forest_predict_from_x_launch; the JAX package's
// forest_predict_from_x, lightgbm_tpu/ops/stacked_predict.py:906, and its
// Pallas-Triton twin forest_predict_from_x_gpu, :1204): the same walk,
// whose tile staging bins f32 rows [n, x_cols] itself instead of loading
// global codes. Per (row, feature) it takes the global code the device
// binning of ops/stacked_predict.py ``codes_from_x`` gives: NaN to the
// feature's nan_slot, else off32 plus the count of the feature's f32
// edges below the value (a binary search over its inf-padded sorted row
// of edges [F, m_edges], read through the read-only data cache), then the
// same local code as the codes path. One launch replaces the transpose,
// searchsorted, where and K4 launches, and the [F, n] int32 codes never
// reach device memory: a row's bytes are 4 x_cols read once. Threads
// stage row-major (consecutive threads on one row's features), so the
// loads of a warp fall on a row's few cache lines.
//
// The launch plan (rows a tile, warps, batch, chunk slots, grid) is
// ops/forest.py ``forest_plan``; this library takes it as given, checks
// it (cudaErrorInvalidValue), and reports the plan's shared memory and
// resident blocks (forest_smem_bytes, forest_resident_blocks).
//
// Built by nvcc into a shared library with a plain C interface (ops/forest.py
// loads it with ctypes). Each entry launches on the stream it is given,
// on the calling thread's current device (the caller makes the tensors'
// device current), allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kLanes = 32;      // trees a chunk: one lane each
constexpr int kMaxWarps = 32;   // the launch bounds: 1024 threads
constexpr int kSmemMax = 232448;
constexpr int kStageLoads = 8;  // code loads in flight a thread

__host__ __device__ inline int pad16(long long b) {
  return (int)((b + 15) & ~15LL);
}

// bytes of one staged row: Fu codes, padded to a word
__host__ __device__ inline int row_bytes(int fu, int code_bytes) {
  return (fu * code_bytes + 3) & ~3;
}

// bytes of one chunk: 32 trees' records, and their leaf values in score
// mode
__host__ __device__ inline long long chunk_bytes(int s, int l, int rec_bytes,
                                                 int score) {
  return (long long)kLanes * ((long long)s * rec_bytes + (score ? 4LL * l : 0));
}

// dynamic shared memory, in this order: chunk slots, their mbarriers,
// the rows' sums (score mode), the rows' codes, the warps' buffers
struct Layout {
  long long bars, acc, codes, bufs, total;
};

__host__ __device__ inline Layout layout(int s, int l, int fu, int k,
                                         int code_bytes, int rec_bytes,
                                         int score, int warps, int batch,
                                         int rows, int buffers) {
  Layout o;
  o.bars = buffers * chunk_bytes(s, l, rec_bytes, score);
  o.acc = o.bars + pad16(buffers * 8LL);
  o.codes = o.acc + (score ? pad16((long long)rows * k * 4) : 0);
  o.bufs = o.codes + pad16((long long)rows * row_bytes(fu, code_bytes));
  o.total = o.bufs + (long long)warps * batch * kLanes * 4;
  return o;
}

struct Args {
  const int* codes;            // [F, n] global bin codes (codes launches)
  const float* x;              // [n, x_cols] f32 rows (from-rows launches)
  const float* edges;          // [F, m_edges] f32 edges, sorted, inf-padded
  const int* off32;            // [F] a feature's first global code
  const int* nan_slot;         // [F] a feature's NaN code
  int x_cols, m_edges;
  const int4* feat;            // [Fu]
  const unsigned char* rec;    // [C, S, 32] records
  const float* leafv;          // [C, L, 32]
  const uint32_t* bits;        // bitset words
  const int* bits_base;        // [T] a tree's first word
  const int* root;             // [T] 0, or -1 (~0) for a single leaf
  void* out;                   // [n, K] f32 or [n, last - first] int32
  long long n;
  int first, last, k, s, l, fu, score, rec_bytes;
  int tail, tail_chunk;   // trees of the model's last chunk whose columns
                          // are copied into its spare ones (0: none)
  int warps, batch, rows, buffers, chunk0, nch, tiles;
};

// A record's fields. 8 bytes: children as int16 in x (left low), and in
// y the byte offset of the node's feature in a staged row (low 16 bits)
// and meta (high 16); 16 bytes: left, right, offset, meta. meta: bit 0
// the kNan decision, bit 1 the kBand decision, bit 2 a bitset node,
// bits 3+ the threshold (left iff code < it) or the bitset row's word
// offset in the tree's words.
struct Rec8 {
  using Raw = uint2;
  __device__ static __forceinline__ uint32_t offset(uint2 r) {
    return r.y & 0xFFFFu;
  }
  __device__ static __forceinline__ uint32_t meta(uint2 r) {
    return r.y >> 16;
  }
  __device__ static __forceinline__ int child(uint2 r, bool left) {
    return (int)(left ? r.x << 16 : r.x) >> 16;
  }
};

struct Rec16 {
  using Raw = int4;
  __device__ static __forceinline__ uint32_t offset(int4 r) {
    return (uint32_t)r.z;
  }
  __device__ static __forceinline__ uint32_t meta(int4 r) {
    return (uint32_t)r.w;
  }
  __device__ static __forceinline__ int child(int4 r, bool left) {
    return left ? r.x : r.y;
  }
};

template <typename Code>
struct Reserved {
  static constexpr unsigned kNan = (1u << (8 * sizeof(Code))) - 1;
  static constexpr unsigned kBand = kNan - 1;
};

// One step from ``node``: its record (``recs``: the lane's column of the
// chunk, record s at recs[s * 32]), the row's staged code of its feature,
// the child that code takes. The common case is one compare; a reserved
// code or a bitset node takes a branch that is seldom taken (a form
// without the branch, every case computed and selected, ran 1.6x
// slower: PERF.md).
template <typename Code, typename Rec, bool G>
__device__ __forceinline__ int step(const typename Rec::Raw* recs, int node,
                                    const unsigned char* row,
                                    const uint32_t* tbits) {
  const typename Rec::Raw r = G ? __ldg(recs + node * kLanes)
                                : recs[node * kLanes];
  const unsigned c = *reinterpret_cast<const Code*>(row + Rec::offset(r));
  const uint32_t meta = Rec::meta(r);
  bool left = c < (meta >> 3);
  if (c >= Reserved<Code>::kBand || (meta & 4u)) {   // seldom taken
    if (c >= Reserved<Code>::kBand)
      left = (meta >> (Reserved<Code>::kNan - c)) & 1u;
    else
      left = (__ldg(tbits + (meta >> 3) + (c >> 5)) >> (c & 31)) & 1u;
  }
  return Rec::child(r, left);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one chunk (c of the range) into its slot, completing on the slot's
// mbarrier; thread 0 only
template <typename Rec>
__device__ void issue_chunk(const Args& a, unsigned char* slot, uint64_t* bar,
                            int c) {
  const int rbytes = kLanes * a.s * (int)sizeof(typename Rec::Raw);
  const int lbytes = a.score ? kLanes * a.l * 4 : 0;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(rbytes + lbytes)
               : "memory");
  const long long ch = a.chunk0 + c;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slot)),
      "l"((unsigned long long)(a.rec + ch * rbytes)), "r"(rbytes),
      "r"(smem_addr(bar))
      : "memory");
  if (lbytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slot + rbytes)),
        "l"((unsigned long long)(
            reinterpret_cast<const unsigned char*>(a.leafv) + ch * lbytes)),
        "r"(lbytes), "r"(smem_addr(bar))
        : "memory");
}

// This warp's rows of the tile, through the chunk's 32 trees (lane j:
// tree t0 + j), a batch at a time: the lanes walk each row of the batch
// in step (a lane that reaches its leaf waits for the deepest), then the
// ordered sums (or the leaf indices written out). In the model's last
// chunk, when it holds m <= 16 trees and the range takes all of them,
// its spare columns hold copies of the m trees, and lane j walks tree
// j % m for row j / m of each group of 32 / m rows. Lanes that moved on to
// the batch's next row as soon as their tree ended ran 1.4x slower at
// the HIGGS shape (their code loads conflict, and each step needs more
// instructions): PERF.md.
template <typename Code, typename Rec, bool G>
__device__ __forceinline__ void walk_chunk(
    const Args& a, const typename Rec::Raw* recs, const float* leafv,
    const unsigned char* codes, int stride, float* acc, uint32_t* buf,
    int rw, long long row0, int t0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int jlo = max(a.first - t0, 0), jhi = min(a.last - t0, kLanes);
  int col = lane, group = 0, groups = 1;   // tree column, row in a group
  if (a.tail && t0 == a.tail_chunk * kLanes && jlo == 0 && jhi == a.tail) {
    groups = kLanes / a.tail;
    col = lane % a.tail;
    group = lane / a.tail;
  }
  const bool on = t0 + col >= a.first && t0 + col < a.last && group < groups;
  const int root = on ? __ldg(a.root + t0 + col) : -1;
  const uint32_t* tbits = a.bits + (on ? __ldg(a.bits_base + t0 + col) : 0);
  const typename Rec::Raw* mine = recs + lane;   // this lane's column
  for (int sb = 0; sb < rw; sb += a.batch) {
    const int r0 = warp * rw + sb;   // the batch's first row in the tile
    for (int i0 = 0; i0 < a.batch; i0 += groups) {
      const int i = min(i0 + group, a.batch - 1);
      const unsigned char* row = codes + (long long)(r0 + i) * stride;
      int node = i0 + group < a.batch ? root : -1;
      while (node >= 0) node = step<Code, Rec, G>(mine, node, row, tbits);
      const int lf = ~node;
      if (on && i0 + group < a.batch)
        buf[i * kLanes + (col ^ i)] =
            a.score ? __float_as_uint(G ? __ldg(leafv + lf * kLanes + lane)
                                        : leafv[lf * kLanes + lane])
                    : (uint32_t)lf;
    }
    __syncwarp();
    if (a.score) {
      // lane i adds row i's values in model order, class by class
      if (lane < a.batch) {
        float* ar = acc + (long long)(r0 + lane) * a.k;
        const uint32_t* br = buf + lane * kLanes;
        const int jend = min(jlo + a.k, jhi);
        for (int js = jlo; js < jend; ++js) {
          const int cls = (t0 + js) % a.k;
          float sum = ar[cls];
          for (int j = js; j < jhi; j += a.k)
            sum = __fadd_rn(sum, __uint_as_float(br[j ^ lane]));
          ar[cls] = sum;
        }
      }
    } else if (lane >= jlo && lane < jhi) {
      // a row's trees are consecutive ints of the output
      int* o = static_cast<int*>(a.out);
      const long long nt = a.last - a.first;
      for (int i = 0; i < a.batch; ++i) {
        const long long row = row0 + r0 + i;
        if (row < a.n)
          o[row * nt + (t0 + lane - a.first)] =
              (int)buf[i * kLanes + (lane ^ i)];
      }
    }
    __syncwarp();
  }
}

// A global code of feature f (row of ``feat``) as the staged local code:
// the last code kNan, the zero band kBand, every other code itself; a row
// past the end (INT_MIN) is walked and never written out.
template <typename Code>
__device__ __forceinline__ Code local_code(const Args& a, int f, int global) {
  if (global == INT_MIN) return (Code)0;
  const int4 ft = __ldg(a.feat + f);
  const int c = min(max(global - ft.y, 0), ft.z - 1);
  return (Code)(c == ft.z - 1 ? Reserved<Code>::kNan
                : ft.w >= 0 && c >= (ft.w & 0xFFFF) && c <= (ft.w >> 16)
                    ? Reserved<Code>::kBand
                    : (unsigned)c);
}

// stage the tile's codes from global codes: feature-major loads (a warp
// reads 32 consecutive rows of a feature), eight in flight a thread;
// row-major local codes
template <typename Code>
__device__ __forceinline__ void stage_codes(const Args& a,
                                            unsigned char* codes, int stride,
                                            long long row0) {
  for (int base = threadIdx.x; base < a.fu * a.rows;
       base += kStageLoads * blockDim.x) {
    int got[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = base + u * blockDim.x;
      const int f = idx / a.rows;
      const long long row = row0 + (idx - f * a.rows);
      got[u] = idx < a.fu * a.rows && row < a.n
                   ? __ldg(a.codes + (long long)__ldg(&a.feat[f].x) * a.n +
                           row)
                   : INT_MIN;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx >= a.fu * a.rows) break;
      const int f = idx / a.rows, r = idx - f * a.rows;
      reinterpret_cast<Code*>(codes + r * stride)[f] =
          local_code<Code>(a, f, got[u]);
    }
  }
}

// stage the tile's codes from f32 rows, binned here (codes_from_x's
// codes): row-major loads, eight in flight a thread
template <typename Code>
__device__ __forceinline__ void stage_rows(const Args& a,
                                           unsigned char* codes, int stride,
                                           long long row0) {
  for (int base = threadIdx.x; base < a.fu * a.rows;
       base += kStageLoads * blockDim.x) {
    float got[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = base + u * blockDim.x;
      const int r = idx / max(a.fu, 1);
      const long long row = row0 + r;
      got[u] = idx < a.fu * a.rows && row < a.n
                   ? __ldg(a.x + row * a.x_cols +
                           __ldg(&a.feat[idx - r * a.fu].x))
                   : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx >= a.fu * a.rows) break;
      const int r = idx / a.fu, f = idx - r * a.fu;
      int global = INT_MIN;
      if (row0 + r < a.n) {
        const int g = __ldg(&a.feat[f].x);
        const float v = got[u];
        if (isnan(v)) {
          global = __ldg(a.nan_slot + g);
        } else {
          // edges below v: the left insertion point in the sorted row
          const float* e = a.edges + (long long)g * a.m_edges;
          int lo = 0, hi = a.m_edges;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__ldg(e + mid) < v)
              lo = mid + 1;
            else
              hi = mid;
          }
          global = __ldg(a.off32 + g) + lo;
        }
      }
      reinterpret_cast<Code*>(codes + r * stride)[f] =
          local_code<Code>(a, f, global);
    }
  }
}

template <typename Code, typename Rec, bool STAGED>
__device__ void run(const Args& a, unsigned char* smem) {
  using Raw = typename Rec::Raw;
  const Layout lay = layout(a.s, a.l, a.fu, a.k, (int)sizeof(Code),
                            (int)sizeof(Raw), a.score, a.warps, a.batch,
                            a.rows, a.buffers);
  const long long cbytes =
      chunk_bytes(a.s, a.l, (int)sizeof(Raw), a.score);
  const int rbytes = kLanes * a.s * (int)sizeof(Raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  unsigned char* codes = smem + lay.codes;
  const int stride = row_bytes(a.fu, (int)sizeof(Code));   // bytes a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* buf =
      reinterpret_cast<uint32_t*>(smem + lay.bufs) + warp * a.batch * kLanes;
  const int rw = a.rows / a.warps;
  const bool resident = a.buffers >= a.nch;
  const int my_tiles =
      (a.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const long long items = resident ? a.nch : (long long)my_tiles * a.nch;

  if constexpr (STAGED) {
    if (threadIdx.x == 0) {
      for (int b = 0; b < a.buffers; ++b) mbar_init(&bars[b]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (long long q = 0; q < items && q < a.buffers; ++q)
        issue_chunk<Rec>(a, smem + q * cbytes, &bars[q], (int)(q % a.nch));
  }

  for (int it = 0; it < my_tiles; ++it) {
    const long long row0 =
        ((long long)blockIdx.x + (long long)it * gridDim.x) * a.rows;
    __syncthreads();   // the last tile's codes and sums are read no more
    if (a.x)
      stage_rows<Code>(a, codes, stride, row0);
    else
      stage_codes<Code>(a, codes, stride, row0);
    if (a.score)
      for (int i = threadIdx.x; i < a.rows * a.k; i += blockDim.x) acc[i] = 0.f;
    __syncthreads();

    for (int c = 0; c < a.nch; ++c) {
      const long long q = resident ? c : (long long)it * a.nch + c;
      const int t0 = (a.chunk0 + c) * kLanes;
      if constexpr (STAGED) {
        const long long slot = resident ? c : q % a.buffers;
        mbar_wait(&bars[slot],
                  resident ? 0u : (uint32_t)((q / a.buffers) & 1));
        const unsigned char* base = smem + slot * cbytes;
        walk_chunk<Code, Rec, false>(
            a, reinterpret_cast<const Raw*>(base),
            reinterpret_cast<const float*>(base + rbytes), codes, stride,
            acc, buf, rw, row0, t0);
        if (!resident) {
          __syncthreads();   // every warp is done with the slot
          if (threadIdx.x == 0 && q + a.buffers < items) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            issue_chunk<Rec>(a, smem + slot * cbytes, &bars[slot],
                             (int)((q + a.buffers) % a.nch));
          }
        }
      } else {
        const long long ch = a.chunk0 + c;
        walk_chunk<Code, Rec, true>(
            a, reinterpret_cast<const Raw*>(a.rec + ch * rbytes),
            a.leafv + ch * a.l * kLanes, codes, stride, acc, buf, rw, row0,
            t0);
      }
    }
    if (a.score) {
      // this warp's rows' sums, K consecutive floats a row
      float* o = static_cast<float*>(a.out);
      const long long first_row = row0 + (long long)warp * rw;
      for (int i = lane; i < rw * a.k; i += kLanes)
        if (first_row + i / a.k < a.n)
          o[first_row * a.k + i] = acc[(long long)warp * rw * a.k + i];
    }
  }
}

template <typename Code>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
    forest_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (a.rec_bytes == 8) {
    if (a.buffers)
      run<Code, Rec8, true>(a, smem);
    else
      run<Code, Rec8, false>(a, smem);
  } else {
    if (a.buffers)
      run<Code, Rec16, true>(a, smem);
    else
      run<Code, Rec16, false>(a, smem);
  }
}

using Kernel = void (*)(const Args);

Kernel kernel_for(int code_bytes) {
  return code_bytes == 1   ? forest_kernel<uint8_t>
         : code_bytes == 2 ? forest_kernel<uint16_t>
                           : nullptr;
}

std::atomic<unsigned> g_smem_allowed[2];

// raises the kernel's dynamic shared memory limit to kSmemMax, once per
// kernel and device (the limit is a property of the function)
cudaError_t allow_smem(int code_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<unsigned>* done = &g_smem_allowed[code_bytes - 1];
  const unsigned bit = 1u << (dev & 31);
  if (done->load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_for(code_bytes),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess) done->fetch_or(bit);
  return err;
}

bool bad_shape(int s, int l, int fu, int k, int code_bytes, int rec_bytes,
               int score, int warps, int batch, int rows, int buffers) {
  if (s < 1 || l < 1 || fu < 0 || k < 1 || warps < 1 || warps > kMaxWarps ||
      batch < 1 || batch > kLanes || rows < warps * batch ||
      rows % (warps * batch) || buffers < 0 ||
      (code_bytes != 1 && code_bytes != 2) ||
      (rec_bytes != 8 && rec_bytes != 16))
    return true;
  return layout(s, l, fu, k, code_bytes, rec_bytes, score, warps, batch,
                rows, buffers)
             .total > kSmemMax;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the plan asks for; -1 for
// a plan outside the kernel's limits.
int forest_smem_bytes(int s, int l, int fu, int k, int code_bytes,
                      int rec_bytes, int score, int warps, int batch,
                      int rows, int buffers) {
  if (bad_shape(s, l, fu, k, code_bytes, rec_bytes, score != 0, warps, batch,
                rows, buffers))
    return -1;
  return (int)layout(s, l, fu, k, code_bytes, rec_bytes, score != 0, warps,
                     batch, rows, buffers)
      .total;
}

// Blocks of ``warps`` warps and ``smem`` bytes resident on one SM; 0 when
// none fit, -1 on an error.
int forest_resident_blocks(int code_bytes, int warps, int smem) {
  if (!kernel_for(code_bytes) || warps < 1 || warps > kMaxWarps ||
      smem < 0 || smem > kSmemMax || allow_smem(code_bytes) != cudaSuccess)
    return -1;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_for(code_bytes), warps * kLanes, smem);
  return err == cudaSuccess ? blocks : -1;
}

}  // extern "C"

namespace {

// The launch shared by both entries: ``a`` holds the inputs (codes, or
// rows and their binning tables); the rest is the plan.
int launch(Args a, const void* feat, const void* rec, const void* leafv,
           const void* bits, const void* bits_base, const void* root,
           void* out, long long n, int first, int last, int k, int s, int l,
           int fu, int tail, int trees, int score, int code_bytes,
           int rec_bytes, int warps, int batch, int rows, int buffers,
           int grid, void* stream) {
  if (n < 1 || first < 0 || last <= first || last > trees || tail < 0 ||
      tail > kLanes / 2 || (tail && (trees - 1) % kLanes + 1 != tail) ||
      bad_shape(s, l, fu, k, code_bytes, rec_bytes, score != 0, warps, batch,
                rows, buffers))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + rows - 1) / rows;
  if (grid < 1 || grid > tiles || tiles > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(code_bytes);
  if (err != cudaSuccess) return (int)err;
  a.feat = static_cast<const int4*>(feat);
  a.rec = static_cast<const unsigned char*>(rec);
  a.leafv = static_cast<const float*>(leafv);
  a.bits = static_cast<const uint32_t*>(bits);
  a.bits_base = static_cast<const int*>(bits_base);
  a.root = static_cast<const int*>(root);
  a.out = out;
  a.n = n;
  a.first = first;
  a.last = last;
  a.k = k;
  a.s = s;
  a.l = l;
  a.fu = fu;
  a.score = score != 0;
  a.rec_bytes = rec_bytes;
  a.tail = tail;
  a.tail_chunk = (trees - 1) / kLanes;
  a.warps = warps;
  a.batch = batch;
  a.rows = rows;
  a.buffers = buffers;
  a.chunk0 = first / kLanes;
  a.nch = (last - 1) / kLanes - a.chunk0 + 1;
  a.tiles = (int)tiles;
  const int smem = (int)layout(s, l, fu, k, code_bytes, rec_bytes, a.score,
                               warps, batch, rows, buffers)
                       .total;
  kernel_for(code_bytes)<<<grid, warps * kLanes, smem,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Trees [first, last) over n rows of codes: [n, K] f32 scores (score
// != 0) or [n, last - first] int32 leaf indices into ``out``, by the
// plan (code_bytes, warps, batch, rows, buffers, grid) of ops/forest.py
// forest_plan.
int forest_predict_launch(const void* codes, const void* feat,
                          const void* rec, const void* leafv,
                          const void* bits, const void* bits_base,
                          const void* root, void* out, long long n,
                          int first, int last, int k, int s, int l, int fu,
                          int tail, int trees, int score, int code_bytes,
                          int rec_bytes, int warps, int batch, int rows,
                          int buffers, int grid, void* stream) {
  Args a = {};
  a.codes = static_cast<const int*>(codes);
  return launch(a, feat, rec, leafv, bits, bits_base, root, out, n, first,
                last, k, s, l, fu, tail, trees, score, code_bytes, rec_bytes,
                warps, batch, rows, buffers, grid, stream);
}

// The same over n f32 rows [n, x_cols], binned in the tile staging by
// the device-binning tables (edges [F, m_edges], off32 [F], nan_slot
// [F]): the plan is forest_plan's for the codes of those rows.
int forest_predict_from_x_launch(
    const void* x, int x_cols, const void* edges, int m_edges,
    const void* off32, const void* nan_slot, const void* feat,
    const void* rec, const void* leafv, const void* bits,
    const void* bits_base, const void* root, void* out, long long n,
    int first, int last, int k, int s, int l, int fu, int tail, int trees,
    int score, int code_bytes, int rec_bytes, int warps, int batch, int rows,
    int buffers, int grid, void* stream) {
  if (x_cols < 1 || m_edges < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = static_cast<const float*>(x);
  a.x_cols = x_cols;
  a.edges = static_cast<const float*>(edges);
  a.m_edges = m_edges;
  a.off32 = static_cast<const int*>(off32);
  a.nan_slot = static_cast<const int*>(nan_slot);
  return launch(a, feat, rec, leafv, bits, bits_base, root, out, n, first,
                last, k, s, l, fu, tail, trees, score, code_bytes, rec_bytes,
                warps, batch, rows, buffers, grid, stream);
}

}  // extern "C"
