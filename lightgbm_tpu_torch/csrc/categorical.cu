// The categorical split search's candidate tables for Hopper (sm_90a):
// ops/split.py ``categorical_gains``, inside ``_categorical_tables``.
//
// It replaces no TPU kernel: the JAX package computes these tables in
// XLA (lightgbm_tpu/ops/split.py:256-380 ``_categorical_tables``), which
// fuses them into its split search. The port's plain PyTorch version
// (``categorical_gains_plain``) takes about 360 small launches a wave for
// them: the one-hot gains with their emulated fused multiply-adds, the
// k-vs-rest scan's blocked prefix sums (``xla_cumsum``, 15 sequential
// adds a block of 16 and a carry scan), min_data_per_group's sequential
// emit loop over the P sorted positions, the right side's prefix mask
// and the k-vs-rest gains. One launch does all of it: the first blocks
// take one (direction, leaf, feature) row a thread and walk its P
// positions in the same order (the channels' prefix sums by XLA's blocks:
// f32 adds in sequence within a block of 16, each block then adding the
// running total of the blocks before it, itself summed in sequence; the
// left and right sides' checks; the emit loop, its count restarting at
// each emitted candidate; each position's gain), the other blocks one
// (leaf, feature, bin) one-hot candidate a thread. Each gain is
// ``_fused_leaf_gain``'s: one __fmaf_rn where XLA contracts, every other
// step an explicitly rounded operation, so nvcc contracts nothing: the
// plain version's bits.
//
// What bounds it: nothing on this card at these shapes (2 x 2W x F rows
// of P <= 256 positions and 2W x F x B bins, a few hundred KB); it
// exists to take ~320 launches out of every wave with categorical
// features.
//
// Built by nvcc into a shared library with a plain C interface, loaded
// with ctypes by ops/split.py; the entry launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;     // XLA's CPU cumsum block (split.py)
constexpr int kMaxP = 256;     // positions: P <= B <= 256
constexpr int kThreads = 128;

struct Params {
  float l1, l2c, l2n, mds, eps, mdl, msh, mdpg;
  int use_mds, max_cat;
};

// ops/split.py threshold_l1: sign(s) * max(|s| - l1, 0), the sign of a
// zero (or NaN) being +0 and a NaN kept, as torch's sign and clamp do
__device__ __forceinline__ float threshold_l1(float s, float l1) {
  const float sgn = (float)((0.f < s) - (s < 0.f));
  float r = __fsub_rn(fabsf(s), l1);
  r = r < 0.f ? 0.f : r;
  return __fmul_rn(sgn, r);
}

// ops/split.py _fused_leaf_gain: the leaf output, then the gain with
// ``2 g * out`` contracted into one fused multiply-add, every other
// step rounded on its own
__device__ __forceinline__ float fused_leaf_gain(float g, float h,
                                                 const Params& q,
                                                 float l2) {
  const float t = threshold_l1(g, q.l1);
  const float hl2 = __fadd_rn(h, l2);
  float out = __fdiv_rn(-t, hl2);
  if (q.use_mds) out = out < -q.mds ? -q.mds : (out > q.mds ? q.mds : out);
  const float c = __fmul_rn(__fmul_rn(hl2, out), out);
  return -__fmaf_rn(__fmul_rn(2.f, t), out, c);
}

struct Args {
  const float* hist;            // [M, F, B, 3]: g, h, count of each bin
  const float* srt;             // [2, M, F, P, 3]: sorted, zero past used
  float* cum;                   // [2, M, F, P, 3] out
  float* gain;                  // [2, M, F, P] out
  float* gain_o;                // [M, F, B] out
  const float* sum_g;           // [M] each leaf's totals
  const float* sum_h2;          // [M] (+ 2 kEpsilon)
  const float* num_data;        // [M]
  const float* min_gain_shift;  // [M]
  const int* used;              // [M, F] eligible bins (k-vs-rest)
  const uint8_t* sorted_ok;     // [M, F] the k-vs-rest mode may split
  const int* used_bin;          // [F] bins below it are candidates
  const uint8_t* onehot_ok;     // [M, F] the one-hot mode may split
  long long rows;               // 2 M F scan rows
  int M, F, B, P, scan_blocks;
};

// one (leaf, feature, bin): the one-hot candidate, the bin alone going
// left, with plain l2
__device__ __forceinline__ void onehot(const Args& a, const Params& q,
                                       long long i) {
  if (i >= (long long)a.M * a.F * a.B) return;
  const int b = (int)(i % a.B);
  const int mf = (int)(i / a.B);
  const int m = mf / a.F, f = mf % a.F;
  const float g = a.hist[i * 3], h = a.hist[i * 3 + 1], c = a.hist[i * 3 + 2];
  const float lh = __fadd_rn(h, q.eps);
  const float rh = __fsub_rn(a.sum_h2[m], lh);
  const float rc = __fsub_rn(a.num_data[m], c);
  const float rg = __fsub_rn(a.sum_g[m], g);
  const float gn = __fadd_rn(fused_leaf_gain(g, lh, q, q.l2n),
                             fused_leaf_gain(rg, rh, q, q.l2n));
  const bool ok = b < a.used_bin[f] && c >= q.mdl && h >= q.msh &&
                  rc >= q.mdl && rh >= q.msh && gn > a.min_gain_shift[m] &&
                  a.onehot_ok[mf] != 0;
  a.gain_o[i] = ok ? gn : -INFINITY;
}

// one (direction, leaf m, feature f) row of the k-vs-rest scan, at index
// (dir * M + m) * F + f
__device__ __forceinline__ void scan(const Args& a, const Params& q,
                                     long long row) {
  if (row >= a.rows) return;
  const int P = a.P;
  const int mf = (int)(row % ((long long)a.M * a.F));   // m * F + f
  const int m = mf / a.F;
  const float sg = a.sum_g[m], sh = a.sum_h2[m], nd = a.num_data[m];
  const float shift = a.min_gain_shift[m];
  const int u = a.used[mf];
  const bool feature_ok = a.sorted_ok[mf] != 0;
  const int max_num_cat = min((u + 1) / 2, q.max_cat);
  const float* x = a.srt + row * P * 3;
  float* out = a.cum + row * P * 3;
  float* gn = a.gain + row * P;
  float carry[3] = {0.f, 0.f, 0.f};   // the blocks before this one
  float cnt = 0.f;                    // min_data_per_group's group count
  bool right_ok = true;               // the right side held so far
  for (int b0 = 0; b0 < P; b0 += kBlock) {
    float local[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < kBlock && b0 + j < P; ++j) {
      const int p = b0 + j;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        local[c] = j == 0 ? x[p * 3 + c] : __fadd_rn(local[c], x[p * 3 + c]);
        out[p * 3 + c] = b0 == 0 ? local[c] : __fadd_rn(local[c], carry[c]);
      }
      const float lg = out[p * 3], lc = out[p * 3 + 2];
      const float lh = __fadd_rn(out[p * 3 + 1], q.eps);
      const float rg = __fsub_rn(sg, lg), rh = __fsub_rn(sh, lh);
      const float rc = __fsub_rn(nd, lc);
      const bool left_ok = lc >= q.mdl && lh >= q.msh;
      right_ok = right_ok && rc >= q.mdl && rc >= q.mdpg && rh >= q.msh;
      cnt = __fadd_rn(cnt, x[p * 3 + 2]);
      const bool emit = left_ok && cnt >= q.mdpg;
      if (emit) cnt = 0.f;
      const float g = __fadd_rn(fused_leaf_gain(lg, lh, q, q.l2c),
                                fused_leaf_gain(rg, rh, q, q.l2c));
      const bool ok = emit && right_ok && p < u && p < max_num_cat &&
                      g > shift && feature_ok;
      gn[p] = ok ? g : -INFINITY;
    }
    // the block's total (zero-padded past P) into the running total, in
    // sequence as the carry scan over block totals adds them
#pragma unroll
    for (int c = 0; c < 3; ++c)
      carry[c] = b0 == 0 ? local[c] : __fadd_rn(carry[c], local[c]);
  }
}

// the scan's rows in the first ``scan_blocks`` blocks, the one-hot bins
// in the others
__global__ void __launch_bounds__(kThreads)
    categorical_kernel(const Args a, const Params q) {
  if ((int)blockIdx.x < a.scan_blocks)
    scan(a, q, (long long)blockIdx.x * kThreads + threadIdx.x);
  else
    onehot(a, q,
           (long long)(blockIdx.x - a.scan_blocks) * kThreads + threadIdx.x);
}

}  // namespace

extern "C" {

// The categorical candidates of M leaves over F features: the k-vs-rest
// scan's prefix sums and gains over P sorted positions and the one-hot
// gains over B bins, as ops/split.py categorical_gains_plain computes
// them.
int categorical_gains_launch(
    const void* hist, const void* srt, void* cum, void* gain, void* gain_o,
    int M, int F, int B, int P, const void* sum_g, const void* sum_h2,
    const void* num_data, const void* min_gain_shift, const void* used,
    const void* sorted_ok, const void* used_bin, const void* onehot_ok,
    float l1, float l2c, float l2n, float mds, int use_mds, float eps,
    float mdl, float msh, float mdpg, int max_cat, void* stream) {
  if (M < 1 || F < 1 || B < 1 || P < 1 || P > kMaxP || P > B)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.hist = static_cast<const float*>(hist);
  a.srt = static_cast<const float*>(srt);
  a.cum = static_cast<float*>(cum);
  a.gain = static_cast<float*>(gain);
  a.gain_o = static_cast<float*>(gain_o);
  a.sum_g = static_cast<const float*>(sum_g);
  a.sum_h2 = static_cast<const float*>(sum_h2);
  a.num_data = static_cast<const float*>(num_data);
  a.min_gain_shift = static_cast<const float*>(min_gain_shift);
  a.used = static_cast<const int*>(used);
  a.sorted_ok = static_cast<const uint8_t*>(sorted_ok);
  a.used_bin = static_cast<const int*>(used_bin);
  a.onehot_ok = static_cast<const uint8_t*>(onehot_ok);
  a.rows = 2LL * M * F;
  a.M = M;
  a.F = F;
  a.B = B;
  a.P = P;
  const long long scan_blocks = (a.rows + kThreads - 1) / kThreads;
  const long long onehot_blocks =
      ((long long)M * F * B + kThreads - 1) / kThreads;
  if (scan_blocks + onehot_blocks > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  a.scan_blocks = (int)scan_blocks;
  Params q;
  q.l1 = l1;
  q.l2c = l2c;
  q.l2n = l2n;
  q.mds = mds;
  q.use_mds = use_mds;
  q.eps = eps;
  q.mdl = mdl;
  q.msh = msh;
  q.mdpg = mdpg;
  q.max_cat = max_cat;
  categorical_kernel<<<(unsigned)(scan_blocks + onehot_blocks), kThreads, 0,
                       (cudaStream_t)stream>>>(a, q);
  return (int)cudaGetLastError();
}

}  // extern "C"
