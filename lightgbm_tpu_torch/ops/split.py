"""Best-split search over histograms, batched over leaves.

The JAX package's ``ops/split.py`` for numerical features (reference
FeatureHistogram::FindBestThreshold*, feature_histogram.hpp:76-653): both
scan directions of every feature are evaluated at once from prefix sums,
and a flat argmax picks the winner. Semantics kept from the reference:

- L1-thresholded leaf outputs and gains (feature_histogram.hpp:442-504);
- kEpsilon on each accumulated hessian side and ``sum_hessian +
  2*kEpsilon`` at the parent (feature_histogram.hpp:76-80);
- missing handling: two scans when ``num_bin > 2`` and the missing type
  is not None; the NaN bin rides with the default side, the zero bin is
  skipped under MissingType.ZERO (feature_histogram.hpp:87-110);
- min_data_in_leaf, min_sum_hessian_in_leaf, min_gain_to_split and the
  monotone zeroing (GetSplitGains, feature_histogram.hpp:458); under
  ``count_lb`` (the count-proxy tier) both sides' counts of the
  min_data gate are sums of the count channel's lower bounds;
- ties: the flat argmax order is feature-major, dir=-1 (larger
  thresholds first) before dir=+1 (smaller first), the reference's scan
  order. ``torch.argmax`` returns the first maximum, as ``jnp.argmax``.

The prefix sums are a product with a lower-triangular ones matrix, as
in the JAX package: on the CPU that product adds in bin order in f32,
bit-equal to the JAX package's einsum, where ``torch.cumsum`` is not.
XLA's einsum keeps 1, 2 or 4 lane accumulators (bins j with j % L == l,
in order) by the width mod 64 (``_dot_lanes``: 4 at width 16, 2 at 32,
one from 64 up at the powers of two), adds them pairwise at the end and
adds the bins past the last whole step of L on their own, after; the
port adds in that order at every width (the EFB route's widths are not
bucketed).

Categorical features (``SplitParams.has_cat``; FindBestThresholdCategorical,
feature_histogram.hpp:112-234, the JAX package's ``_categorical_tables``)
add two candidate tables per feature: one-hot (a single bin goes left,
when ``num_bin <= max_cat_to_onehot``) in the dir=+1 slot, and k-vs-rest
over the bins sorted by g / (h + cat_smooth) from either end, with
``l2 + cat_l2``. The argmax then runs over [M, F, 4, B]: numerical
dir=-1, dir=+1, categorical dir=+1, dir=-1. The winner's left set is a
bitset over bins, ``NCAT_WORDS`` int32 words, set bit = bin goes left.
The sorted prefix sums add as XLA's CPU cumsum does (``xla_cumsum``).
With ``has_cat`` False the table keeps its two numerical branches, and
categorical features never split.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .f32math import fma
from ..utils import cuda_build
from ..utils.device import Counter, on_device
from ..utils.log import LightGBMError

KEPSILON = 1e-15            # meta.h:38
KMIN_SCORE = float("-inf")

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

NCAT_WORDS = 8              # 256-bin bitset of a categorical left set


class SplitParams(NamedTuple):
    """Split hyperparameters of one training run."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    # categorical search (feature_histogram.hpp:112-234)
    max_cat_to_onehot: int = 4
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    min_data_per_group: float = 100.0
    # the categorical tables are built only with has_cat (models/gbdt.py
    # sets it when a mapper is categorical). The JAX package defaults it
    # to True; here a caller with categorical features says so
    has_cat: bool = False
    # count-proxy tier: the count channel holds per-bin lower bounds, so
    # both sides of the min_data gate come from prefix/suffix sums of the
    # channel (num_data - one side would over-estimate the other)
    count_lb: bool = False


class FeatureMeta(NamedTuple):
    """Per-feature bin metadata ([F] arrays, numpy or tensors)."""
    num_bin: object          # int32
    missing_type: object     # int32
    default_bin: object      # int32
    monotone: object         # int32 (-1, 0, +1)
    penalty: object          # float32 (feature_contri; 1.0 default)
    # int32, 1 = categorical; the scalar default broadcasts over features
    is_cat: object = np.zeros((), np.int32)
    # EFB (io/efb.py): each member's bundle column and bin offset; the
    # scalar default means unbundled (a feature's column is its own row)
    bundle: object = np.zeros((), np.int32)
    offset: object = np.zeros((), np.int32)

    @property
    def bundled(self) -> bool:
        return self.bundle.ndim != 0

    def to(self, device) -> "FeatureMeta":
        return FeatureMeta(*[torch.as_tensor(np.asarray(x)).to(device)
                             for x in self])


class SplitResult(NamedTuple):
    """Best split per leaf (SplitInfo, split_info.hpp:17): [M] each."""
    gain: torch.Tensor
    feature: torch.Tensor
    threshold_bin: torch.Tensor
    default_left: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor
    left_count: torch.Tensor
    right_count: torch.Tensor
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    is_cat: torch.Tensor          # [M] bool
    cat_words: torch.Tensor       # [M, NCAT_WORDS] int32 left-set bitset


def threshold_l1(s, l1: float):
    """ThresholdL1 (feature_histogram.hpp:442)."""
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def calculate_leaf_output(sum_g, sum_h, l1: float, l2: float,
                          max_delta_step: float):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:447)."""
    ret = -threshold_l1(sum_g, l1) / (sum_h + l2)
    if max_delta_step > 0.0:
        ret = torch.clamp(ret, -max_delta_step, max_delta_step)
    return ret


def leaf_split_gain_given_output(sum_g, sum_h, l1: float, l2: float, output):
    """GetLeafSplitGainGivenOutput (feature_histogram.hpp:500)."""
    sg_l1 = threshold_l1(sum_g, l1)
    return -(2.0 * sg_l1 * output + (sum_h + l2) * output * output)


def leaf_split_gain(sum_g, sum_h, l1: float, l2: float,
                    max_delta_step: float):
    """GetLeafSplitGain (feature_histogram.hpp:495)."""
    out = calculate_leaf_output(sum_g, sum_h, l1, l2, max_delta_step)
    return leaf_split_gain_given_output(sum_g, sum_h, l1, l2, out)


def _f32(x: float) -> float:
    """A Python float rounded to f32, the value JAX's weakly typed
    scalars take in f32 arithmetic."""
    return float(np.float32(x))


def _dot_lanes(B: int) -> int:
    """Lane accumulators of XLA's CPU dot over a reduction of B bins: set
    by B mod 64 (found by holding the JAX package's einsum to each
    order at every width 2-256)."""
    if B in (19, 20, 23, 24):
        return 4
    r = B % 64
    if r == 0 or r > 48:
        return 1
    return 2 if 16 < r <= 32 else 4


def prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """[..., B, C] -> inclusive prefix sums over B in XLA's order (see
    the module docstring): the first H = B - B mod L bins in L lanes,
    each lane's sums by a lower-triangular product (sequential on the
    CPU), the lanes then added pairwise; the last B - H bins summed in
    sequence on their own and added to the head's total."""
    *lead, B, C = x.shape
    L = _dot_lanes(B)
    H = B - B % L
    x = x.reshape(-1, B, C)
    out = _lane_prefix(x[:, :H], L) if H else x[:, :0]
    if H < B:
        tail = x[:, H:]
        tril = torch.tril(torch.ones((B - H, B - H), dtype=x.dtype,
                                     device=x.device))
        tail = torch.matmul(tril, tail)
        head = out[:, -1:] if H else torch.zeros_like(tail[:, :1])
        out = torch.cat([out, head + tail], dim=1)
    return out.reshape(*lead, B, C)


def _lane_prefix(x: torch.Tensor, L: int) -> torch.Tensor:
    """[M, B, C] (B a multiple of L) -> prefix sums with L lane
    accumulators (bins j with j % L == l, in order), then the lanes
    pairwise."""
    M, B, C = x.shape
    steps = B // L
    tril = torch.tril(torch.ones((steps, steps), dtype=x.dtype,
                                 device=x.device))
    lane = torch.matmul(tril, x.reshape(M, steps, L * C)).reshape(
        M, steps, L, C)                  # lane[q, l]: bins j = pL + l, p <= q
    if L == 1:
        return lane.reshape(M, B, C)
    # bin k = qL + r: lanes l <= r hold their step-q sum, lanes l > r
    # the step before (zero at q = 0)
    prev = torch.cat([torch.zeros_like(lane[:, :1]), lane[:, :-1]], dim=1)
    lidx = torch.arange(L, device=x.device)
    outs = []
    for r in range(L):
        acc = torch.where((lidx <= r)[:, None], lane, prev)   # [., q, L, C]
        parts = [acc[:, :, l] for l in range(L)]
        while len(parts) > 1:
            parts = [parts[2 * i] + parts[2 * i + 1]
                     for i in range(len(parts) // 2)]
        outs.append(parts[0])
    return torch.stack(outs, dim=2).reshape(M, B, C)


_SCAN_BLOCK = 16


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis in the order of XLA's
    CPU cumsum (a ``reduce_window``), which ``torch.cumsum`` does not
    give: blocks of 16, added in sequence within each block; each
    block's running total then comes from the same scan over the block
    totals and is added once to the block's local prefixes."""
    *lead, n = x.shape
    K = _SCAN_BLOCK
    nb = -(-n // K)
    if nb * K != n:
        x = torch.cat([x, x.new_zeros(*lead, nb * K - n)], dim=-1)
    xb = x.reshape(*lead, nb, K)
    acc = xb[..., 0]
    local = [acc]
    for j in range(1, K):
        acc = acc + xb[..., j]
        local.append(acc)
    out = torch.stack(local, dim=-1)                       # [..., nb, K]
    if nb > 1:
        carry = xla_cumsum(out[..., -1])                   # [..., nb]
        out = torch.cat([out[..., :1, :],
                         out[..., 1:, :] + carry[..., :-1, None]], dim=-2)
    return out.reshape(*lead, nb * K)[..., :n]


def _fused_leaf_gain(sum_g, sum_h, l1: float, l2, mds: float):
    """GetLeafSplitGain as XLA's CPU fusion of the categorical tables
    rounds it: ``2 * g * output`` contracted into one fused multiply-add
    with ``(sum_h + l2) * output * output``."""
    out = calculate_leaf_output(sum_g, sum_h, l1, l2, mds)
    return -fma(2.0 * threshold_l1(sum_g, l1), out,
                (sum_h + l2) * out * out)


def _pair_gain(lg, lh, rg, rh, l1, l2, mds):
    return (_fused_leaf_gain(lg, lh, l1, l2, mds)
            + _fused_leaf_gain(rg, rh, l1, l2, mds))


def _categorical_tables(hist, sum_g, sum_h2, num_data, fmask, meta,
                        hp: SplitParams, min_gain_shift):
    """The categorical candidates of M leaves (the JAX package's
    ``_categorical_tables``, split.py:256-380): (gc1, gc2, ctx) with
    gc1, gc2 [M, F, B] the dir=+1 (one-hot included) and dir=-1 gains,
    -inf where invalid. ``fmask`` [M, F, 1] is the feature mask and the
    leaves' can_split; sum_g, sum_h2 (parent + 2 kEpsilon), num_data and
    min_gain_shift are [M, 1, 1].

    Sorted mode keeps the bins with count >= cat_smooth, sorted stably
    by g / (h + cat_smooth) (the others sort last), and scans prefixes
    from either end. A prefix longer than max_cat_threshold is never a
    candidate, so the scans stop there: P = min(B, max_cat_threshold)
    positions, each prefix sum the same as over all B. Both directions
    and the three channels ride one ``xla_cumsum``; the right-side
    checks break the scan (a prefix mask), and min_data_per_group
    chunking is a sequential loop over the P positions that resets the
    group's count at each emitted candidate: on a card the one-hot gains,
    the scan, the loop and the positions' gains are one launch
    (``categorical_gains``)."""
    M, F, B, _ = hist.shape
    dev = hist.device
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]
    nb = meta.num_bin.to(torch.int64)[None, :, None]
    mt = meta.missing_type.to(torch.int64)[None, :, None]
    ic = (meta.is_cat.to(torch.int64).expand(F) > 0)[None, :, None]
    bidx = torch.arange(B, device=dev)[None, None, :]
    l2c = _f32(hp.lambda_l2 + hp.cat_l2)
    eps = _f32(KEPSILON)

    # the trailing missing bin is no candidate unless MissingType.NONE
    used_bin = nb - 1 + (mt == MISSING_NONE).to(torch.int64)
    bin_ok = bidx < used_bin
    use_onehot = nb <= hp.max_cat_to_onehot                # [1, F, 1]

    # sorted k-vs-rest, l2 + cat_l2 (hpp:164-234): the bins' order
    elig = bin_ok & (c >= _f32(hp.cat_smooth))
    ratio = torch.where(elig, g / (h + _f32(hp.cat_smooth)), float("inf"))
    order = torch.argsort(ratio, dim=-1, stable=True)     # [M, F, B]
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(B, device=dev).expand(M, F, B))
    used = elig.sum(dim=-1, keepdim=True)                  # [M, F, 1]
    P = min(B, max(int(hp.max_cat_threshold), 1))
    pos = torch.arange(P, device=dev)[None, None, :]
    in_use = pos < used
    # the sorted bins of each direction: dir=+1 from the smallest ratio,
    # dir=-1 from the last eligible one back
    back = order.gather(-1, (used - 1 - pos).clamp(0, B - 1))
    idx = torch.stack([order[..., :P], back])              # [2, M, F, P]
    srt = torch.gather(hist.expand(2, M, F, B, 3), 3,
                       idx[..., None].expand(2, M, F, P, 3))
    srt = torch.where(in_use[..., None], srt, 0.0)
    # the one-hot candidates (left = the single bin t, plain l2; hpp:133-
    # 163) and the k-vs-rest scan
    cum, gain, gain_o = categorical_gains(
        hist.contiguous(), srt.contiguous(), sum_g, sum_h2, num_data,
        min_gain_shift, used, ic & ~use_onehot & fmask, used_bin,
        ic & use_onehot & fmask, hp)
    lg, lh, lc = cum[..., 0], cum[..., 1] + eps, cum[..., 2]
    if P < B:
        gain = torch.cat([gain, gain.new_full((2, M, F, B - P),
                                              KMIN_SCORE)], dim=-1)
    # a feature is in one mode: one-hot rides the dir=+1 slot
    gc1 = torch.maximum(gain[0], gain_o)
    ctx = dict(rank=rank, used=used, elig=elig, use_onehot=use_onehot,
               lg_o=g, lh_o=h + eps, lc_o=c, lg=lg, lh=lh, lc=lc, l2c=l2c,
               P=P)
    return gc1, gain[1], ctx


# categorical_gains' kernel launches since the last reset (the plain
# version never counts)
gains_launches = Counter()
_gains_fn = None


def categorical_gains(hist: torch.Tensor, srt: torch.Tensor, sum_g, sum_h2,
                      num_data, min_gain_shift, used, sorted_ok, used_bin,
                      onehot_ok, hp: SplitParams):
    """The candidate tables of ``_categorical_tables`` for M leaves over
    F features -> (cum, gain, gain_o).

    k-vs-rest, over ``srt [2, M, F, P, 3]`` f32 (each direction's sorted
    g, h, count of each leaf and feature, zero past its ``used [M, F,
    1]`` eligible bins): cum, the prefix sums in XLA's CPU order
    (``xla_cumsum``), and gain [2, M, F, P], each position's gain with l2
    + cat_l2, -inf where it is no candidate: min_data_per_group's
    chunking did not emit it, a side fails min_data_in_leaf or the
    hessian floor (the right side's failure ends the scan), it lies past
    ``used`` or half of it (at most max_cat_threshold), its gain is not
    above ``min_gain_shift [M, 1, 1]``, or ``sorted_ok [M, F, 1]`` is
    off. One-hot, over ``hist [M, F, B, 3]``: gain_o [M, F, B], each bin
    going left alone with plain l2, -inf past ``used_bin [1, F, 1]``,
    where a side fails its floors, the gain is not above the shift, or
    ``onehot_ok [M, F, 1]`` is off. ``sum_g``, ``sum_h2`` (parent + 2
    kEpsilon) and ``num_data`` are [M, 1, 1].

    CUDA tensors launch csrc/categorical.cu (one thread a scan row or a
    bin, the same operations in the same order), CPU tensors run
    ``categorical_gains_plain``."""
    if srt.device.type == "cpu":
        return categorical_gains_plain(hist, srt, sum_g, sum_h2, num_data,
                                       min_gain_shift, used, sorted_ok,
                                       used_bin, onehot_ok, hp)
    if srt.device.type != "cuda":
        raise LightGBMError(f"no categorical kernel for {srt.device}")
    M, F, B, _ = hist.shape
    P = srt.shape[-2]
    if srt.dtype != torch.float32 or hist.dtype != torch.float32 or \
            srt.shape != (2, M, F, P, 3) or hist.shape[-1] != 3 or \
            not (srt.is_contiguous() and hist.is_contiguous()) or \
            not 1 <= P <= min(B, 256):
        raise LightGBMError(f"the categorical kernel takes contiguous f32 "
                            f"hist [M, F, B, 3] and [2, M, F, P <= 256, 3]; "
                            f"got {tuple(hist.shape)}, {tuple(srt.shape)}")
    global _gains_fn
    if _gains_fn is None:
        fn = cuda_build.library("categorical").categorical_gains_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 5 + [i] * 4 + [p] * 8
                       + [f, f, f, f, i, f, f, f, f, i, p])
        fn.restype = i
        _gains_fn = fn
    leaf = [t.reshape(M).to(torch.float32).contiguous()
            for t in (sum_g, sum_h2, num_data, min_gain_shift)]

    def per_feature(t, dtype):
        return t.expand(M, F, 1).reshape(M * F).to(dtype).contiguous()
    tables = (per_feature(used, torch.int32),
              per_feature(sorted_ok, torch.uint8),
              used_bin.reshape(F).to(torch.int32).contiguous(),
              per_feature(onehot_ok, torch.uint8))
    cum = torch.empty_like(srt)
    gain = torch.empty(srt.shape[:-1], dtype=torch.float32,
                       device=srt.device)
    gain_o = torch.empty((M, F, B), dtype=torch.float32, device=srt.device)
    with on_device(srt.device):
        err = _gains_fn(
            hist.data_ptr(), srt.data_ptr(), cum.data_ptr(), gain.data_ptr(),
            gain_o.data_ptr(), M, F, B, P,
            *[t.data_ptr() for t in leaf + list(tables)],
            _f32(hp.lambda_l1), _f32(hp.lambda_l2 + hp.cat_l2),
            _f32(hp.lambda_l2), float(hp.max_delta_step),
            int(hp.max_delta_step > 0.0), _f32(KEPSILON),
            _f32(hp.min_data_in_leaf), _f32(hp.min_sum_hessian_in_leaf),
            _f32(hp.min_data_per_group), int(hp.max_cat_threshold),
            torch.cuda.current_stream(srt.device).cuda_stream)
    if err != 0:
        raise LightGBMError(f"categorical kernel failed: CUDA error {err}")
    gains_launches.add()
    return cum, gain, gain_o


def categorical_gains_plain(hist: torch.Tensor, srt: torch.Tensor, sum_g,
                            sum_h2, num_data, min_gain_shift, used,
                            sorted_ok, used_bin, onehot_ok,
                            hp: SplitParams):
    """``categorical_gains`` in plain PyTorch (the JAX package's order):
    the one-hot pair gains; one ``xla_cumsum`` over the channels, the
    emit loop over the P positions (the group's count reset at each
    emitted candidate), the right side's prefix mask and the pair
    gains."""
    l1, l2c = _f32(hp.lambda_l1), _f32(hp.lambda_l2 + hp.cat_l2)
    l2n = _f32(hp.lambda_l2)
    mds = float(hp.max_delta_step)
    mdl = _f32(hp.min_data_in_leaf)
    msh = _f32(hp.min_sum_hessian_in_leaf)
    mdpg = _f32(hp.min_data_per_group)
    eps = _f32(KEPSILON)
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]
    lh_o = h + eps
    rh_o = sum_h2 - lh_o
    rc_o = num_data - c
    gain_o = _pair_gain(g, lh_o, sum_g - g, rh_o, l1, l2n, mds)
    bidx = torch.arange(hist.shape[2], device=hist.device)
    ok_o = ((bidx < used_bin) & (c >= mdl) & (h >= msh) & (rc_o >= mdl)
            & (rh_o >= msh) & (gain_o > min_gain_shift) & onehot_ok)
    gain_o = torch.where(ok_o, gain_o, KMIN_SCORE)

    cum = xla_cumsum(srt.transpose(-1, -2)).transpose(-1, -2)
    lg, lh, lc = cum[..., 0], cum[..., 1] + eps, cum[..., 2]
    rg, rh, rc = sum_g - lg, sum_h2 - lh, num_data - lc
    left_ok = (lc >= mdl) & (lh >= msh)
    # a right-side failure breaks the reference's scan: a prefix mask
    right_ok = ((rc >= mdl) & (rc >= mdpg) & (rh >= msh)).to(
        torch.int32).cumprod(dim=-1) > 0
    cnt = torch.zeros(srt.shape[:-2], dtype=srt.dtype, device=srt.device)
    emits = []
    for p in range(srt.shape[-2]):
        cnt = cnt + srt[..., p, 2]
        e = left_ok[..., p] & (cnt >= mdpg)
        cnt = torch.where(e, 0.0, cnt)
        emits.append(e)
    emit = torch.stack(emits, dim=-1)
    gain = _pair_gain(lg, lh, rg, rh, l1, l2c, mds)
    pos = torch.arange(srt.shape[-2], device=srt.device)
    max_num_cat = torch.clamp((used + 1) // 2, max=hp.max_cat_threshold)
    ok = (emit & right_ok & (pos < used) & (pos < max_num_cat)
          & (gain > min_gain_shift) & sorted_ok)
    return cum, torch.where(ok, gain, KMIN_SCORE), gain_o


def _cat_left_bitset(fi, t, cat_p1, ctx, B: int) -> torch.Tensor:
    """[M, NCAT_WORDS] int32 left-set bitsets of the winners (feature
    fi, position t; the JAX package's ``_cat_left_bitset``): one-hot the
    bin t, dir=+1 the first t + 1 sorted bins, dir=-1 the last t + 1."""
    M = fi.shape[0]
    dev = fi.device
    rows = torch.arange(M, device=dev)
    rank = ctx["rank"][rows, fi]                           # [M, B]
    used = ctx["used"][rows, fi]                           # [M, 1]
    elig = ctx["elig"][rows, fi]
    onehot = ctx["use_onehot"][0, fi]                      # [M, 1]
    tt = t[:, None]
    bidx = torch.arange(B, device=dev)[None, :]
    member = torch.where(
        onehot, bidx == tt,
        torch.where(cat_p1[:, None], (rank <= tt) & elig,
                    (rank >= used - 1 - tt) & elig))
    nbits = NCAT_WORDS * 32
    member = member[:, :nbits]
    if member.shape[1] < nbits:
        member = torch.cat([member, member.new_zeros(
            M, nbits - member.shape[1])], dim=1)
    bit = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int64, device=dev),
        torch.arange(32, device=dev))
    words = (member.reshape(M, NCAT_WORDS, 32).to(torch.int64)
             * bit).sum(dim=-1)
    # the uint32 words as int32, two's complement
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def find_best_split(hist: torch.Tensor, sum_g: torch.Tensor,
                    sum_h: torch.Tensor, num_data: torch.Tensor,
                    feature_mask: torch.Tensor, meta: FeatureMeta,
                    hp: SplitParams, can_split: torch.Tensor,
                    sum_scale=None, per_feature: bool = False):
    """The best (feature, threshold, direction) of each of M leaves.

    hist [M, F, B, 3] f32 (grad, hess, count); sum_g, sum_h, num_data
    [M] f32 leaf totals (num_data counts in-bag rows); feature_mask [F]
    bool, or [M, F] for a mask per leaf (the voting learner's elected
    features); can_split [M] bool (False forces -inf gain: depth limit
    or an inactive slot). ``meta`` holds tensors on hist's device.

    ``per_feature``: return instead each feature's best gain [M, F]
    (KMIN_SCORE where it has no valid split), the JAX package's
    ``best_gain_per_feature`` (split.py:403), the voting learner's
    local vote.
    """
    M, F, B, _ = hist.shape
    dev = hist.device
    f32 = torch.float32
    nb = meta.num_bin.to(torch.int64)[None, :, None]       # [1, F, 1]
    mt = meta.missing_type.to(torch.int64)[None, :, None]
    db = meta.default_bin.to(torch.int64)[None, :, None]
    mono = meta.monotone.to(torch.int64)[None, :, None]
    l1, l2 = _f32(hp.lambda_l1), _f32(hp.lambda_l2)
    mds = float(hp.max_delta_step)

    if sum_scale is None:
        sum_g = sum_g.to(f32)[:, None, None]               # [M, 1, 1]
    else:
        # the leaf's sums are the products q * scale of its quantized sums
        q_g = sum_g.to(f32)[:, None, None]
        sum_g = q_g * sum_scale[0]
        sum_h = sum_h.to(f32) * sum_scale[1]
    sum_h2 = sum_h.to(f32)[:, None, None] + _f32(2.0 * KEPSILON)
    num_data = num_data.to(f32)[:, None, None]
    gain_shift = leaf_split_gain(sum_g, sum_h2, l1, l2, mds)
    min_gain_shift = gain_shift + _f32(hp.min_gain_to_split)
    # the JAX package grows a bundled set inside its per-booster step,
    # whose metadata are constants. There XLA fuses the leaf's gain into
    # the candidates' loop and contracts it as ``_fused_leaf_gain``: the
    # candidates are held against that, and the reported gain subtracts
    # the unfused one
    cmp_shift = min_gain_shift if not meta.bundled else (
        _fused_leaf_gain(sum_g, sum_h2, l1, l2, mds)
        + _f32(hp.min_gain_to_split))

    bidx = torch.arange(B, device=dev)[None, None, :]      # [1, 1, B]
    two_scan = (nb > 2) & (mt != MISSING_NONE)             # [1, F, 1]
    use_na = two_scan & (mt == MISSING_NAN)
    skip_db = two_scan & (mt == MISSING_ZERO)

    contrib_mask = ((bidx < nb) & ~(skip_db & (bidx == db))
                    & ~(use_na & (bidx == nb - 1))).to(f32)
    contrib = hist * contrib_mask[..., None]               # [M, F, B, 3]
    cum = prefix_sums(contrib)
    tot = cum[:, :, -1:, :]                                # [M, F, 1, 3]
    eps = _f32(KEPSILON)

    # dir = +1: left accumulates from bin 0 (missing goes right)
    l_g1 = cum[..., 0]
    l_h1 = cum[..., 1] + eps
    l_c1 = cum[..., 2]
    r_g1 = sum_g - l_g1
    r_h1 = sum_h2 - l_h1
    r_c1 = tot[..., 2] - l_c1 if hp.count_lb else num_data - l_c1
    valid1 = two_scan & (bidx <= nb - 2) & ~(skip_db & (bidx == db))

    # dir = -1: right accumulates from the top (missing goes left)
    r_g2 = tot[..., 0] - cum[..., 0]
    r_h2 = tot[..., 1] - cum[..., 1] + eps
    r_c2 = tot[..., 2] - cum[..., 2]
    l_g2 = sum_g - r_g2
    l_h2 = sum_h2 - r_h2
    l_c2 = cum[..., 2] if hp.count_lb else num_data - r_c2
    max_t2 = torch.where(use_na, nb - 3, nb - 2)
    valid2 = (bidx <= max_t2) & ~(skip_db & (bidx == db - 1))

    def side_gains(lg, lh, rg, rh):
        lo = calculate_leaf_output(lg, lh, l1, l2, mds)
        ro = calculate_leaf_output(rg, rh, l1, l2, mds)
        bad_mono = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
        g = (leaf_split_gain_given_output(lg, lh, l1, l2, lo)
             + leaf_split_gain_given_output(rg, rh, l1, l2, ro))
        return torch.where(bad_mono, 0.0, g)

    def constraints(lc, lh, rc, rh):
        md, mh = _f32(hp.min_data_in_leaf), _f32(hp.min_sum_hessian_in_leaf)
        return (lc >= md) & (rc >= md) & (lh >= mh) & (rh >= mh)

    gains1 = side_gains(l_g1, l_h1, r_g1, r_h1)
    ok1 = valid1 & constraints(l_c1, l_h1, r_c1, r_h1) \
        & (gains1 > cmp_shift)
    gains2 = side_gains(l_g2, l_h2, r_g2, r_h2)
    ok2 = valid2 & constraints(l_c2, l_h2, r_c2, r_h2) \
        & (gains2 > cmp_shift)
    fm = feature_mask.to(torch.bool)
    fmask = (fm[None] if fm.ndim == 1 else fm)[:, :, None] \
        & can_split.to(torch.bool)[:, None, None]
    ic = (meta.is_cat.to(torch.int64).expand(F) > 0)[None, :, None]
    g1 = torch.where(ok1 & fmask & ~ic, gains1, KMIN_SCORE)
    g2 = torch.where(ok2 & fmask & ~ic, gains2, KMIN_SCORE)

    # flat [M, F, nbranch, B]: dir=-1 with reversed thresholds, then
    # dir=+1, then the categorical dir=+1 and dir=-1 tables
    branches = [g2.flip(-1), g1]
    if hp.has_cat:
        gc1, gc2, cctx = _categorical_tables(
            hist, sum_g, sum_h2, num_data, fmask, meta, hp, min_gain_shift)
        branches += [gc1, gc2]
    nbr = len(branches)
    if per_feature:
        best = torch.stack(branches, dim=2).reshape(M, F, -1).amax(dim=2)
        return torch.where(torch.isfinite(best),
                           (best - min_gain_shift[:, :, 0])
                           * meta.penalty.to(f32), KMIN_SCORE)
    cand = torch.stack(branches, dim=2).reshape(M, -1)
    idx = torch.argmax(cand, dim=1)                        # [M]
    best_gain = cand.gather(1, idx[:, None])[:, 0]
    fi = idx // (nbr * B)
    rem = idx % (nbr * B)
    d = rem // B
    is_dir2 = d == 0
    tb = rem % B
    t = torch.where(is_dir2, B - 1 - tb, tb)
    rows = torch.arange(M, device=dev)

    def pick(a2, a1):
        return torch.where(is_dir2, a2[rows, fi, t], a1[rows, fi, t])

    if sum_scale is None:
        lg = pick(l_g2, l_g1)
    else:
        # XLA recomputes the product q * scale inside the fusions that
        # pick the winner's sums and contracts it into their
        # subtractions (one rounding); the gains round it first
        q_g0 = q_g[:, 0, 0]
        lg = torch.where(is_dir2,
                         fma(q_g0, sum_scale[0], -r_g2[rows, fi, t]),
                         l_g1[rows, fi, t])
    lh = pick(l_h2, l_h1)
    lc = pick(l_c2, l_c1)
    has = torch.isfinite(best_gain)
    l2_eff = l2
    if hp.has_cat:
        is_cat = d >= 2
        cat_p1 = d == 2
        onehot = cctx["use_onehot"][0, fi, 0]
        # a one-hot winner sits at its bin t; a sorted one at t < P
        tp = t.clamp(max=cctx["P"] - 1)
        dirs = torch.where(cat_p1, 0, 1)

        def pick_cat(one, srt):
            return torch.where(onehot, one[rows, fi, t],
                               srt[dirs, rows, fi, tp])
        lg = torch.where(is_cat, pick_cat(cctx["lg_o"], cctx["lg"]), lg)
        lh = torch.where(is_cat, pick_cat(cctx["lh_o"], cctx["lh"]), lh)
        lc = torch.where(is_cat, pick_cat(cctx["lc_o"], cctx["lc"]), lc)
        # sorted mode uses l2 + cat_l2 for the outputs too (hpp:233-246)
        l2_eff = torch.where(is_cat & ~onehot, cctx["l2c"], l2)
        cat_words = _cat_left_bitset(fi, t, cat_p1, cctx, B)
        is_cat = is_cat & has
        cat_words = torch.where(is_cat[:, None], cat_words, 0)
    else:
        is_cat = torch.zeros(M, dtype=torch.bool, device=dev)
        cat_words = torch.zeros((M, NCAT_WORDS), dtype=torch.int32,
                                device=dev)
    sg = sum_g[:, 0, 0]
    sh2 = sum_h2[:, 0, 0]
    rg = sg - lg if sum_scale is None else fma(q_g0, sum_scale[0], -lg)
    rh = sh2 - lh
    rc = num_data[:, 0, 0] - lc
    # single-scan NaN edge: report default_left = False (hpp:103-106)
    single_nan = (~two_scan[0, fi, 0]) & (mt[0, fi, 0] == MISSING_NAN)
    return SplitResult(
        gain=torch.where(has, best_gain - min_gain_shift[:, 0, 0],
                         KMIN_SCORE) * meta.penalty.to(f32)[fi],
        feature=torch.where(has, fi, -1).to(torch.int32),
        threshold_bin=torch.where(has, t, 0).to(torch.int32),
        default_left=is_dir2 & ~single_nan & ~is_cat & has,
        left_output=calculate_leaf_output(lg, lh, l1, l2_eff, mds),
        right_output=calculate_leaf_output(rg, rh, l1, l2_eff, mds),
        left_count=lc,
        right_count=rc,
        left_sum_g=lg,
        left_sum_h=lh - eps,          # the reference stores sum - kEpsilon
        right_sum_g=rg,
        right_sum_h=rh - eps,
        is_cat=is_cat,
        cat_words=cat_words)
