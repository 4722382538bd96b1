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
XLA's einsum adds in bin order from width 64 up; at widths 16 and 32 it
keeps 4 and 2 lane accumulators (bins j with j % L == l, in order) and
adds them pairwise at the end, and the port adds in that order there.
Categorical features raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .f32math import fma

KEPSILON = 1e-15            # meta.h:38
KMIN_SCORE = float("-inf")

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


class SplitParams(NamedTuple):
    """Split hyperparameters of one training run."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
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


# lane accumulators of XLA's CPU dot over a reduction of this width
_DOT_LANES = {16: 4, 32: 2}


def prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """[..., B, C] -> inclusive prefix sums over B in XLA's order (see
    the module docstring): each lane's sums by a lower-triangular
    product (sequential on the CPU), then the lanes pairwise."""
    *lead, B, C = x.shape
    L = _DOT_LANES.get(B, 1)
    steps = B // L
    tril = torch.tril(torch.ones((steps, steps), dtype=x.dtype,
                                 device=x.device))
    lane = torch.matmul(tril, x.reshape(-1, steps, L * C)).reshape(
        -1, steps, L, C)                 # lane[q, l]: bins j = pL + l, p <= q
    if L == 1:
        return lane.reshape(*lead, B, C)
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
    return torch.stack(outs, dim=2).reshape(*lead, B, C)


def find_best_split(hist: torch.Tensor, sum_g: torch.Tensor,
                    sum_h: torch.Tensor, num_data: torch.Tensor,
                    feature_mask: torch.Tensor, meta: FeatureMeta,
                    hp: SplitParams, can_split: torch.Tensor,
                    sum_scale=None) -> SplitResult:
    """The best (feature, threshold, direction) of each of M leaves.

    hist [M, F, B, 3] f32 (grad, hess, count); sum_g, sum_h, num_data
    [M] f32 leaf totals (num_data counts in-bag rows); feature_mask [F]
    bool; can_split [M] bool (False forces -inf gain: depth limit or an
    inactive slot). ``meta`` holds tensors on hist's device.
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
        & (gains1 > min_gain_shift)
    gains2 = side_gains(l_g2, l_h2, r_g2, r_h2)
    ok2 = valid2 & constraints(l_c2, l_h2, r_c2, r_h2) \
        & (gains2 > min_gain_shift)
    fmask = feature_mask.to(torch.bool)[None, :, None] \
        & can_split.to(torch.bool)[:, None, None]
    g1 = torch.where(ok1 & fmask, gains1, KMIN_SCORE)
    g2 = torch.where(ok2 & fmask, gains2, KMIN_SCORE)

    # flat [M, F, 2, B]: dir=-1 with reversed thresholds, then dir=+1
    cand = torch.stack([g2.flip(-1), g1], dim=2).reshape(M, -1)
    idx = torch.argmax(cand, dim=1)                        # [M]
    best_gain = cand.gather(1, idx[:, None])[:, 0]
    fi = idx // (2 * B)
    rem = idx % (2 * B)
    is_dir2 = rem // B == 0
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
    sg = sum_g[:, 0, 0]
    sh2 = sum_h2[:, 0, 0]
    rg = sg - lg if sum_scale is None else fma(q_g0, sum_scale[0], -lg)
    rh = sh2 - lh
    rc = num_data[:, 0, 0] - lc
    # single-scan NaN edge: report default_left = False (hpp:103-106)
    single_nan = (~two_scan[0, fi, 0]) & (mt[0, fi, 0] == MISSING_NAN)
    has = torch.isfinite(best_gain)
    return SplitResult(
        gain=torch.where(has, best_gain - min_gain_shift[:, 0, 0],
                         KMIN_SCORE) * meta.penalty.to(f32)[fi],
        feature=torch.where(has, fi, -1).to(torch.int32),
        threshold_bin=torch.where(has, t, 0).to(torch.int32),
        default_left=is_dir2 & ~single_nan & has,
        left_output=calculate_leaf_output(lg, lh, l1, l2, mds),
        right_output=calculate_leaf_output(rg, rh, l1, l2, mds),
        left_count=lc,
        right_count=rc,
        left_sum_g=lg,
        left_sum_h=lh - eps,          # the reference stores sum - kEpsilon
        right_sum_g=rg,
        right_sum_h=rh - eps)
