"""Feature binning: value -> bin mapping for numerical features.

The JAX package's ``io/binning.py`` (reference BinMapper: bin.h:61,
src/io/bin.cpp:74-365), copied for numerical features: binning is
one-time host preprocessing, so it stays numpy, and the bounds it finds
must be the reference's exactly, because they decide every tree.

- ``greedy_find_bin``               <- GreedyFindBin (bin.cpp:74)
- ``find_bin_with_zero_as_one_bin`` <- FindBinWithZeroAsOneBin (bin.cpp:152)
- ``BinMapper.find_bin``            <- BinMapper::FindBin (bin.cpp:208)
- ``BinMapper.value_to_bin``        <- BinMapper::ValueToBin (bin.h:452)

Categorical features are not ported yet (convert.py refuses their
mappers). Tree nodes store the ``MissingType`` codes in their
decision_type bits.
"""
from __future__ import annotations

from typing import List

import numpy as np

KZERO_THRESHOLD = 1e-35          # meta.h:40


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


def _get_double_upper_bound(x: float) -> float:
    """Common::GetDoubleUpperBound: the next double above x."""
    return float(np.nextafter(x, np.inf))


def _check_double_equal(a: float, b: float) -> bool:
    """Common::CheckDoubleEqualOrdered(a, b)."""
    return bool(np.nextafter(a, np.inf) >= b)


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Quantile-like greedy binning over distinct values (bin.cpp:74-150)."""
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                val = _get_double_upper_bound(
                    (float(distinct_values[i])
                     + float(distinct_values[i + 1])) / 2.0)
                if not bin_upper_bound or not _check_double_equal(
                        bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt_inbin = 0
        bin_upper_bound.append(np.inf)
        return bin_upper_bound
    if min_data_in_bin > 0:
        max_bin = max(min(max_bin, int(total_cnt // min_data_in_bin)), 1)
    mean_bin_size = total_cnt / max_bin
    rest_bin_cnt = max_bin
    rest_sample_cnt = int(total_cnt)
    is_big = counts >= mean_bin_size
    rest_bin_cnt -= int(is_big.sum())
    rest_sample_cnt -= int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    upper_bounds = [np.inf] * max_bin
    lower_bounds = [np.inf] * max_bin

    bin_cnt = 0
    lower_bounds[0] = float(distinct_values[0])
    if not is_big.any():
        # every count below the mean: the greedy scan reduces to "next
        # boundary = first prefix sum >= base + mean", one searchsorted
        # per bin
        csum = np.cumsum(np.asarray(counts, np.int64))
        base = 0
        while bin_cnt < max_bin - 1:
            mean_bin_size = (rest_sample_cnt - base) \
                / max(rest_bin_cnt - bin_cnt, 1)
            i = int(np.searchsorted(csum[:num_distinct - 1],
                                    base + mean_bin_size, side="left"))
            if i > num_distinct - 2:
                break
            upper_bounds[bin_cnt] = float(distinct_values[i])
            bin_cnt += 1
            lower_bounds[bin_cnt] = float(distinct_values[i + 1])
            base = int(csum[i])
    else:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            if not is_big[i]:
                rest_sample_cnt -= int(counts[i])
            cur_cnt_inbin += int(counts[i])
            if (is_big[i] or cur_cnt_inbin >= mean_bin_size or
                    (is_big[i + 1] and cur_cnt_inbin
                     >= max(1.0, mean_bin_size * 0.5))):
                upper_bounds[bin_cnt] = float(distinct_values[i])
                bin_cnt += 1
                lower_bounds[bin_cnt] = float(distinct_values[i + 1])
                if bin_cnt >= max_bin - 1:
                    break
                cur_cnt_inbin = 0
                if not is_big[i]:
                    rest_bin_cnt -= 1
                    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _get_double_upper_bound(
            (upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper_bound or not _check_double_equal(
                bin_upper_bound[-1], val):
            bin_upper_bound.append(val)
    bin_upper_bound.append(np.inf)
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray,
                                  counts: np.ndarray, max_bin: int,
                                  total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """A bin of its own for values within +-kZeroThreshold
    (bin.cpp:152-206)."""
    dv = np.asarray(distinct_values, dtype=np.float64)
    cnts = np.asarray(counts, dtype=np.int64)
    left_mask = dv <= -KZERO_THRESHOLD
    right_mask = dv > KZERO_THRESHOLD
    zero_mask = ~left_mask & ~right_mask
    left_cnt_data = int(cnts[left_mask].sum())
    cnt_zero = int(cnts[zero_mask].sum())
    right_cnt_data = int(cnts[right_mask].sum())

    nz = np.nonzero(dv > -KZERO_THRESHOLD)[0]
    left_cnt = int(nz[0]) if len(nz) else len(dv)

    bin_upper_bound: List[float] = []
    if left_cnt > 0:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = int(left_cnt_data / max(denom, 1) * (max_bin - 1))
        left_max_bin = max(1, left_max_bin)
        bin_upper_bound = greedy_find_bin(dv[:left_cnt], cnts[:left_cnt],
                                          left_max_bin, left_cnt_data,
                                          min_data_in_bin)
        bin_upper_bound[-1] = -KZERO_THRESHOLD

    nz = np.nonzero(dv[left_cnt:] > KZERO_THRESHOLD)[0]
    right_start = left_cnt + int(nz[0]) if len(nz) else -1

    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bin_upper_bound)
        assert right_max_bin > 0
        right_bounds = greedy_find_bin(dv[right_start:], cnts[right_start:],
                                       right_max_bin, right_cnt_data,
                                       min_data_in_bin)
        bin_upper_bound.append(KZERO_THRESHOLD)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(np.inf)
    return bin_upper_bound


class BinMapper:
    """Per-feature value -> bin mapping (bin.h:61), numerical only."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MissingType.NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 0.0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0

    def find_bin(self, values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int, min_split_data: int,
                 use_missing: bool = True,
                 zero_as_missing: bool = False) -> None:
        """BinMapper::FindBin (bin.cpp:208-365) for a numerical feature.
        ``values`` are the sampled non-zero values; the other
        total_sample_cnt - len(values) sampled values were zeros."""
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        values = values[~nan_mask]

        if not use_missing:
            self.missing_type = MissingType.NONE
        elif zero_as_missing:
            self.missing_type = MissingType.ZERO
        else:
            self.missing_type = (MissingType.NONE if na_cnt == 0
                                 else MissingType.NAN)
        if not use_missing:
            na_cnt = 0

        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        # distinct values with zero spliced in at its sorted position:
        # runs of ulp-near neighbours collapse to their LAST value, as
        # the reference's sequential CheckDoubleEqualOrdered chain does
        values = np.sort(values)
        if len(values):
            near = np.nextafter(values[:-1], np.inf) >= values[1:]
            starts = np.concatenate([[0], np.flatnonzero(~near) + 1])
            ends = np.concatenate([starts[1:], [len(values)]])
            dv = values[ends - 1].astype(np.float64)
            cnts = (ends - starts).astype(np.int64)
            if values[0] > 0.0 and zero_cnt > 0:
                dv = np.insert(dv, 0, 0.0)
                cnts = np.insert(cnts, 0, zero_cnt)
            elif values[-1] < 0.0:
                if zero_cnt > 0:
                    dv = np.append(dv, 0.0)
                    cnts = np.append(cnts, zero_cnt)
            else:
                cross = np.flatnonzero((dv[:-1] < 0.0)
                                       & (values[starts[1:]] > 0.0))
                if len(cross):
                    pos = cross[0] + 1
                    dv = np.insert(dv, pos, 0.0)
                    cnts = np.insert(cnts, pos, zero_cnt)
        else:
            dv = np.array([0.0])
            cnts = np.array([zero_cnt], dtype=np.int64)

        self.min_val = float(dv[0])
        self.max_val = float(dv[-1])

        if self.missing_type == MissingType.ZERO:
            bounds = find_bin_with_zero_as_one_bin(
                dv, cnts, max_bin, total_sample_cnt, min_data_in_bin)
            if len(bounds) == 2:
                self.missing_type = MissingType.NONE
        elif self.missing_type == MissingType.NONE:
            bounds = find_bin_with_zero_as_one_bin(
                dv, cnts, max_bin, total_sample_cnt, min_data_in_bin)
        else:
            bounds = find_bin_with_zero_as_one_bin(
                dv, cnts, max_bin - 1, total_sample_cnt - na_cnt,
                min_data_in_bin)
            bounds.append(np.nan)
        self.bin_upper_bound = np.array(bounds)
        self.num_bin = len(bounds)
        self.default_bin = int(np.searchsorted(
            self.bin_upper_bound[:self.num_searched()], 0.0, side="left"))
        cnt_in_bin = self._count_in_bins(dv, cnts, na_cnt)

        # trivial: one bin, or no split point keeps min_split_data rows
        # on both sides (bin.cpp NeedFilter)
        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and min_split_data > 0:
            self.is_trivial = self._need_filter(cnt_in_bin, total_sample_cnt,
                                                min_split_data)
        if total_sample_cnt > 0 and cnt_in_bin:
            self.sparse_rate = cnt_in_bin[self.default_bin] / total_sample_cnt

    def num_searched(self) -> int:
        """Bounds that ``value_to_bin`` searches: all but the last
        (+inf), and all but the NaN bin's too under MissingType.NAN."""
        r = self.num_bin - 1
        if self.missing_type == MissingType.NAN:
            r -= 1
        return r

    def _count_in_bins(self, dv, cnts, na_cnt) -> List[int]:
        bounds = np.where(np.isnan(self.bin_upper_bound), np.inf,
                          self.bin_upper_bound)
        idx = np.searchsorted(bounds, dv, side="left")
        cnt_in_bin = np.bincount(idx, weights=np.asarray(cnts, np.float64),
                                 minlength=self.num_bin)
        cnt_in_bin = cnt_in_bin.astype(np.int64).tolist()
        if self.missing_type == MissingType.NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        return cnt_in_bin

    def _need_filter(self, cnt_in_bin, total_cnt, filter_cnt) -> bool:
        """NeedFilter (bin.cpp:44-73) for a numerical feature."""
        sum_left = 0
        for i in range(self.num_bin - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True

    def value_to_bin(self, value) -> np.ndarray:
        """Vectorized BinMapper::ValueToBin (bin.h:452-488): the first
        bin whose upper bound is >= the value; NaN reads as 0.0, or
        goes to the last bin under MissingType.NAN."""
        values = np.atleast_1d(np.asarray(value, dtype=np.float64))
        nan_mask = np.isnan(values)
        out = np.searchsorted(self.bin_upper_bound[:self.num_searched()],
                              np.where(nan_mask, 0.0, values),
                              side="left").astype(np.int32)
        if self.missing_type == MissingType.NAN:
            out[nan_mask] = self.num_bin - 1
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """BinToValue (bin.h:109): a bin's upper bound."""
        return float(self.bin_upper_bound[bin_idx])

    def feature_info(self) -> str:
        """The model header's ``feature_infos=`` entry (dataset.cpp)."""
        if self.is_trivial:
            return "none"
        return f"[{self.min_val:g}:{self.max_val:g}]"
