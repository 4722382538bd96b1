"""Feature binning: value -> bin mapping for numerical and categorical
features.

The JAX package's ``io/binning.py`` (reference BinMapper: bin.h:61,
src/io/bin.cpp:74-365), copied: binning is one-time host preprocessing,
so it stays numpy, and the bounds and category bins it finds must be the
reference's exactly, because they decide every tree.

- ``greedy_find_bin``               <- GreedyFindBin (bin.cpp:74)
- ``find_bin_with_zero_as_one_bin`` <- FindBinWithZeroAsOneBin (bin.cpp:152)
- ``BinMapper.find_bin``            <- BinMapper::FindBin (bin.cpp:208)
- ``BinMapper.value_to_bin``        <- BinMapper::ValueToBin (bin.h:452)

A categorical feature's bins are its categories by descending count
(bin.cpp:304-365); values that got no bin, negative ones and NaN read as
the last bin. Tree nodes store the ``MissingType`` codes in their
decision_type bits.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils import log

KZERO_THRESHOLD = 1e-35          # meta.h:40


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


class BinType:
    NUMERICAL = 0
    CATEGORICAL = 1


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
    """Per-feature value -> bin mapping (bin.h:61)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MissingType.NONE
        self.bin_type: int = BinType.NUMERICAL
        self.is_trivial: bool = True
        self.sparse_rate: float = 0.0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: dict = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0

    def find_bin(self, values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int, min_split_data: int,
                 bin_type: int = BinType.NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False) -> None:
        """BinMapper::FindBin (bin.cpp:208-365). ``values`` are the
        sampled non-zero values; the other total_sample_cnt - len(values)
        sampled values were zeros."""
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

        self.bin_type = bin_type
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

        if bin_type == BinType.CATEGORICAL:
            cnt_in_bin = self._find_bin_categorical(
                dv, cnts, max_bin, total_sample_cnt, min_data_in_bin, na_cnt)
        else:
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
                self.bin_upper_bound[:self.num_searched()], 0.0,
                side="left"))
            cnt_in_bin = self._count_in_bins(dv, cnts, na_cnt)

        # trivial: one bin, or no split point keeps min_split_data rows
        # on both sides (bin.cpp NeedFilter)
        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and min_split_data > 0:
            self.is_trivial = self._need_filter(cnt_in_bin, total_sample_cnt,
                                                min_split_data)
        if total_sample_cnt > 0 and cnt_in_bin:
            self.sparse_rate = cnt_in_bin[self.default_bin] / total_sample_cnt

    def _find_bin_categorical(self, dv, cnts, max_bin, total_sample_cnt,
                              min_data_in_bin, na_cnt) -> List[int]:
        """The categorical branch of FindBin (bin.cpp:304-365): one bin
        per category by descending count (a stable sort; category 0 is
        swapped out of bin 0), until 99% of the non-NaN sample is binned
        and max_bin is reached, or a category past the second falls
        under min_data_in_bin. Negative values count as NaN. Returns the
        count of each bin."""
        distinct_int: List[int] = []
        counts_int: List[int] = []
        for v, c in zip(dv, cnts):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                log.warning("Met negative value in categorical features, "
                            "will convert it to NaN")
            elif distinct_int and iv == distinct_int[-1]:
                counts_int[-1] += int(c)
            else:
                distinct_int.append(iv)
                counts_int.append(int(c))
        self.num_bin = 0
        cnt_in_bin: List[int] = []
        if total_sample_cnt - na_cnt > 0:
            if distinct_int and distinct_int[-1] // 100 > len(distinct_int):
                log.warning("Met categorical feature which contains sparse "
                            "values. Consider renumbering to consecutive "
                            "integers started from zero")
            order = np.argsort(-np.array(counts_int), kind="stable")
            counts_int = [counts_int[i] for i in order]
            distinct_int = [distinct_int[i] for i in order]
            if distinct_int and distinct_int[0] == 0:
                if len(counts_int) == 1:
                    counts_int.append(0)
                    distinct_int.append(distinct_int[0] + 1)
                counts_int[0], counts_int[1] = counts_int[1], counts_int[0]
                distinct_int[0], distinct_int[1] = (distinct_int[1],
                                                    distinct_int[0])
            cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
            self.bin_2_categorical = []
            self.categorical_2_bin = {}
            used_cnt = 0
            max_bin = min(len(distinct_int), max_bin)
            cur_cat = 0
            while (cur_cat < len(distinct_int)
                   and (used_cnt < cut_cnt or self.num_bin < max_bin)):
                if counts_int[cur_cat] < min_data_in_bin and cur_cat > 1:
                    break
                self.bin_2_categorical.append(distinct_int[cur_cat])
                self.categorical_2_bin[distinct_int[cur_cat]] = self.num_bin
                used_cnt += counts_int[cur_cat]
                cnt_in_bin.append(counts_int[cur_cat])
                self.num_bin += 1
                cur_cat += 1
            # NaN gets its own last bin only when every category got one;
            # otherwise the leftovers and NaN share the last bin
            if cur_cat == len(distinct_int) and na_cnt > 0:
                self.missing_type = MissingType.NAN
                self.num_bin += 1
                cnt_in_bin.append(na_cnt)
            else:
                self.missing_type = MissingType.NONE
        self.default_bin = 0
        return cnt_in_bin

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
        """NeedFilter (bin.cpp:44-73): no split keeps filter_cnt rows on
        both sides. A categorical feature of more than two bins is always
        kept."""
        if self.bin_type == BinType.CATEGORICAL:
            if len(cnt_in_bin) > 2:
                return False
            return not any(filter_cnt <= c <= total_cnt - filter_cnt
                           for c in cnt_in_bin[:-1])
        sum_left = 0
        for i in range(self.num_bin - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True

    def value_to_bin(self, value) -> np.ndarray:
        """Vectorized BinMapper::ValueToBin (bin.h:452-488). Numerical:
        the first bin whose upper bound is >= the value; NaN reads as
        0.0, or goes to the last bin under MissingType.NAN. Categorical:
        the value truncated to an integer (NaN as -1) and looked up;
        unknown categories go to the last bin."""
        values = np.atleast_1d(np.asarray(value, dtype=np.float64))
        nan_mask = np.isnan(values)
        if self.bin_type == BinType.CATEGORICAL:
            out = np.full(values.shape, self.num_bin - 1, dtype=np.int32)
            with np.errstate(invalid="ignore"):     # NaN, +-inf: replaced
                iv = np.where(nan_mask, -1, values.astype(np.int64))
            for cat, b in self.categorical_2_bin.items():
                out[iv == cat] = b
            return out
        out = np.searchsorted(self.bin_upper_bound[:self.num_searched()],
                              np.where(nan_mask, 0.0, values),
                              side="left").astype(np.int32)
        if self.missing_type == MissingType.NAN:
            out[nan_mask] = self.num_bin - 1
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """BinToValue (bin.h:109): a numerical bin's upper bound, a
        categorical bin's category."""
        if self.bin_type == BinType.CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])

    def feature_info(self) -> str:
        """The model header's ``feature_infos=`` entry (dataset.cpp): the
        value range, or the categories joined by ':'."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BinType.CATEGORICAL:
            return ":".join(str(c) for c in self.bin_2_categorical)
        return f"[{self.min_val:g}:{self.max_val:g}]"

    def to_dict(self) -> dict:
        """Plain Python types only, the JAX package's keys (a binary
        dataset file loads in both packages)."""
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "bin_type": self.bin_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = d["num_bin"]
        m.missing_type = d["missing_type"]
        m.bin_type = d["bin_type"]
        m.is_trivial = d["is_trivial"]
        m.sparse_rate = d["sparse_rate"]
        m.bin_upper_bound = np.array(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = list(d["bin_2_categorical"])
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = d["min_val"]
        m.max_val = d["max_val"]
        m.default_bin = d["default_bin"]
        return m
