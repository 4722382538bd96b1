"""The binned training set: mappers on the host, bins on the device.

The JAX package's ``io/dataset.py`` (reference Dataset/Metadata,
include/LightGBM/dataset.h:36-622, src/io/dataset_loader.cpp:196-235),
dense route only: rows are sampled and a BinMapper found per column on
the host (numpy, copied), trivial columns are dropped, and the matrix is
binned on the device into one feature-major ``[F, N]`` tensor (uint8 up
to 256 bins, int32 beyond), the layout the histogram kernels read. Under
the 4-bit packed tier the set keeps its bins packed two per byte
(``grower_bins(packed4=True)``); every other reader gets them unpacked
from ``bins_t``. Categorical columns are binned on the device too, by a
lookup of their truncated values among the mapper's categories.
A valid set (``create_valid``) is binned with its reference's mappers on
the reference's device; ``subset`` selects rows of the bins on the
device with the same mappers (the folds of ``cv``).
EFB bundling and the sparse route are not ported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.hist_wave import pack4, unpack4
from ..ops.split import FeatureMeta
from ..utils import log
from ..utils.device import resolve_device
from .binning import BinMapper, BinType, MissingType


class Metadata:
    """Labels, weights, query groups and init scores (dataset.h:36-249).
    ``group`` holds each query's row count; they become
    ``query_boundaries``, the first row of each query and the total."""

    def __init__(self, label=None, weight=None, init_score=None,
                 group=None):
        self.label = (None if label is None
                      else np.asarray(label, np.float32).reshape(-1))
        self.weights = (None if weight is None
                        else np.asarray(weight, np.float32).reshape(-1))
        self.init_score = (None if init_score is None
                           else np.asarray(init_score, np.float64))
        self.query_boundaries = None
        if group is not None:
            self.set_group(group)

    def set_group(self, group) -> None:
        g = np.asarray(group, np.int64).reshape(-1)
        self.query_boundaries = np.concatenate([[0], np.cumsum(g)]).astype(
            np.int64)

    @property
    def num_queries(self) -> int:
        if self.query_boundaries is None:
            return 0
        return len(self.query_boundaries) - 1

    def check(self, num_data: int) -> None:
        if self.label is not None and len(self.label) != num_data:
            log.fatal(f"Length of label ({len(self.label)}) is not same "
                      f"as number of data ({num_data})")
        if self.weights is not None and len(self.weights) != num_data:
            log.fatal("Length of weights differs from number of data")
        if (self.query_boundaries is not None
                and self.query_boundaries[-1] != num_data):
            log.fatal("Sum of query counts differs from number of data")


def find_column_mappers(X: np.ndarray, config,
                        categorical: Sequence[int] = ()) -> List[BinMapper]:
    """Sample rows and find a BinMapper per column, trivial ones
    included (DatasetLoader::ConstructBinMappersFromTextData,
    dataset_loader.cpp:196-235, 388-433); the columns in ``categorical``
    get categorical mappers."""
    n, nf = X.shape
    sample_cnt = min(config.bin_construct_sample_cnt, n)
    if sample_cnt < n:
        rng = np.random.default_rng(config.data_random_seed)
        sample = X[np.sort(rng.choice(n, sample_cnt, replace=False))]
    else:
        sample = X
    snum = sample.shape[0]
    filter_cnt = 0
    if config.min_data_in_leaf > 0 and n > 0:
        # the min_data filter scaled by the sample/total ratio
        filter_cnt = max(int(config.min_data_in_leaf * snum / n), 1)
    cats = set(categorical)
    mappers = []
    for j in range(nf):
        col = sample[:, j].astype(np.float64)
        # zeros are implied by the sample count, as in the reference
        nonzero = col[(np.abs(col) > 1e-35) | np.isnan(col)]
        m = BinMapper()
        m.find_bin(nonzero, snum, config.max_bin, config.min_data_in_bin,
                   filter_cnt,
                   BinType.CATEGORICAL if j in cats else BinType.NUMERICAL,
                   config.use_missing, config.zero_as_missing)
        mappers.append(m)
    return mappers


def category_bins(col: torch.Tensor, m: BinMapper) -> torch.Tensor:
    """A categorical column (float64, on any device) -> int64 bins, as
    ``BinMapper.value_to_bin``: each value truncated toward zero is
    looked up among the mapper's categories (a searchsorted over the
    sorted categories and an equality check); NaN, negative values and
    categories without a bin go to the last bin. Categories are exact in
    float64 (``int(v)`` of a float64 built them), so the lookup runs in
    float64 and values beyond int64 never convert."""
    cats = np.asarray(m.bin_2_categorical, np.float64)
    order = np.argsort(cats, kind="stable")
    keys = torch.from_numpy(cats[order]).to(col.device)
    bins = torch.from_numpy(order.astype(np.int64)).to(col.device)
    last = m.num_bin - 1
    if keys.numel() == 0:
        return torch.full(col.shape, last, dtype=torch.int64,
                          device=col.device)
    t = torch.trunc(col)
    idx = torch.searchsorted(keys, t).clamp(max=keys.numel() - 1)
    return torch.where(keys[idx] == t, bins[idx], last)


def bin_columns(X: torch.Tensor, mappers: Sequence[BinMapper],
                columns: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """Rows [N, F_total] (f32 or f64, on any device) -> feature-major
    bins [F, N] of ``dtype`` on the same device, one searchsorted per
    feature in float64: bit-equal to ``BinMapper.value_to_bin``."""
    n = X.shape[0]
    out = torch.empty((max(len(columns), 1), n), dtype=dtype,
                      device=X.device)
    if len(columns) == 0:
        out.zero_()
    for i, real in enumerate(columns):
        m = mappers[i]
        col = X[:, real].to(torch.float64)
        if m.bin_type == BinType.CATEGORICAL:
            out[i] = category_bins(col, m).to(dtype)
            continue
        nan = torch.isnan(col)
        bounds = torch.from_numpy(np.ascontiguousarray(
            m.bin_upper_bound[:m.num_searched()], np.float64)).to(X.device)
        b = torch.searchsorted(bounds, torch.where(nan, 0.0, col))
        if m.missing_type == MissingType.NAN:
            b = torch.where(nan, m.num_bin - 1, b)
        out[i] = b.to(dtype)
    return out


class BinnedDataset:
    """Binned training matrix and metadata on ``device``."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.num_data = 0
        self.num_total_features = 0
        self.mappers: List[BinMapper] = []        # per used (inner) feature
        self.used_feature_map = np.zeros(0, np.int32)
        self.real_to_inner: dict = {}
        self._bins: Optional[torch.Tensor] = None    # on device
        self.packed4 = False         # _bins [ceil(F/2), N], 4-bit bins
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.max_bin_global = 1

    def construct_from_matrix(self, X: np.ndarray, metadata: Metadata,
                              feature_names: Optional[List[str]] = None,
                              categorical: Sequence[int] = ()
                              ) -> "BinnedDataset":
        """Find the mappers on a host sample, then bin every row on the
        device (DatasetLoader::ConstructFromSampleData,
        dataset_loader.cpp:499); ``categorical`` lists the categorical
        columns."""
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        n, nf = X.shape
        self.num_data = n
        self.num_total_features = nf
        self.metadata = metadata
        metadata.check(n)
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(nf)])
        self.set_mappers(find_column_mappers(X, self.config, categorical))
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(self.device)
        self.bins_t = bin_columns(Xd, self.mappers, self.used_feature_map,
                                  self.bin_dtype())
        return self

    def create_valid(self, X: np.ndarray,
                     metadata: Metadata) -> "BinnedDataset":
        """A validation set binned with this set's mappers on this set's
        device (Dataset::CreateValid, dataset.cpp:368): the mappers are
        shared, never derived again."""
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        n, nf = X.shape
        if nf != self.num_total_features:
            log.fatal(f"The validation data has {nf} features, the "
                      f"training data {self.num_total_features}")
        metadata.check(n)
        v = self._sharing(n, metadata)
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(self.device)
        v.bins_t = bin_columns(Xd, self.mappers, self.used_feature_map,
                               self.bin_dtype())
        return v

    def subset(self, used_indices, metadata: Metadata) -> "BinnedDataset":
        """Rows ``used_indices`` (sorted) with this set's mappers, their
        bins selected on the device; ``metadata`` holds their fields."""
        idx = np.sort(np.asarray(used_indices, np.int64))
        metadata.check(len(idx))
        v = self._sharing(len(idx), metadata)
        v.bins_t = self.bins_t[:, torch.from_numpy(idx).to(self.device)]
        return v

    def _sharing(self, n: int, metadata: Metadata) -> "BinnedDataset":
        """An empty set of ``n`` rows with this set's mappers, names and
        device."""
        v = BinnedDataset(self.config, self.device)
        v.num_data = n
        v.num_total_features = self.num_total_features
        v.metadata = metadata
        v.feature_names = self.feature_names
        v.mappers = self.mappers
        v.used_feature_map = self.used_feature_map
        v.real_to_inner = self.real_to_inner
        v.max_bin_global = self.max_bin_global
        return v

    def set_mappers(self, all_mappers: List[BinMapper]) -> None:
        """Keep the non-trivial columns' mappers and the index maps."""
        used = [j for j, m in enumerate(all_mappers) if not m.is_trivial]
        if not used:
            log.warning("There are no meaningful features, as all feature "
                        "values are constant.")
        self.mappers = [all_mappers[j] for j in used]
        self.used_feature_map = np.asarray(used, np.int32)
        self.real_to_inner = {r: i for i, r in enumerate(used)}
        self.max_bin_global = max((m.num_bin for m in self.mappers),
                                  default=1)

    @property
    def bins_t(self) -> Optional[torch.Tensor]:
        """[F, N] bins on the device (unpacked on the fly when the set
        holds them packed)."""
        if self.packed4:
            return unpack4(self._bins, self._num_bin_rows)
        return self._bins

    @bins_t.setter
    def bins_t(self, bins: torch.Tensor) -> None:
        self._bins = bins
        self.packed4 = False

    def grower_bins(self, packed4: bool) -> torch.Tensor:
        """The bins the wave grower reads: [F, N], or with ``packed4``
        [ceil(F/2), N] two 4-bit bins per byte (the JAX package's
        ``_pack4_host``). The set keeps the last form asked for, so the
        packed tier holds half the bytes on the device."""
        b = self.bins_in(packed4)
        if not b.is_contiguous():
            self._bins = b = b.contiguous()
        return b

    def bins_in(self, packed4: bool) -> torch.Tensor:
        """``grower_bins`` without its copy of a shared view
        (``share_bins``)."""
        if packed4 != self.packed4:
            if packed4:
                self._num_bin_rows = self._bins.shape[0]
                self._bins = pack4(self._bins)
            else:
                self._bins = unpack4(self._bins, self._num_bin_rows)
            self.packed4 = packed4
        return self._bins

    def share_bins(self, view: torch.Tensor) -> None:
        """Hold ``view``, this set's columns of a booster's combined bin
        matrix in the form ``bins_in`` last gave, instead of a copy of
        its own."""
        self._bins = view

    def bin_dtype(self) -> torch.dtype:
        return torch.uint8 if self.max_bin_global <= 256 else torch.int32

    @property
    def num_features(self) -> int:
        return len(self.mappers)

    def feature_meta(self) -> FeatureMeta:
        """Per-feature bin metadata (host numpy); one dummy single-bin
        feature when every column is trivial, matching the [1, N] zero
        bins (gbdt.cpp:378-396)."""
        if not self.mappers:
            return FeatureMeta(num_bin=np.ones(1, np.int32),
                               missing_type=np.zeros(1, np.int32),
                               default_bin=np.zeros(1, np.int32),
                               monotone=np.zeros(1, np.int32),
                               penalty=np.ones(1, np.float32))
        cfg = self.config
        mono = np.zeros(self.num_features, np.int32)
        pen = np.ones(self.num_features, np.float32)
        for i, real in enumerate(self.used_feature_map):
            if real < len(cfg.monotone_constraints or ()):
                mono[i] = cfg.monotone_constraints[real]
            if real < len(cfg.feature_contri or ()):
                pen[i] = cfg.feature_contri[real]
        return FeatureMeta(
            num_bin=np.array([m.num_bin for m in self.mappers], np.int32),
            missing_type=np.array([m.missing_type for m in self.mappers],
                                  np.int32),
            default_bin=np.array([m.default_bin for m in self.mappers],
                                 np.int32),
            monotone=mono, penalty=pen,
            is_cat=np.array([int(m.bin_type == BinType.CATEGORICAL)
                             for m in self.mappers], np.int32))

    def feature_infos(self) -> List[str]:
        """Per REAL feature; 'none' for dropped ones (model header)."""
        return ["none" if real not in self.real_to_inner
                else self.mappers[self.real_to_inner[real]].feature_info()
                for real in range(self.num_total_features)]
