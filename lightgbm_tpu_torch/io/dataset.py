"""The binned training set: mappers on the host, bins on the device.

The JAX package's ``io/dataset.py`` (reference Dataset/Metadata,
include/LightGBM/dataset.h:36-622, src/io/dataset_loader.cpp:196-235),
dense route only: rows are sampled and a BinMapper found per column on
the host (numpy, copied), trivial columns are dropped, and the matrix is
binned on the device into one feature-major ``[F, N]`` tensor (uint8 up
to 256 bins, int32 beyond), the layout the histogram kernels read.
EFB bundling, the sparse route and categorical features are not ported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.split import FeatureMeta
from ..utils import log
from ..utils.device import resolve_device
from .binning import BinMapper, MissingType


class Metadata:
    """Labels and weights (dataset.h:36-249); init scores are not
    ported yet."""

    def __init__(self, label=None, weight=None):
        self.label = (None if label is None
                      else np.asarray(label, np.float32).reshape(-1))
        self.weights = (None if weight is None
                        else np.asarray(weight, np.float32).reshape(-1))

    def check(self, num_data: int) -> None:
        if self.label is not None and len(self.label) != num_data:
            log.fatal(f"Length of label ({len(self.label)}) is not same "
                      f"as number of data ({num_data})")
        if self.weights is not None and len(self.weights) != num_data:
            log.fatal("Length of weights differs from number of data")


def find_column_mappers(X: np.ndarray, config) -> List[BinMapper]:
    """Sample rows and find a BinMapper per column, trivial ones
    included (DatasetLoader::ConstructBinMappersFromTextData,
    dataset_loader.cpp:196-235, 388-433)."""
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
    mappers = []
    for j in range(nf):
        col = sample[:, j].astype(np.float64)
        # zeros are implied by the sample count, as in the reference
        nonzero = col[(np.abs(col) > 1e-35) | np.isnan(col)]
        m = BinMapper()
        m.find_bin(nonzero, snum, config.max_bin, config.min_data_in_bin,
                   filter_cnt, config.use_missing, config.zero_as_missing)
        mappers.append(m)
    return mappers


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
        self.bins_t: Optional[torch.Tensor] = None   # [F, N] on device
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.max_bin_global = 1

    def construct_from_matrix(self, X: np.ndarray, metadata: Metadata,
                              feature_names: Optional[List[str]] = None
                              ) -> "BinnedDataset":
        """Find the mappers on a host sample, then bin every row on the
        device (DatasetLoader::ConstructFromSampleData,
        dataset_loader.cpp:499)."""
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
        self.set_mappers(find_column_mappers(X, self.config))
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(self.device)
        self.bins_t = bin_columns(Xd, self.mappers, self.used_feature_map,
                                  self.bin_dtype())
        return self

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
            monotone=mono, penalty=pen)

    def feature_infos(self) -> List[str]:
        """Per REAL feature; 'none' for dropped ones (model header)."""
        return ["none" if real not in self.real_to_inner
                else self.mappers[self.real_to_inner[real]].feature_info()
                for real in range(self.num_total_features)]
