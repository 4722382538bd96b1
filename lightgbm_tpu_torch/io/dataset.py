"""The binned training set: mappers on the host, bins on the device.

The JAX package's ``io/dataset.py`` (reference Dataset/Metadata,
include/LightGBM/dataset.h:36-622, src/io/dataset_loader.cpp:196-235).
Rows are sampled and a BinMapper found per column on the host (numpy,
copied), trivial columns are dropped, and the matrix is binned on the
device into one feature-major ``[F, N]`` tensor (uint8 up to 256 bins,
int32 beyond), the layout the histogram kernels read: streamed in
chunks of the used columns where ``tpu_ingest`` says so (io/ingest.py,
the default on a card), else uploaded whole (``_bin_dense``). Categorical
columns are binned on the device too, by a lookup of their truncated
values among the mapper's categories. Under the 4-bit packed tier the
set keeps its bins packed two per byte (``grower_bins(packed4=True)``);
every other reader gets them unpacked from ``bins_t``.

Sparse input (io/sparse.py ``SparseMatrix``) below the
``sparse_threshold`` density stays CSR on the host
(``_construct_from_sparse``): mappers sampled from CSR, the explicit
entries binned on the device and scattered into a tensor filled with
each feature's bin of 0.0; the set keeps those entries as coordinates
for the sparse histogram tier where ``want_coords`` says so.

Exclusive feature bundling (io/efb.py, ``_apply_efb``): where
``enable_bundle`` holds and a sample of the binned rows shows mutually
exclusive features, the set keeps bundle columns instead of member
columns (``bins_t`` is then ``[F_b, N]``, ``bundled_bins``), and
``feature_meta`` carries each member's bundle and offset. A sparse set
that bundles is scattered straight into its bundle columns. A valid set
(``create_valid``) is binned with its reference's mappers on the
reference's device and bundled with its bundles; ``subset`` selects
rows of the bins on the device and keeps the parent's bundles (the folds
of ``cv``). Binary files hold member bins and no bundles, as the JAX
package's do, so a reloaded set trains unbundled.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..obs import registry as obs
from ..ops.hist_wave import pack4, unpack4
from ..ops.split import FeatureMeta
from ..utils import log, timing
from ..utils.device import resolve_device
from . import efb
from . import ingest
from . import sparse as sp
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
                        categorical: Sequence[int] = (),
                        total_rows: Optional[int] = None,
                        presampled: bool = False) -> List[BinMapper]:
    """Sample rows and find a BinMapper per column, trivial ones
    included (DatasetLoader::ConstructBinMappersFromTextData,
    dataset_loader.cpp:196-235, 388-433); the columns in ``categorical``
    get categorical mappers. ``presampled``: ``X`` already is the sample
    of a ``total_rows``-row dataset (``LGBM_DatasetCreateFromSampledColumn``)
    and is not sampled again; only the min_data filter scales by the
    sample's share of ``total_rows``."""
    n, nf = X.shape
    total = n if total_rows is None else max(int(total_rows), 1)
    sample_cnt = n if presampled else min(config.bin_construct_sample_cnt, n)
    if sample_cnt < n:
        rng = np.random.default_rng(config.data_random_seed)
        sample = X[np.sort(rng.choice(n, sample_cnt, replace=False))]
    else:
        sample = X
    snum = sample.shape[0]
    filter_cnt = 0
    if config.min_data_in_leaf > 0 and total > 0:
        # the min_data filter scaled by the sample/total ratio
        filter_cnt = max(int(config.min_data_in_leaf * snum / total), 1)
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


def bin_values(col: torch.Tensor, m: BinMapper) -> torch.Tensor:
    """float64 values (on any device) -> int64 bins of mapper ``m``, one
    searchsorted (numerical) or category lookup: bit-equal to
    ``BinMapper.value_to_bin``."""
    if m.bin_type == BinType.CATEGORICAL:
        return category_bins(col, m)
    nan = torch.isnan(col)
    bounds = torch.from_numpy(np.ascontiguousarray(
        m.bin_upper_bound[:m.num_searched()], np.float64)).to(col.device)
    b = torch.searchsorted(bounds, torch.where(nan, 0.0, col))
    if m.missing_type == MissingType.NAN:
        b = torch.where(nan, m.num_bin - 1, b)
    return b


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
        out[i] = bin_values(X[:, real].to(torch.float64),
                            mappers[i]).to(dtype)
    return out


class SparseEntries:
    """The explicit entries of a CSR matrix's used features, binned on
    the device and grouped by feature (stable by row within a feature,
    the order of the JAX package's ``_entries_by_column``): ``codes``,
    ``feat`` (inner feature) and ``rows`` [E] int32 on the device, and
    ``bounds`` [F + 1] (host) each feature's slice. ``upload`` builds
    them from one upload of the whole matrix (the default); the streamed
    route (io/ingest.py ``SparseDeviceBinner``, ``tpu_ingest=1``) chunk
    by chunk."""

    def __init__(self, codes: torch.Tensor, rows: torch.Tensor,
                 feat: torch.Tensor, bounds: np.ndarray):
        self.codes, self.rows, self.feat = codes, rows, feat
        self.bounds = bounds

    @classmethod
    def upload(cls, sm, mappers: Sequence[BinMapper], used_feature_map,
               device) -> "SparseEntries":
        n, nf = sm.shape
        i64 = torch.int64
        counts = torch.from_numpy(np.diff(sm.indptr)).to(device)
        rows = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=device), counts)
        cols = torch.from_numpy(sm.cols).to(device)
        order = torch.sort(cols, stable=True).indices
        cols, rows = cols[order], rows[order]
        vals = torch.from_numpy(sm.data).to(device)[order]
        del order
        obs.counter("ingest/h2d_bytes").add(
            sm.indptr.nbytes + sm.cols.nbytes + sm.data.nbytes)
        obs.counter("ingest/rows_one_copy").add(n)
        used = np.asarray(used_feature_map, np.int64)
        real_bounds = torch.searchsorted(
            cols, torch.arange(nf + 1, dtype=i64, device=device)).cpu().numpy()
        del cols
        sizes = real_bounds[used + 1] - real_bounds[used]
        bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        E = int(bounds[-1])
        codes = torch.empty(E, dtype=torch.int32, device=device)
        rows_out = torch.empty(E, dtype=torch.int32, device=device)
        feat = torch.empty(E, dtype=torch.int32, device=device)
        for i, real in enumerate(used):
            a, b = int(real_bounds[real]), int(real_bounds[real + 1])
            sl = slice(int(bounds[i]), int(bounds[i + 1]))
            if a == b:
                continue
            codes[sl] = bin_values(vals[a:b], mappers[i]).to(torch.int32)
            rows_out[sl] = rows[a:b]
            feat[sl] = i
        return cls(codes, rows_out, feat, bounds)

    def matrix(self, n: int, zero_bins, dtype) -> torch.Tensor:
        """The [F, N] bins: each feature's bin of 0.0, its entries'
        codes at their rows."""
        f = len(self.bounds) - 1
        zb = torch.as_tensor(np.asarray(zero_bins, np.int64),
                             device=self.codes.device).to(dtype)
        bins = zb[:, None].expand(max(f, 1), n).clone()
        bins[self.feat.to(torch.int64), self.rows.to(torch.int64)] = \
            self.codes.to(dtype)
        return bins


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
        # EFB (io/efb.py): None, or the bundles of inner features whose
        # columns _bins holds, with each member's bundle and offset
        self.bundles: Optional[List[List[int]]] = None
        self.member_bundle: Optional[np.ndarray] = None
        self.member_offset: Optional[np.ndarray] = None
        self.bundle_width = 0
        # the sparse route (io/sparse.py): the input's nnz and density,
        # each feature's bin of 0.0, and for a train set the sparse
        # histogram tier may read, its binned entries (codes, inner
        # feature, row) [E] int32 on the device
        self.sparse_nnz = 0
        self.sparse_density: Optional[float] = None
        self.sparse_zero_bins: Optional[np.ndarray] = None
        self.sparse_coords = None
        # a sharded set (the row-sharded learners, parallel/learners.py):
        # its device bins hold only the rows [lo, hi) of its num_data;
        # the metadata stay every row's. None: every row
        self.row_block: Optional[tuple] = None

    def construct_from_matrix(self, X, metadata: Metadata,
                              feature_names: Optional[List[str]] = None,
                              categorical: Sequence[int] = (),
                              mappers: Optional[List[BinMapper]] = None,
                              row_block: Optional[tuple] = None
                              ) -> "BinnedDataset":
        """Find the mappers on a host sample, then bin every row on the
        device (DatasetLoader::ConstructFromSampleData,
        dataset_loader.cpp:499; ``_bin_dense``) and bundle exclusive
        features (``_apply_efb``); ``categorical`` lists the categorical
        columns. ``mappers`` (one per column, trivial ones included) are
        used as given instead, and then nothing is bundled, as in the JAX
        package. ``X`` may be a ``SparseMatrix`` (the sparse route).

        ``row_block`` (lo, hi): the sharded ingest of a row-sharded
        learner's rank (io/ingest.py ``bin_matrix_sharded``): the mappers
        and bundles come from every row, as in the whole set, and only
        rows [lo, hi) are binned onto the device."""
        if row_block is not None:
            if isinstance(X, sp.SparseMatrix):
                log.fatal("a sharded set takes a dense matrix")
            self.row_block = (int(row_block[0]), int(row_block[1]))
        if isinstance(X, sp.SparseMatrix):
            return self._construct_from_sparse(X, metadata, feature_names,
                                               categorical, mappers)
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
        with timing.phase("binning/find_bins"):
            self.set_mappers(mappers if mappers is not None else
                             find_column_mappers(X, self.config,
                                                 categorical))
        with timing.phase("binning/bin_matrix") as ph:
            self.bins_t = ph.watch(self._bin_dense(X))
        if mappers is None:
            sample = None
            if self.row_block is not None:
                # the bundles of every rank: found on the whole set's
                # row sample, binned here on the host's behalf
                idx = efb.sample_rows_for_probe(n)
                rows = X if idx is None else X[idx]
                sample = bin_columns(
                    torch.from_numpy(np.ascontiguousarray(rows)).to(
                        self.device), self.mappers, self.used_feature_map,
                    self.bin_dtype()).T.cpu().numpy()
            with timing.phase("binning/efb"):
                self._apply_efb(self._find_bundles(sample))
        return self

    def _bin_dense(self, X: np.ndarray) -> torch.Tensor:
        """The [F, N] bins of a host matrix: streamed in chunks where
        ``tpu_ingest`` says so (io/ingest.py ``DeviceBinner``: the used
        columns only, no device copy of the matrix), else the one-copy
        route (the whole matrix uploaded, then binned a feature at a
        time). Both bin in float64 on the device: the same bits."""
        block = self.row_block
        if ingest.ingest_enabled(self.config, self.device) or (
                block is not None and self.mappers):
            try:
                binner = ingest.DeviceBinner(
                    self.mappers, self.used_feature_map, self.config,
                    X.dtype, self.device)
            except ingest.IngestUnsupported as e:
                log.debug("streamed ingest unavailable (%s)", e)
            else:
                if block is not None:
                    return ingest.bin_matrix_sharded(binner, X, *block)
                return binner.bin_matrix(X)
        if block is not None:
            X = X[block[0]:block[1]]
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(self.device)
        obs.counter("ingest/h2d_bytes").add(int(X.nbytes))
        obs.counter("ingest/rows_one_copy").add(X.shape[0])
        return bin_columns(Xd, self.mappers, self.used_feature_map,
                           self.bin_dtype())

    def _construct_from_sparse(self, sm, metadata: Metadata, feature_names,
                               categorical, mappers) -> "BinnedDataset":
        """The CSR route (the JAX package's io/dataset.py:248-395): the
        host never builds the [N, F] float64 matrix. Mappers are sampled
        from CSR; the EFB decision is taken on the host bins of
        find_bundles' own row sample (``_sparse_bundles``); the
        explicit entries are binned on the device and scattered into the
        [F, N] bins, or straight into bundle columns. Above
        ``sparse_threshold`` density the input is densified (with the
        cliff warning) and takes the dense route."""
        cfg = self.config
        if not sp.route_sparse(cfg, sm):
            log.info("sparse input density %.4f is above the CSR route "
                     "gate (1 - sparse_threshold = %g): densifying",
                     sm.density, 1.0 - cfg.sparse_threshold)
            return self.construct_from_matrix(
                sm.to_dense(warn=True), metadata, feature_names,
                categorical, mappers)
        n, nf = sm.shape
        self.num_data = n
        self.num_total_features = nf
        self.metadata = metadata
        metadata.check(n)
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(nf)])
        with timing.phase("binning/find_bins"):
            self.set_mappers(mappers if mappers is not None else
                             sp.find_column_mappers_sparse(
                                 sm, cfg, set(categorical)))
        self._note_sparse(sm)
        bundles = None
        if mappers is None:
            with timing.phase("binning/efb"):
                bundles = self._sparse_bundles(sm)
        keep = sp.want_coords(cfg, sm.density) and bundles is None
        with timing.phase("binning/bin_matrix") as ph:
            self._bin_sparse(sm, bundles, keep)
            ph.watch(self._bins)
        return self

    def _note_sparse(self, sm) -> None:
        self.sparse_nnz = sm.nnz
        self.sparse_density = sm.density
        if self.mappers:
            self.sparse_zero_bins = sp.zero_bins(self.mappers)

    def _bin_sparse(self, sm, bundles, keep_coords: bool) -> None:
        """Bin the explicit entries on the device (``SparseEntries``),
        then fill the [F, N] bins, or the bundle columns of ``bundles``
        (``efb.bundle_bins_sparse``); ``keep_coords`` keeps the binned
        entries for the sparse histogram tier."""
        n = sm.shape[0]
        dtype = self.bin_dtype()
        if not self.mappers:
            self.bins_t = torch.zeros((1, n), dtype=dtype,
                                      device=self.device)
            return
        ent = None
        if ingest.sparse_ingest_enabled(self.config):
            try:
                binner = ingest.SparseDeviceBinner(
                    self.mappers, self.used_feature_map, self.config,
                    self.device)
            except ingest.IngestUnsupported as e:
                log.debug("streamed sparse ingest unavailable (%s)", e)
            else:
                ent = SparseEntries(*binner.bin_entries(sm))
        if ent is None:
            ent = SparseEntries.upload(sm, self.mappers,
                                       self.used_feature_map, self.device)
        zb = self.sparse_zero_bins
        if bundles is not None:
            db, nb = self._default_and_num_bins()
            self._set_bundles(bundles, *efb.bundle_bins_sparse(
                n, ent.codes, ent.bounds, ent.rows, zb, bundles, db, nb,
                dtype))
            return
        self.bins_t = ent.matrix(n, zb, dtype)
        if keep_coords:
            self.sparse_coords = (ent.codes, ent.feat, ent.rows)

    def _default_and_num_bins(self):
        return (np.array([m.default_bin for m in self.mappers], np.int32),
                np.array([m.num_bin for m in self.mappers], np.int32))

    def _find_bundles(self, sample_bins: Optional[np.ndarray] = None):
        """The bundles of this set's features (``efb.find_bundles`` over
        the host bins of its rng(3) row sample, taken from the device's
        bins unless ``sample_bins`` is given), or None when
        ``enable_bundle`` is off or nothing bundles (the JAX package's
        ``_apply_efb``, io/dataset.py:594-621)."""
        cfg = self.config
        if not cfg.enable_bundle or self.num_features <= 1:
            return None
        if sample_bins is None:
            idx = efb.sample_rows_for_probe(self.num_data)
            b = self._bins if idx is None else self._bins[
                :, torch.from_numpy(idx).to(self.device)]
            sample_bins = b.T.cpu().numpy()
        db, nb = self._default_and_num_bins()
        bundles = efb.find_bundles(sample_bins, db, nb,
                                   cfg.max_conflict_rate, presampled=True)
        if len(bundles) >= self.num_features:
            return None
        log.info("EFB bundled %d features into %d columns",
                 self.num_features, len(bundles))
        return bundles

    def _sparse_bundles(self, sm):
        """``_find_bundles`` for CSR input, before the entries are binned
        (the JAX package's probe ``_efb_would_bundle_sparse``,
        io/dataset.py:397): the rows of find_bundles' sample binned on the
        host from CSR, O(nnz of the sample)."""
        if not self.config.enable_bundle or self.num_features <= 1:
            return None
        idx = efb.sample_rows_for_probe(sm.shape[0])
        sample = sm if idx is None else sm.take_rows(idx)
        return self._find_bundles(sp.host_bins_from_sparse(
            sample, self.mappers, self.used_feature_map,
            np.uint8 if self.max_bin_global <= 256 else np.int32))

    def _apply_efb(self, bundles) -> None:
        """Replace the [F, N] member bins by the columns of ``bundles``
        (``efb.bundle_bins_device``); None leaves them."""
        if bundles is None:
            return
        db, nb = self._default_and_num_bins()
        self._set_bundles(bundles, *efb.bundle_bins_device(
            self._bins, bundles, db, nb))

    def _set_bundles(self, bundles, bundled, member_bundle, member_offset,
                     width) -> None:
        self.bundles = bundles
        self.bins_t = bundled
        self.member_bundle = member_bundle
        self.member_offset = member_offset
        self.bundle_width = width

    @property
    def bundled_bins(self) -> Optional[torch.Tensor]:
        """The bundle columns [F_b, N] on the device, or None."""
        return None if self.bundles is None else self._bins

    def member_bins(self) -> torch.Tensor:
        """[F, N] member bins on the device: ``bins_t``, or decoded from
        the bundle columns. A row where EFB let two members conflict
        (``max_conflict_rate`` > 0) decodes the earlier one to its
        default bin."""
        if self.bundles is None:
            return self.bins_t
        from ..ops.partition import member_column
        meta = self.feature_meta()
        return torch.stack([member_column(self._bins, j, meta)
                            for j in range(self.num_features)]).to(
            self.bin_dtype())

    def create_valid(self, X, metadata: Metadata) -> "BinnedDataset":
        """A validation set binned with this set's mappers on this set's
        device (Dataset::CreateValid, dataset.cpp:368) and bundled with
        its bundles: the mappers are shared, never derived again. ``X``
        may be a ``SparseMatrix``."""
        if isinstance(X, sp.SparseMatrix) and not sp.route_sparse(
                self.config, X):
            X = X.to_dense(warn=True)
        if not isinstance(X, sp.SparseMatrix):
            X = np.asarray(X)
            if X.dtype not in (np.float32, np.float64):
                X = X.astype(np.float64)
        n, nf = X.shape
        if nf != self.num_total_features:
            log.fatal(f"The validation data has {nf} features, the "
                      f"training data {self.num_total_features}")
        metadata.check(n)
        v = self._sharing(n, metadata)
        if isinstance(X, sp.SparseMatrix):
            v._note_sparse(X)
            v._bin_sparse(X, self.bundles, False)
            return v
        v.bins_t = v._bin_dense(X)
        v._apply_efb(self.bundles)
        return v

    def subset(self, used_indices, metadata: Metadata) -> "BinnedDataset":
        """Rows ``used_indices`` (sorted) with this set's mappers and
        bundles, their columns selected on the device; ``metadata`` holds
        their fields."""
        idx = np.sort(np.asarray(used_indices, np.int64))
        metadata.check(len(idx))
        v = self._sharing(len(idx), metadata)
        cols = self.bins_t[:, torch.from_numpy(idx).to(self.device)]
        if self.bundles is None:
            v.bins_t = cols
        else:
            v._set_bundles(self.bundles, cols, self.member_bundle,
                           self.member_offset, self.bundle_width)
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
        v.sparse_zero_bins = self.sparse_zero_bins
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
        holds them packed), or under EFB the [F_b, N] bundle columns,
        which ``feature_meta``'s bundle and offset decode."""
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
        meta = FeatureMeta(
            num_bin=np.array([m.num_bin for m in self.mappers], np.int32),
            missing_type=np.array([m.missing_type for m in self.mappers],
                                  np.int32),
            default_bin=np.array([m.default_bin for m in self.mappers],
                                 np.int32),
            monotone=mono, penalty=pen,
            is_cat=np.array([int(m.bin_type == BinType.CATEGORICAL)
                             for m in self.mappers], np.int32))
        if self.bundles is not None:
            meta = meta._replace(bundle=self.member_bundle,
                                 offset=self.member_offset)
        return meta

    def feature_infos(self) -> List[str]:
        """Per REAL feature; 'none' for dropped ones (model header)."""
        return ["none" if real not in self.real_to_inner
                else self.mappers[self.real_to_inner[real]].feature_info()
                for real in range(self.num_total_features)]

    # -- the binary file (SaveBinaryFile, dataset.cpp:542) ------------------

    # the JAX package's tokens (io/dataset.py:686-687): v2 nibble-packs
    # the columns of at most 16 bins; v1 files hold plain array bins
    BINARY_TOKEN = b"______LightGBM_TPU_Binary_File_Tokenv2____\n"
    BINARY_TOKEN_V1 = b"______LightGBM_TPU_Binary_File_Token______\n"

    def _pack_nibble_columns(self, bins: np.ndarray):
        """Columns of at most 16 bins packed two rows a byte (the
        reference's Dense4bitsBin, dense_nbits_bin.hpp:37-58), in the JAX
        package's dict layout. Returns (bins or that dict, packed
        columns)."""
        if bins.dtype != np.uint8 or not self.mappers:
            return bins, []
        packed_cols = [i for i, m in enumerate(self.mappers)
                       if m.num_bin <= 16]
        if not packed_cols:
            return bins, []
        out = {"shape": bins.shape}
        n = bins.shape[0]
        half = (n + 1) // 2
        for i in packed_cols:
            col = bins[:, i]
            lo = col[0::2]
            hi = np.zeros(half, np.uint8)
            hi[:n // 2] = col[1::2]
            out[i] = (lo | (hi << 4)).astype(np.uint8)
        packed_set = set(packed_cols)
        keep = [i for i in range(bins.shape[1]) if i not in packed_set]
        out["rest"] = bins[:, keep]
        out["keep"] = keep
        return out, packed_cols

    @staticmethod
    def _unpack_nibble_columns(bins, packed_cols) -> np.ndarray:
        if not packed_cols:
            return np.asarray(bins)
        n, f = bins["shape"]
        full = np.zeros((n, f), np.uint8)
        full[:, bins["keep"]] = bins["rest"]
        for i in packed_cols:
            b = bins[i]
            full[0::2, i] = b[: (n + 1) // 2] & 0x0F
            full[1::2, i] = (b[: n // 2] >> 4) & 0x0F
        return full

    def save_binary(self, filename: str) -> None:
        """The binary file: the token, then one pickled dict of numpy
        arrays and plain Python types (row-major [N, F] member bins; no
        bundles, as in the JAX package)."""
        import pickle
        host = np.ascontiguousarray(self.member_bins().cpu().numpy().T)
        md = self.metadata
        bins_repr, packed_cols = self._pack_nibble_columns(host)
        with open(filename, "wb") as fh:
            fh.write(self.BINARY_TOKEN)
            pickle.dump({
                "num_data": self.num_data,
                "num_total_features": self.num_total_features,
                "mappers": [m.to_dict() for m in self.mappers],
                "used_feature_map": np.asarray(self.used_feature_map,
                                               np.int32),
                "bins": bins_repr,
                "packed_cols": packed_cols,
                "label": md.label,
                "weights": md.weights,
                "query_boundaries": md.query_boundaries,
                "init_score": md.init_score,
                "feature_names": list(self.feature_names),
            }, fh, protocol=4)
        log.info("Saved binary dataset to %s", filename)

    @classmethod
    def is_binary_file(cls, filename: str) -> bool:
        try:
            with open(filename, "rb") as fh:
                tok = fh.read(len(cls.BINARY_TOKEN))
        except OSError:
            return False
        return tok in (cls.BINARY_TOKEN, cls.BINARY_TOKEN_V1)

    @classmethod
    def load_binary(cls, filename: str, config,
                    device=None) -> "BinnedDataset":
        """A binary file's set, its bins on ``device`` (None: cuda:0)."""
        import pickle
        with open(filename, "rb") as fh:
            tok = fh.read(len(cls.BINARY_TOKEN))
            if tok not in (cls.BINARY_TOKEN, cls.BINARY_TOKEN_V1):
                log.fatal(f"{filename} is not a lightgbm_tpu binary file")
            d = pickle.load(fh)
        ds = cls(config, device)
        ds.num_data = d["num_data"]
        ds.num_total_features = d["num_total_features"]
        ds.mappers = [BinMapper.from_dict(m) for m in d["mappers"]]
        ds.used_feature_map = np.asarray(d["used_feature_map"], np.int32)
        ds.real_to_inner = {int(r): i
                            for i, r in enumerate(ds.used_feature_map)}
        ds.max_bin_global = max((m.num_bin for m in ds.mappers), default=1)
        host = cls._unpack_nibble_columns(d["bins"],
                                          d.get("packed_cols", []))
        ds.bins_t = torch.from_numpy(np.ascontiguousarray(
            host.T.astype(np.uint8 if ds.max_bin_global <= 256
                          else np.int32, copy=False))).to(ds.device)
        ds.metadata = Metadata(d["label"], d["weights"], d["init_score"])
        ds.metadata.query_boundaries = d["query_boundaries"]
        ds.feature_names = list(d["feature_names"])
        return ds
