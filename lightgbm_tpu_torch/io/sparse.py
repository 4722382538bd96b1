"""CSR-native sparse input: an O(nnz) representation, sampling and
binning.

The JAX package's ``io/sparse.py`` (:54-408), copied: host code, so it
stays numpy. A CTR or one-hot matrix at 1% density costs 800x its nnz
as the dense float64 ``[N, F]`` matrix, so sparse input stays in CSR on
the host end to end:

- ``SparseMatrix``: values, column indices and row offsets, what
  ``capi.LGBM_DatasetCreateFromCSR/CSC`` and ``basic.py``'s scipy
  detection hand to ``BinnedDataset``;
- ``find_column_mappers_sparse``: bin mappers sampled straight from CSR,
  with the same rng draw, sample budget and ``min_data_in_leaf`` filter
  as the dense ``find_column_mappers`` and the same implied zeros, so
  the mappers are the densified path's, bit for bit;
- ``bin_entries`` / ``host_bins_from_sparse``: O(nnz) host binning of
  the explicit entries (implicit cells take ``zero_bins``, the bin of
  0.0). The port bins on the device (io/dataset.py); these are the
  oracle its bins are held to, and they bin the EFB probe's sample;
- the route decision (``route_sparse``), the coordinates' gate for the
  sparse histogram tier (``want_coords``, ops/hist_wave.py
  ``wave_histogram_sparse``), chunked prediction's row count and the
  densify cliff warning (``warn_dense_cliff``), which fires only on the
  explicit dense fallbacks.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import log
from .binning import BinMapper, BinType

# the old capi densify warning threshold: a dense float64 [N, F] above
# this many GiB is the memory cliff the sparse route exists to avoid
DENSE_CLIFF_GIB = 4.0

# chunked sparse predict (bounded densify: the predict kernels are
# row-independent, so chunking is bit-exact): a row cap AND a dense
# float64 byte budget — a 131k-column hashed-CTR matrix must not
# densify gigabytes per chunk just because its row count is small
PREDICT_CHUNK_ROWS = 65536
PREDICT_CHUNK_BYTES = 256 << 20


def predict_chunk_rows(num_cols: int) -> int:
    """Rows per chunked-predict densify block: min(row cap, rows that
    keep one dense float64 block under PREDICT_CHUNK_BYTES)."""
    return max(1, min(PREDICT_CHUNK_ROWS,
                      PREDICT_CHUNK_BYTES // (8 * max(num_cols, 1))))


def warn_dense_cliff(num_row: int, num_col: int, nnz: int,
                     what: str = "densifying") -> None:
    """The >4 GiB densify cliff warning, shared by every dense
    fallback (``capi.LGBM_DatasetPushRowsByCSR``, ``SparseMatrix.to_dense``
    and the above-threshold route in io/dataset.py)."""
    dense_gb = num_row * num_col * 8 / 2 ** 30
    if dense_gb > DENSE_CLIFF_GIB:
        log.warning(
            "%s %dx%d sparse input to %.1f GiB (nnz=%d, density "
            "%.4f): consider is_enable_sparse=true with a lower "
            "sparse_threshold (CSR-native route), enable_bundle=true "
            "(EFB) or fewer columns",
            what, num_row, num_col, dense_gb, nnz,
            nnz / max(num_row * num_col, 1))


class SparseMatrix:
    """Row-compressed (CSR) float64 matrix: ``data``/``cols`` per
    explicit entry, ``indptr`` row offsets, ``shape`` = (N, F).

    Entries are canonical: at most one per (row, col), rows in
    ascending order (columns within a row need not be sorted). Values
    are float64 — the dtype every dense ingest path normalizes to."""

    __slots__ = ("data", "cols", "indptr", "shape")

    def __init__(self, data: np.ndarray, cols: np.ndarray,
                 indptr: np.ndarray, shape: Tuple[int, int]):
        self.data = np.asarray(data, np.float64).reshape(-1)
        self.cols = np.asarray(cols, np.int64).reshape(-1)
        self.indptr = np.asarray(indptr, np.int64).reshape(-1)
        self.shape = (int(shape[0]), int(shape[1]))
        if len(self.indptr) != self.shape[0] + 1:
            raise ValueError(
                f"indptr has {len(self.indptr)} entries for "
                f"{self.shape[0]} rows")
        if self.indptr[-1] != len(self.data):
            raise ValueError("indptr[-1] != nnz")

    # -- construction --------------------------------------------------------

    @classmethod
    def from_csr(cls, indptr, indices, data, num_col: int
                 ) -> "SparseMatrix":
        """From raw CSR planes (the c_api CSR argument shape). A
        duplicate (row, col) keeps the LAST occurrence — the same
        last-write-wins the old ``_csr_to_dense`` assignment had."""
        indptr = np.asarray(indptr, np.int64).reshape(-1)
        cols = np.asarray(indices, np.int64).reshape(-1)
        data = np.asarray(data, np.float64).reshape(-1)
        n = len(indptr) - 1
        nnz = int(indptr[-1])
        cols, data = cols[:nnz], data[:nnz]
        sm = cls(data, cols, indptr, (n, int(num_col)))
        return sm._dedupe_last_wins()

    @classmethod
    def from_csc(cls, col_ptr, indices, data, num_row: int,
                 num_col: int) -> "SparseMatrix":
        """From raw CSC planes — O(nnz log nnz) transposition to CSR
        (a stable counting order would do, but the sort is simpler and
        nnz is small by definition on this route)."""
        col_ptr = np.asarray(col_ptr, np.int64).reshape(-1)
        rows = np.asarray(indices, np.int64).reshape(-1)
        data = np.asarray(data, np.float64).reshape(-1)
        nnz = int(col_ptr[-1])
        rows, data = rows[:nnz], data[:nnz]
        cols = np.repeat(np.arange(int(num_col), dtype=np.int64),
                         np.diff(col_ptr))
        order = np.argsort(rows, kind="stable")
        rows, cols, data = rows[order], cols[order], data[order]
        indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(rows, minlength=int(num_row)))])
        sm = cls(data, cols, indptr.astype(np.int64),
                 (int(num_row), int(num_col)))
        return sm._dedupe_last_wins()

    @classmethod
    def from_scipy(cls, m) -> "SparseMatrix":
        """From any scipy.sparse matrix (CSC/COO/... -> CSR)."""
        csr = m.tocsr()
        if not getattr(csr, "has_canonical_format", True):
            csr = csr.copy()            # never mutate the caller's
            csr.sum_duplicates()        # scipy-canonical: sums dups
        return cls(np.asarray(csr.data, np.float64),
                   np.asarray(csr.indices, np.int64),
                   np.asarray(csr.indptr, np.int64),
                   (int(csr.shape[0]), int(csr.shape[1])))

    def _dedupe_last_wins(self) -> "SparseMatrix":
        """Drop duplicate (row, col) entries keeping the LAST (matching
        the dense-assignment semantics of the old densify route); no-op
        (no copy) when entries are already unique."""
        key = self.rows() * self.shape[1] + self.cols
        uniq = np.unique(key)
        if len(uniq) == len(key):
            return self
        # last occurrence wins: reverse, keep first-of-reversed
        rev = key[::-1]
        _, first_rev = np.unique(rev, return_index=True)
        keep = np.sort(len(key) - 1 - first_rev)
        rows = self.rows()[keep]
        indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(rows,
                                        minlength=self.shape[0]))])
        return SparseMatrix(self.data[keep], self.cols[keep],
                            indptr.astype(np.int64), self.shape)

    # -- views ---------------------------------------------------------------

    @property
    def nnz(self) -> int:
        return int(len(self.data))

    @property
    def density(self) -> float:
        n, f = self.shape
        return self.nnz / max(n * f, 1)

    def rows(self) -> np.ndarray:
        """Per-entry row index [nnz] (expanded from indptr)."""
        return np.repeat(np.arange(self.shape[0], dtype=np.int64),
                         np.diff(self.indptr))

    def row_slice(self, r0: int, r1: int) -> "SparseMatrix":
        """Rows [r0, r1) as a CSR view over the same entry arrays."""
        e0, e1 = int(self.indptr[r0]), int(self.indptr[r1])
        return SparseMatrix(self.data[e0:e1], self.cols[e0:e1],
                            self.indptr[r0:r1 + 1] - e0,
                            (r1 - r0, self.shape[1]))

    def take_rows(self, idx) -> "SparseMatrix":
        """Row subset (fancy indexing) in O(nnz taken) — vectorized
        ragged-slice gather (a python loop over a 200k-row mapper
        sample would dominate construction)."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        counts = np.diff(self.indptr)[idx]
        starts = self.indptr[idx]
        indptr = np.concatenate([[0], np.cumsum(counts)])
        total = int(indptr[-1])
        if total:
            take = (np.repeat(starts - indptr[:-1], counts)
                    + np.arange(total, dtype=np.int64))
        else:
            take = np.zeros(0, np.int64)
        return SparseMatrix(self.data[take], self.cols[take],
                            indptr.astype(np.int64),
                            (len(idx), self.shape[1]))

    def __getitem__(self, idx) -> "SparseMatrix":
        return self.take_rows(idx)

    def to_dense(self, warn: bool = False) -> np.ndarray:
        """Materialize the dense [N, F] float64 matrix (the explicit
        dense fallback; ``warn`` adds the cliff warning)."""
        n, f = self.shape
        if warn:
            warn_dense_cliff(n, f, self.nnz)
        X = np.zeros((n, f), np.float64)
        X[self.rows(), self.cols] = self.data
        return X

    def to_dense_rows(self, r0: int, r1: int) -> np.ndarray:
        """Dense float64 block of rows [r0, r1) — bounded densify for
        chunked prediction."""
        return self.row_slice(r0, r1).to_dense()


# ---------------------------------------------------------------------------
# Route decision
# ---------------------------------------------------------------------------

def route_sparse(config, sm: SparseMatrix) -> bool:
    """True when sparse input should stay CSR-native: the reference's
    ``is_enable_sparse`` gate plus its ``sparse_threshold`` rule lifted
    from per-feature to the whole matrix — the implicit/default
    fraction (1 - density) must reach the threshold, else the matrix is
    dense-ish and the densified path is the faster layout."""
    if not getattr(config, "is_enable_sparse", True):
        return False
    return (1.0 - sm.density) >= float(
        getattr(config, "sparse_threshold", 0.8))


def want_coords(config, density: float) -> bool:
    """Whether dataset construction should retain the zero-suppressed
    (code, feature, row) coordinates for the sparse histogram tier —
    the tier's own gate (ops/autotune.py ``tune_hist_tier``) decides
    per booster, but coordinates must be captured at ingest time.
    Mirrors the tier rule so a dataset the auto rule is guaranteed to
    reject never pins dead coordinate planes in device memory:
    tpu_sparse=1 forces, -1 auto needs quantized histograms (where the
    tier is bit-exact) AND density under the tier's ceiling (the
    backend-independent one, as in the JAX package)."""
    t = int(getattr(config, "tpu_sparse", -1))
    if t == 0:
        return False
    if t >= 1:
        return True
    if not getattr(config, "tpu_quantized_hist", False):
        return False
    from ..ops.autotune import SPARSE_TIER_MAX_DENSITY
    return float(density) <= SPARSE_TIER_MAX_DENSITY


# ---------------------------------------------------------------------------
# Delta-encoded coordinate transport (config.tpu_psum_wire)
# ---------------------------------------------------------------------------

def delta_pack_plane(arr) -> Optional[Tuple[int, np.ndarray]]:
    """Pack an int coordinate plane for the host->device wire as
    ``(base, int16 deltas)`` — half the transfer bytes of the int32
    plane. The planes are feature-grouped and row-sorted within each
    feature (``_entries_by_column``), so adjacent deltas are tiny for
    the row/feat planes and bin-bounded (|d| <= max_bin) for the code
    plane; reconstruction is ``base + cumsum(deltas)`` in int32 on
    device — exact integer arithmetic, so the rebuilt plane is
    BIT-identical to the direct upload. Returns None (the refusal
    path) when any adjacent delta falls outside int16 — the caller
    then uploads the plane directly."""
    a = np.asarray(arr, np.int64).ravel()
    if a.size < 2:
        return None
    d = np.diff(a)
    if d.max(initial=0) > 32767 or d.min(initial=0) < -32768:
        return None
    out = np.zeros(a.size, np.int16)
    out[1:] = d.astype(np.int16)
    return int(a[0]), out


# ---------------------------------------------------------------------------
# Bin-mapper construction from CSR
# ---------------------------------------------------------------------------

def _entries_by_column(sm: SparseMatrix, nf: int):
    """(cols_sorted, vals_sorted, starts, ends): explicit entries
    grouped per column (stable by row within each column)."""
    order = np.argsort(sm.cols, kind="stable")
    cols = sm.cols[order]
    bounds = np.searchsorted(cols, np.arange(nf + 1))
    return cols, sm.data[order], order, bounds


def find_column_mappers_sparse(sm: SparseMatrix, config,
                               categorical: Sequence[int] = (),
                               total_rows: Optional[int] = None
                               ) -> List[BinMapper]:
    """``find_column_mappers`` (io/dataset.py) sampling from CSR.

    Bit-identical mappers to the densified path: the SAME
    ``rng(data_random_seed)`` row draw, the same per-column nonzero
    filter (|v| > 1e-35 or NaN — explicit zeros are implied zeros,
    exactly as the dense column scan treats them), and the same
    ``total_sample_cnt`` denominator, so ``BinMapper.find_bin`` sees
    the identical (values, implied-zero count) inputs. ``find_bin``
    sorts its values, so per-column multiset equality suffices."""
    n, nf = sm.shape
    cfg = config
    total = n if total_rows is None else max(int(total_rows), 1)
    budget = cfg.bin_construct_sample_cnt
    if total > n > 0:
        budget = max(budget * n // total, 1)
    sample_cnt = min(budget, n)
    rng = np.random.default_rng(cfg.data_random_seed)
    if sample_cnt < n:
        idx = np.sort(rng.choice(n, sample_cnt, replace=False))
        sample = sm.take_rows(idx)
    else:
        sample = sm
    snum = sample.shape[0]
    filter_cnt = 0
    if cfg.min_data_in_leaf > 0 and total > 0:
        filter_cnt = max(int(cfg.min_data_in_leaf * snum / total), 1)
    cats = set(categorical)
    _, vals, _, bounds = _entries_by_column(sample, nf)
    keep = (np.abs(vals) > 1e-35) | np.isnan(vals)
    mappers: List[BinMapper] = []
    for j in range(nf):
        sl = slice(bounds[j], bounds[j + 1])
        nonzero = vals[sl][keep[sl]]
        m = BinMapper()
        bt = (BinType.CATEGORICAL if j in cats else BinType.NUMERICAL)
        m.find_bin(nonzero, snum, cfg.max_bin, cfg.min_data_in_bin,
                   filter_cnt, bt, cfg.use_missing, cfg.zero_as_missing)
        mappers.append(m)
    return mappers


# ---------------------------------------------------------------------------
# O(nnz) host binning
# ---------------------------------------------------------------------------

def zero_bins(mappers: Sequence[BinMapper]) -> np.ndarray:
    """Per-feature bin of the implicit value 0.0 (int32 [F]): the
    numerical default bin, or whatever bin category 0 maps to for
    categoricals (``num_bin - 1`` when 0 is not a kept category) —
    NOT ``BinMapper.default_bin``, which is pinned to 0 for
    categorical mappers."""
    return np.asarray([np.asarray(m.value_to_bin(0.0)).reshape(-1)[0]
                       for m in mappers], np.int32)


def bin_entries(sm: SparseMatrix, mappers: Sequence[BinMapper],
                used_feature_map: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bin the explicit entries of the USED (non-trivial) features.

    Returns (codes int32, feat int32 INNER feature index, rows int32)
    — the zero-suppressed coordinate planes. Entries of trivial
    (dropped) columns are discarded; entries binning INTO the zero bin
    are kept (they are redundant with the implicit background but
    harmless, and dropping them would cost a second pass)."""
    n, nf = sm.shape
    real_to_inner = np.full(nf, -1, np.int64)
    used = np.asarray(used_feature_map, np.int64)
    real_to_inner[used] = np.arange(len(used))
    cols, vals, order, bounds = _entries_by_column(sm, nf)
    rows_all = sm.rows()[order]
    codes = np.empty(len(vals), np.int32)
    keep = np.zeros(len(vals), bool)
    for real in used:
        sl = slice(bounds[real], bounds[real + 1])
        if sl.start == sl.stop:
            continue
        inner = int(real_to_inner[real])
        codes[sl] = mappers[inner].value_to_bin(vals[sl])
        keep[sl] = True
    feat = real_to_inner[cols[keep]].astype(np.int32)
    return codes[keep], feat, rows_all[keep].astype(np.int32)


def host_bins_from_sparse(sm: SparseMatrix, mappers,
                          used_feature_map, dtype) -> np.ndarray:
    """The [N, F_used] host bin matrix from CSR: implicit cells take
    ``zero_bins``, explicit entries ``value_to_bin`` — cell-for-cell
    equal to the dense route's bins of the densified matrix (the JAX
    package's tests/test_sparse.py proves it over the NaN,
    ±kZeroThreshold and categorical edge cases). The result is the
    bin-storage tier's uint8/uint16/int32."""
    n = sm.shape[0]
    f = len(mappers)
    if f == 0:
        return np.zeros((n, 1), dtype)
    bins = np.empty((n, f), dtype)
    bins[:] = zero_bins(mappers).astype(dtype)[None, :]
    codes, feat, rows = bin_entries(sm, mappers, used_feature_map)
    bins[rows, feat] = codes.astype(dtype)
    return bins
