"""Distributed data loading: each rank's rows, with bin boundaries every
rank agrees on.

The JAX package's ``io/distributed.py`` (reference:
src/io/dataset_loader.cpp:163-167, round-robin or pre-partitioned row
assignment; :434-466, distributed bin finding: each machine finds the
bins of the columns it owns from its own rows, and the serialized
mappers ride an Allgather). The exchange is ``all_gather_object`` over
the process group (parallel/cluster.py ``gather_object``), where the
JAX package gathers pickled bytes through its coordination service.

``shard_bin_mappers`` is the pure agreement rule: feature j takes rank
``j % S``'s mapper. ``DistributedLoader`` loads one rank's rows; with
``world=`` and ``rank=`` given it emulates S ranks in one process (the
other ranks' rows in hand, or taken from the shared matrix), so that
tests hold every rank's mappers to each other without a process group.
``construct_multihost`` builds a rank's set of a row-sharded learner:
every rank's metadata, its own contiguous block binned onto its device
(io/ingest.py ``bin_matrix_multihost``); ``allgather_row_slices``
assembles a global vector (labels) from each rank's slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..parallel import cluster
from ..utils import log
from .binning import BinMapper, BinType
from .dataset import BinnedDataset, Metadata


def find_shard_mappers(X: np.ndarray, config, categorical: Sequence[int] = (),
                       total_rows: Optional[int] = None,
                       columns: Optional[Sequence[int]] = None
                       ) -> List[Optional[BinMapper]]:
    """One rank's mappers from its rows ``X`` (the JAX package's
    ``find_column_mappers`` with its shard arguments, io/dataset.py:75):
    ``total_rows`` is the global row count, which scales this rank's
    share of the sample budget and the min_data filter (every rank must
    pass the same); ``columns`` restricts the search to the rank's owned
    columns, the others coming back as None."""
    X = np.asarray(X)
    n, nf = X.shape
    cfg = config
    total = n if total_rows is None else max(int(total_rows), 1)
    budget = cfg.bin_construct_sample_cnt
    if total > n > 0:
        budget = max(budget * n // total, 1)        # this rank's share
    sample_cnt = min(budget, n)
    if sample_cnt < n:
        rng = np.random.default_rng(cfg.data_random_seed)
        sample = X[np.sort(rng.choice(n, sample_cnt, replace=False))]
    else:
        sample = X
    snum = sample.shape[0]
    filter_cnt = 0
    if cfg.min_data_in_leaf > 0 and total > 0:
        filter_cnt = max(int(cfg.min_data_in_leaf * snum / total), 1)
    cats = set(categorical)
    wanted = set(range(nf)) if columns is None else set(columns)
    mappers: List[Optional[BinMapper]] = []
    for j in range(nf):
        if j not in wanted:
            mappers.append(None)
            continue
        col = sample[:, j].astype(np.float64)
        nonzero = col[(np.abs(col) > 1e-35) | np.isnan(col)]
        m = BinMapper()
        m.find_bin(nonzero, snum, cfg.max_bin, cfg.min_data_in_bin,
                   filter_cnt,
                   BinType.CATEGORICAL if j in cats else BinType.NUMERICAL,
                   cfg.use_missing, cfg.zero_as_missing)
        mappers.append(m)
    return mappers


def local_bin_mappers(X: np.ndarray, config, categorical: Sequence[int] = (),
                      total_rows: Optional[int] = None,
                      columns: Optional[Sequence[int]] = None
                      ) -> List[Optional[BinMapper]]:
    """One rank's mappers (trivial ones included); ``total_rows`` the
    global row count."""
    return find_shard_mappers(X, config, categorical, total_rows, columns)


def shard_bin_mappers(per_shard_mappers: List[List[BinMapper]]
                      ) -> List[BinMapper]:
    """The agreement rule: feature j takes rank ``j % S``'s mapper, so
    every rank applying it to the same gathered lists ends with the same
    mappers."""
    S = len(per_shard_mappers)
    nf = len(per_shard_mappers[0])
    for ms in per_shard_mappers:
        if len(ms) != nf:
            log.fatal("Shards disagree on column count during distributed "
                      "bin finding")
    return [per_shard_mappers[j % S][j] for j in range(nf)]


def _allgather_rowcount(n_local: int) -> int:
    """Every rank's row count, summed."""
    return int(sum(cluster.row_counts(n_local)))


def _allgather_mappers(local: List[Optional[BinMapper]]
                       ) -> List[List[Optional[BinMapper]]]:
    """Every rank's mappers (serialized as dicts on the wire)."""
    blobs = cluster.gather_object(
        [None if m is None else m.to_dict() for m in local])
    return [[None if d is None else BinMapper.from_dict(d) for d in blob]
            for blob in blobs]


def _rank_queries(nq: int, rank: int, world: int,
                  mode: str = "round_robin") -> np.ndarray:
    """The queries (or rows) rank ``rank`` owns: ``i % world == rank``
    (the reference's default), or ``contiguous`` blocks of
    ceil(nq / world) that keep the original order."""
    if mode == "contiguous":
        b = -(-nq // world) if world else nq
        return np.arange(min(rank * b, nq), min((rank + 1) * b, nq))
    return np.arange(rank, nq, world)


def _rank_rows(n: int, rank: int, world: int,
               query_boundaries: Optional[np.ndarray],
               mode: str = "round_robin") -> np.ndarray:
    """Rank ``rank``'s rows (dataset_loader.cpp:163-167); with query
    boundaries whole queries, so no query is split across ranks."""
    if query_boundaries is None:
        return _rank_queries(n, rank, world, mode)
    nq = len(query_boundaries) - 1
    qs = _rank_queries(nq, rank, world, mode)
    return np.concatenate([
        np.arange(query_boundaries[q], query_boundaries[q + 1])
        for q in qs]) if len(qs) else np.zeros(0, np.int64)


def _slice_metadata(meta: Metadata, sel: np.ndarray, n: int, rank: int,
                    world: int, mode: str = "round_robin") -> Metadata:
    """Every metadata field of the rows ``sel``: init scores per class
    ([K * N] class-major), the query sizes of the whole queries kept."""
    isc = meta.init_score
    if isc is not None:
        k = max(1, len(isc) // max(n, 1))
        isc = np.asarray(isc).reshape(k, n)[:, sel].reshape(-1)
    group = None
    if meta.query_boundaries is not None:
        qb = meta.query_boundaries
        group = np.diff(qb)[_rank_queries(len(qb) - 1, rank, world, mode)]
    return Metadata(
        label=None if meta.label is None else meta.label[sel],
        weight=None if meta.weights is None else meta.weights[sel],
        group=group, init_score=isc)


class DistributedLoader:
    """One rank's set with agreed bins. ``world``/``rank`` default to
    the process group's; given explicitly they emulate that many ranks
    in one process. ``device``: where the set's bins go (None: cuda:0)."""

    def __init__(self, config, world: Optional[int] = None,
                 rank: Optional[int] = None, device=None):
        self.config = config
        self.world = cluster.world() if world is None else int(world)
        self.rank = cluster.rank() if rank is None else int(rank)
        self.device = device

    def _owned(self, rank: int, nf: int) -> List[int]:
        """The columns whose bins rank ``rank`` finds (``j % S``)."""
        return list(range(rank, nf, self.world))

    def _emulated(self) -> bool:
        return cluster.world() == 1 and self.world > 1

    def _load_shard(self, X: np.ndarray, meta: Metadata,
                    categorical: Sequence[int], pre_partitioned: bool,
                    shard_matrices: Optional[List[np.ndarray]],
                    names: Optional[List[str]] = None,
                    mode: str = "round_robin") -> BinnedDataset:
        """``X``/``meta``: every row (a shared file) or this rank's
        (pre-partitioned). ``shard_matrices``: every rank's rows for an
        emulated agreement; None gathers the mappers over the group."""
        X = np.asarray(X)
        nf = X.shape[1]
        if not pre_partitioned and self.world > 1:
            sel = _rank_rows(X.shape[0], self.rank, self.world,
                             meta.query_boundaries, mode)
            Xl = X[sel]
            ml = _slice_metadata(meta, sel, X.shape[0], self.rank,
                                 self.world, mode)
            total = X.shape[0]
            if shard_matrices is None and self._emulated():
                # one process, the shared rows in hand: every rank's
                # slice, so the agreement is exact
                shard_matrices = [
                    X[_rank_rows(X.shape[0], r, self.world,
                                 meta.query_boundaries, mode)]
                    for r in range(self.world)]
        else:
            Xl, ml = X, meta
            total = (sum(s.shape[0] for s in shard_matrices)
                     if shard_matrices is not None
                     else _allgather_rowcount(Xl.shape[0]))
            if shard_matrices is None and self._emulated():
                total = Xl.shape[0] * self.world    # the best local guess
        if shard_matrices is not None:
            per_shard = [find_shard_mappers(s, self.config, categorical,
                                            total, self._owned(r, nf))
                         for r, s in enumerate(shard_matrices)]
        else:
            per_shard = _allgather_mappers(find_shard_mappers(
                Xl, self.config, categorical, total,
                self._owned(self.rank, nf)))
            if len(per_shard) == 1 and self.world > 1:
                log.warning("distributed load in one process with no peer "
                            "data in hand: using this rank's local bins; "
                            "pass all_shards=/peer_files= for an emulated "
                            "agreement")
                local = find_shard_mappers(Xl, self.config, categorical,
                                           total)
                per_shard = [local] * self.world
        ds = BinnedDataset(self.config, self.device)
        ds.construct_from_matrix(Xl, ml, feature_names=names,
                                 categorical=categorical,
                                 mappers=shard_bin_mappers(per_shard))
        return ds

    def load_rank_matrix(self, X: np.ndarray, metadata: Metadata,
                         categorical: Sequence[int] = (),
                         pre_partitioned: bool = False,
                         all_shards: Optional[List[np.ndarray]] = None,
                         contiguous: bool = False) -> BinnedDataset:
        """This rank's set from an in-memory matrix: ``X`` holds only
        this rank's rows when ``pre_partitioned``, else every row, of
        which it keeps its round-robin (or ``contiguous``) share.
        ``all_shards``: every rank's rows, for an emulated agreement."""
        return self._load_shard(X, metadata, categorical, pre_partitioned,
                                all_shards,
                                mode="contiguous" if contiguous
                                else "round_robin")

    def load_rank_file(self, filename: str,
                       pre_partitioned: Optional[bool] = None,
                       peer_files: Optional[List[str]] = None
                       ) -> BinnedDataset:
        """The text-file variant (``pre_partition`` from the config):
        ``filename`` holds this rank's rows, or every rank parses the
        shared file and keeps its share. ``peer_files``: every rank's
        file, for an emulated agreement."""
        from .loader import DatasetLoader
        cfg = self.config
        if pre_partitioned is None:
            pre_partitioned = cfg.pre_partition
        ldr = DatasetLoader(cfg, self.device)
        X, meta, names, categorical = ldr._parse_with_metadata(filename)
        shard_matrices = None
        if peer_files is not None:
            shard_matrices = [ldr._parse_with_metadata(pf)[0]
                              for pf in peer_files]
        ds = self._load_shard(X, meta, categorical, pre_partitioned,
                              shard_matrices, names or None)
        log.info("Distributed load rank %d/%d: %d local rows", self.rank,
                 self.world, ds.num_data)
        return ds

    def construct_multihost(self, X_local: np.ndarray,
                            meta_global: Metadata, *, n_global: int,
                            row_start: int,
                            categorical: Sequence[int] = (),
                            feature_names: Optional[List[str]] = None,
                            mappers: Optional[List[BinMapper]] = None
                            ) -> BinnedDataset:
        """A row-sharded learner's set on this rank: ``X_local`` holds
        the global rows [row_start, row_start + len(X_local)), which must
        cover the rank's block (io/ingest.py ``host_row_block``); the
        bins are agreed over the group (each rank's owned columns from
        its own rows) unless ``mappers`` are given; the set is global in
        shape (``num_data`` = ``n_global``, ``meta_global`` every row's)
        and its device bins hold only the rank's block (``row_block``)."""
        from . import ingest
        X_local = np.asarray(X_local)
        if X_local.dtype not in (np.float32, np.float64):
            X_local = X_local.astype(np.float64)
        nf = X_local.shape[1]
        total = int(n_global)
        if mappers is None:
            per_shard = _allgather_mappers(find_shard_mappers(
                X_local, self.config, categorical, total,
                self._owned(self.rank, nf)))
            if len(per_shard) != self.world:
                log.fatal(f"multihost bin agreement saw {len(per_shard)} "
                          f"ranks, expected {self.world}: every rank must "
                          f"construct the set together")
            mappers = shard_bin_mappers(per_shard)
        lo, hi, _ = ingest.host_row_block(total, self.world, self.rank)
        ds = BinnedDataset(self.config, self.device)
        ds.num_data = total
        ds.num_total_features = nf
        ds.metadata = meta_global
        meta_global.check(total)
        ds.feature_names = (list(feature_names) if feature_names
                            else [f"Column_{i}" for i in range(nf)])
        ds.set_mappers(mappers)
        ds.row_block = (lo, hi)
        binner = ingest.DeviceBinner(ds.mappers, ds.used_feature_map,
                                     self.config, X_local.dtype, ds.device)
        ds.bins_t = ingest.bin_matrix_multihost(binner, X_local, row_start,
                                                lo, hi)
        log.info("multihost load rank %d/%d: %d global rows, this rank's "
                 "block [%d, %d)", self.rank, self.world, total, lo, hi)
        return ds


def allgather_row_slices(values: Optional[np.ndarray], row_start: int,
                         n_global: int) -> Optional[np.ndarray]:
    """A global row vector (labels, weights) from every rank's
    contiguous slice, in float64; None passes through (every rank must
    agree that it is None)."""
    if not cluster.is_multiprocess():
        return values
    parts = cluster.gather_object(
        None if values is None else
        (int(row_start), np.asarray(values, np.float64).reshape(-1)))
    have = [p is not None for p in parts]
    if not any(have):
        return None
    if not all(have):
        log.fatal("allgather_row_slices: some ranks passed None and others "
                  "data; a metadata field must be present on every rank")
    out = np.zeros(int(n_global), np.float64)
    seen = np.zeros(int(n_global), bool)
    for lo, vals in parts:
        out[lo:lo + vals.size] = vals
        seen[lo:lo + vals.size] = True
    if not seen.all():
        log.fatal(f"allgather_row_slices: the slices leave "
                  f"{int((~seen).sum())} of {n_global} rows uncovered")
    return out
