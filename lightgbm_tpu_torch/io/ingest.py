"""Streamed device ingest: the value->bin map on the card, fed by a
double-buffered host->device chunk pipeline.

The JAX package's ``io/ingest.py``, its single-device half, in the
port's idiom (the reference's streamed two-round ingest,
DatasetLoader::ConstructFromSampleData, src/io/dataset_loader.cpp:499:
bin boundaries from a bounded row sample, then a streaming pass that
bins rows as they arrive):

- bin boundaries still come from the bounded row sample
  (io/dataset.py ``find_column_mappers``);
- the rows stream in chunks of ~64 MB (``auto_chunk_rows``). One
  prefetch worker (``prefetch``) selects chunk k+1's used columns on the
  host into a pinned staging buffer while chunk k is on its way: the
  main thread copies it with ``non_blocking=True`` on a side stream into
  a device staging buffer, and the binning stream waits for the copy's
  event. Two staging buffers each side, fenced by CUDA events, make the
  double buffer;
- each chunk is binned on the device in float64, as the one-copy route
  bins (``searchsorted`` over each feature's ``bin_upper_bound``, the
  categorical lookup ``category_bins``), and written in place into the
  ``[F, N]`` matrix the wave grower reads. No copy of the raw matrix is
  ever made on the card, only the two staging chunks.

What the JAX module needs and the port does not: its sortable-integer
key planes (``_keys64_host``, ``_key32_host``, ``_floor32``). JAX runs
with x64 off and cannot compare against float64 bounds on the device,
so it compares integer keys; torch compares float64 on the card, so the
values themselves go over the wire and bits equal the one-copy route's
by construction. For the same reason no chunk is padded: a torch binner
has no compiled chunk shape to fill.

Left out: the JAX package's device-resident chunk ring (``ChunkRing``,
``tpu_lrb_ring``). It exists so that the JAX binner's fixed compiled
chunk shape does not send its pad rows again window after window; a
torch binner has no such shape and sends live rows only, so a ring
saves no bytes on the wire. A port of it, measured on an H100 at the
LRB loop's windows, moved the same bytes with it and without and made
no allocation retry either way, while it kept its slots resident for
the loop's lifetime (PERF.md, the ingest rows). ``tpu_lrb_ring`` is
accepted and does nothing.

``SparseDeviceBinner`` bins a CSR matrix's explicit entries chunk by
chunk of rows into the feature-grouped entries (``SparseEntries``) the
sparse route builds, a chunk's entries placed at their final positions
on the card. It runs only where ``tpu_ingest=1`` asks for it
(``sparse_ingest_enabled``); the default stays the one upload of
``SparseEntries.upload`` until a reading on the card shows the streamed
route helps (chip_smoke.py phase 26 (c) reads both).

The sharded half (the JAX package's :116-160, :755-912, :1241-1340) for
the row-sharded learners (parallel/learners.py), where each rank is a
process with one device: ``shard_width`` and ``host_row_block`` are the
JAX package's geometry (rank r owns the contiguous global rows [r*S,
(r+1)*S), S aligned to a power-of-two row unit); ``bin_matrix_sharded``
bins only a rank's block of a host matrix onto its device,
``bin_matrix_multihost`` the block out of a host array that holds only
some of the rows (a rank's own file), and ``ShardedIngestStream``
(``start_sharded_stream``) takes every row of a file in order and bins
only the rank's block, the two-round loader's sharded stream. The bins
of a block equal the same columns of ``bin_matrix``'s (the same chunk
binner over the same rows).
"""
from __future__ import annotations

import collections
import concurrent.futures
from typing import List, Sequence

import numpy as np
import torch

from ..obs import registry as obs
from ..obs import trace
from ..utils import faults, log, retry, timing
from .binning import BinMapper, BinType, MissingType

_TARGET_CHUNK_BYTES = 64 << 20      # ~64 MB of raw values per chunk
_MIN_CHUNK_ROWS = 1 << 14
_MAX_CHUNK_ROWS = 1 << 21
_SPARSE_ENTRY_BYTES = 12            # a f64 value and an int32 column


class IngestUnsupported(Exception):
    """Raised where the streamed route cannot reproduce the one-copy
    route's bins (callers take the one-copy route)."""


def ingest_enabled(config, device) -> bool:
    """``tpu_ingest``: 1 streams on any device (the CPU tests), 0 never,
    -1 (default) when the dataset's device is a CUDA card."""
    t = int(getattr(config, "tpu_ingest", -1))
    if t == 0:
        return False
    if t >= 1:
        return True
    return torch.device(device).type == "cuda"


def sparse_ingest_enabled(config) -> bool:
    """The streamed sparse route (``SparseDeviceBinner``) only where
    ``tpu_ingest=1`` forces it: -1 keeps the one upload on a card too."""
    return int(getattr(config, "tpu_ingest", -1)) >= 1


def mappers_supported(mappers: Sequence[BinMapper]) -> bool:
    """The JAX package's gate, kept so both packages stream the same
    sets: categorical tables within int32."""
    for m in mappers:
        if m.bin_type == BinType.CATEGORICAL:
            if any(abs(int(c)) >= 2 ** 31 for c in m.bin_2_categorical):
                return False
    return True


def auto_chunk_rows(config, n_features: int, itemsize: int) -> int:
    """Rows per pipeline chunk: the ``tpu_ingest_chunk_rows`` knob, or
    a power of two sized so one chunk's raw values are ~64 MB."""
    knob = int(getattr(config, "tpu_ingest_chunk_rows", 0) or 0)
    if knob > 0:
        return knob
    per_row = max(n_features * itemsize, 1)
    c = max(_TARGET_CHUNK_BYTES // per_row, 1)
    c = 1 << int(np.floor(np.log2(c)))
    return int(min(max(c, _MIN_CHUNK_ROWS), _MAX_CHUNK_ROWS))


class PrefetchError(RuntimeError):
    """A prefetch thunk failed after retries; the message names the
    chunk. The original failure rides ``__cause__``."""


def prefetch(thunks, depth: int = 2, what: str = "chunk", policy=None):
    """Evaluate an iterator of zero-argument callables on ONE worker
    thread with a bounded lookahead, yielding results in order: the host
    half of the double buffer. Thunk k + ``depth`` is submitted once the
    consumer has finished with result k, so with two staging buffers
    and ``depth`` 2 the worker writes a buffer only after the consumer
    has issued the copy out of it, while the other buffer's chunk is
    prepared in parallel.

    Each thunk runs under the retry policy (utils/retry.py). A
    persistent failure raises ``PrefetchError`` naming the chunk's
    index, the queued lookahead is cancelled and the worker shuts
    down."""
    it = iter(thunks)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ingest-prefetch") as ex:
        q: collections.deque = collections.deque()  # (index, future)
        submitted = 0

        def submit() -> bool:
            nonlocal submitted
            try:
                thunk = next(it)
            except StopIteration:
                return False
            idx = submitted
            submitted += 1
            q.append((idx, ex.submit(retry.call, thunk,
                                     what=f"{what} {idx}", policy=policy)))
            return True

        try:
            for _ in range(max(depth, 1)):
                if not submit():
                    break
            while q:
                idx, fut = q.popleft()
                try:
                    res = fut.result()
                except Exception as e:  # noqa: BLE001 — annotate + stop
                    raise PrefetchError(
                        f"{what} {idx} failed after retries "
                        f"({type(e).__name__}: {e}); pipeline "
                        f"cancelled") from e
                yield res
                submit()
        finally:
            for _, f in q:
                f.cancel()


# -- the transfer pipeline ----------------------------------------------------

def _copy_columns(dst: np.ndarray, src: np.ndarray, cols) -> None:
    """``dst[:] = src[:, cols]``, a slice copy for each run of adjacent
    columns (several times a gather's speed: the used columns of a
    matrix are mostly runs)."""
    cols = np.asarray(cols, np.int64)
    k = 0
    while k < len(cols):
        e = k + 1
        while e < len(cols) and cols[e] == cols[e - 1] + 1:
            e += 1
        dst[:, k:e] = src[:, cols[k]:cols[e - 1] + 1]
        k = e


class _Pipe:
    """Two host staging buffers (pinned on a card) and two device
    staging buffers of one chunk shape, with the copies on a side stream
    fenced by events. On the CPU a chunk's host array is its device
    chunk and nothing is staged."""

    def __init__(self, rows: int, width: int, np_dtype, device,
                 policy=None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rows, self.width = rows, width
        self.np_dtype = np.dtype(np_dtype)
        self.dtype = torch.from_numpy(np.zeros(0, np_dtype)).dtype
        self.policy = policy
        self.n = 0
        if self.cuda:
            self.host = [torch.empty((rows, width), dtype=self.dtype,
                                     pin_memory=True) for _ in range(2)]
            self.dev = [None, None]
            self.copied = [None, None]       # event: copy out of host[b]
            self.binned = [None, None]       # event: bins read dev[b]
            self.stream = torch.cuda.Stream(device=self.device)

    def stage(self, b: int, X: np.ndarray, r0: int, r1: int,
              cols: np.ndarray):
        """Host half: rows [r0, r1) of ``X``'s columns ``cols`` into
        staging buffer ``b`` (after its last copy has left it)."""
        if faults.active():
            faults.check("ingest.prep", context=f"{r1 - r0} rows")
        with trace.span("ingest/prep_chunk", cat="ingest",
                        args={"rows": int(r1 - r0)}):
            if not self.cuda:
                dst = np.empty((r1 - r0, len(cols)), self.np_dtype)
            else:
                if self.copied[b] is not None:
                    self.copied[b].synchronize()
                dst = self.host[b][:r1 - r0].numpy()
            _copy_columns(dst, X[r0:r1], cols)
            return dst

    def send(self, b: int, staged, k: int):
        """Main-thread half: staged chunk ``b`` of ``k`` rows to the
        card, into device staging buffer ``b``. Returns the [k, width]
        device chunk, ready on the current stream."""
        nbytes = int(k * self.width * self.dtype.itemsize)

        def put():
            if faults.active():
                faults.check("ingest.device_put",
                             context=f"{nbytes} bytes")
            if not self.cuda:
                return torch.from_numpy(staged).to(self.device)
            if self.dev[b] is None:
                self.dev[b] = torch.empty((self.rows, self.width),
                                          dtype=self.dtype,
                                          device=self.device)
            out = self.dev[b]
            cur = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.stream):
                if self.binned[b] is not None:
                    self.stream.wait_event(self.binned[b])
                out[:k].copy_(self.host[b][:k], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            self.copied[b] = ev
            cur.wait_event(ev)
            return out[:k]

        with timing.phase("binning/device_xfer"):
            xd = retry.call(put, what="ingest device copy",
                            policy=self.policy)
        obs.counter("ingest/h2d_bytes").add(nbytes)
        obs.counter("ingest/h2d_chunks").add(1)
        obs.counter("ingest/rows_device").add(k)
        self.n += 1
        return xd

    def done(self, b: int) -> None:
        """The binning of staging buffer ``b``'s chunk is queued: its
        next copy waits for it."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.binned[b] = ev


# -- the device binner ------------------------------------------------------

class DeviceBinner:
    """The value->bin map of one mapper set on ``device``: a chunk of raw
    rows in, its columns of the ``[F, N]`` bins written in place.

    ``bin_matrix`` (a whole host matrix, the prefetch worker's double
    buffer) and ``start_stream`` (the two-round loader's feed) share the
    chunk pipeline. ``x_dtype`` is the host matrix's float type, which
    is what goes over the wire."""

    def __init__(self, mappers: List[BinMapper],
                 used_feature_map: np.ndarray, config, x_dtype,
                 device) -> None:
        if not mappers:
            raise IngestUnsupported("no usable features")
        if not mappers_supported(mappers):
            raise IngestUnsupported("categorical table exceeds int32")
        x_dtype = np.dtype(x_dtype)
        if x_dtype not in (np.float32, np.float64):
            raise IngestUnsupported(f"dtype {x_dtype} not supported")
        self.mappers = mappers
        self.x_dtype = x_dtype
        self.device = torch.device(device)
        used = np.asarray(used_feature_map, np.int64)
        self.num_inner = [i for i, m in enumerate(mappers)
                          if m.bin_type == BinType.NUMERICAL]
        self.cat_inner = [i for i, m in enumerate(mappers)
                          if m.bin_type != BinType.NUMERICAL]
        self.num_cols = used[self.num_inner]        # source columns
        self.cat_cols = used[self.cat_inner]
        # a chunk's columns: the numerical features', then the
        # categorical ones'
        self.cols = np.concatenate([self.num_cols, self.cat_cols])
        max_bin = max(m.num_bin for m in mappers)
        self.out_dtype = torch.uint8 if max_bin <= 256 else torch.int32
        self.chunk_rows = auto_chunk_rows(config, len(mappers),
                                          x_dtype.itemsize)
        self.retry_policy = retry.RetryPolicy(
            attempts=int(getattr(config, "tpu_retry_attempts", 4) or 4))
        # numerical tables: each feature's searched bounds, padded with
        # +inf to one width (never below a value: padding never counts),
        # and its NaN bin (-1 where NaN reads as 0.0)
        fn = len(self.num_inner)
        width = max([mappers[i].num_searched() for i in self.num_inner]
                    + [1])
        bounds = np.full((max(fn, 1), width), np.inf, np.float64)
        nan_bin = np.full(max(fn, 1), -1, np.int64)
        for k, i in enumerate(self.num_inner):
            m = mappers[i]
            r = m.num_searched()
            bounds[k, :r] = m.bin_upper_bound[:r]
            if m.missing_type == MissingType.NAN:
                nan_bin[k] = m.num_bin - 1
        self._bounds = torch.from_numpy(bounds).to(self.device)
        self._nan_bin = torch.from_numpy(nan_bin).to(self.device)
        self._num_rows = torch.as_tensor(self.num_inner, dtype=torch.int64,
                                         device=self.device)

    def _pipe(self) -> _Pipe:
        return _Pipe(self.chunk_rows, len(self.cols), self.x_dtype,
                     self.device, self.retry_policy)

    def bin_chunk(self, xd: torch.Tensor, out: torch.Tensor,
                  r0: int) -> None:
        """Device chunk ``xd`` [k, F_sel] (the columns of ``self.cols``)
        -> ``out[:, r0:r0 + k]``, in float64: bit-equal to
        ``BinMapper.value_to_bin``."""
        from .dataset import category_bins
        k = xd.shape[0]
        fn = len(self.num_inner)
        with trace.span("ingest/bin_chunk", cat="ingest",
                        args={"rows": int(k)}):
            if fn:
                v = xd[:, :fn].to(torch.float64).T.contiguous()
                nan = torch.isnan(v)
                pos = torch.searchsorted(self._bounds[:fn],
                                         torch.where(nan, 0.0, v))
                nb = self._nan_bin[:fn, None]
                pos = torch.where(nan & (nb >= 0), nb, pos)
                out[self._num_rows, r0:r0 + k] = pos.to(out.dtype)
            for j, i in enumerate(self.cat_inner):
                out[i, r0:r0 + k] = category_bins(
                    xd[:, fn + j].to(torch.float64),
                    self.mappers[i]).to(out.dtype)

    def empty_bins(self, n: int) -> torch.Tensor:
        return torch.empty((len(self.mappers), n), dtype=self.out_dtype,
                           device=self.device)

    def bin_matrix(self, X: np.ndarray) -> torch.Tensor:
        """Whole host matrix -> [F, N] bins on the device, through the
        double-buffered pipeline."""
        n = X.shape[0]
        C = self.chunk_rows
        out = self.empty_bins(n)
        pipe = self._pipe()
        starts = list(range(0, n, C))

        def thunk(c, r0):
            return lambda: (c, r0, pipe.stage(c % 2, X, r0,
                                              min(r0 + C, n), self.cols))

        for c, r0, staged in prefetch(
                (thunk(c, r0) for c, r0 in enumerate(starts)),
                what="ingest chunk", policy=self.retry_policy):
            xd = pipe.send(c % 2, staged, min(C, n - r0))
            self.bin_chunk(xd, out, r0)
            pipe.done(c % 2)
        log.debug("device ingest: %d rows x %d features in %d chunk(s) of "
                  "%d rows", n, len(self.mappers), len(starts), C)
        return out

    def start_stream(self, n_rows: int) -> "IngestStream":
        return IngestStream(self, n_rows)


class IngestStream:
    """The feed-driven variant for streaming loaders (two-round text
    loading): blocks of parsed rows arrive, are repacked to the binner's
    chunk rows and sent; the caller's parsing of the next block is the
    host half of the double buffer. ``n_rows`` (known after the loader's
    first pass) sizes the [F, N] bins written in place."""

    def __init__(self, binner: DeviceBinner, n_rows: int):
        self._b = binner
        self._pipe = binner._pipe()
        self._out = binner.empty_bins(int(n_rows))
        self._pend: List[np.ndarray] = []
        self._pend_rows = 0
        self._rows = 0          # rows sent

    def _send(self, block: np.ndarray) -> None:
        b = self._pipe.n % 2
        k = block.shape[0]
        staged = self._pipe.stage(b, block, 0, k, self._b.cols)
        xd = self._pipe.send(b, staged, k)
        self._b.bin_chunk(xd, self._out, self._rows)
        self._pipe.done(b)
        self._rows += k

    def feed(self, X: np.ndarray) -> None:
        C = self._b.chunk_rows
        self._pend.append(np.asarray(X))
        self._pend_rows += X.shape[0]
        while self._pend_rows >= C:
            block = (self._pend[0] if len(self._pend) == 1
                     else np.concatenate(self._pend, axis=0))
            self._send(block[:C])
            rest = block[C:]
            self._pend = [rest] if rest.shape[0] else []
            self._pend_rows = rest.shape[0]

    def finish(self) -> torch.Tensor:
        """-> [F, N] device bins over every fed row."""
        if self._pend_rows:
            block = (self._pend[0] if len(self._pend) == 1
                     else np.concatenate(self._pend, axis=0))
            self._send(block)
            self._pend, self._pend_rows = [], 0
        if self._rows != self._out.shape[1]:
            raise ValueError(f"ingest stream fed {self._rows} rows, "
                             f"expected {self._out.shape[1]}")
        return self._out


# -- the sharded half: one rank's row block ----------------------------------

# the largest power-of-two row unit a shard aligns to (the JAX package's
# autotune candidate ceiling, ops/autotune.py MAX_HIST_CHUNK)
MAX_HIST_CHUNK = 65536


def shard_width(n: int, D: int, hist_chunk: int = 0) -> int:
    """Rows a rank's block holds of ``n`` over ``D`` ranks (the JAX
    package's ``shard_width``, io/ingest.py:116): ceil(n / D), rounded up
    to the pinned ``hist_chunk`` or else to the largest power-of-two unit
    u <= MAX_HIST_CHUNK with n >= 4 D u (the pad stays under a quarter
    block). The last block is short; the blocks tile [0, n)."""
    S = max(-(-int(n) // int(D)), 1)
    if hist_chunk > 0:
        u = hist_chunk if n >= 4 * D * hist_chunk else 1
    else:
        u = 1
        while u * 2 <= MAX_HIST_CHUNK and n >= 4 * D * (u * 2):
            u *= 2
    if u > 1:
        S = -(-S // u) * u
    return S


def host_row_block(n_global: int, world_n: int, rank_n: int,
                   hist_chunk: int = 0) -> tuple:
    """(row_start, row_stop, S): the contiguous global rows rank
    ``rank_n`` of ``world_n`` holds (``shard_width``'s S; the stop
    clamps to ``n_global``, so a late rank's block may be empty)."""
    S = shard_width(n_global, world_n, hist_chunk)
    lo = min(rank_n * S, int(n_global))
    return lo, min(lo + S, int(n_global)), S


def bin_matrix_sharded(binner: "DeviceBinner", X: np.ndarray, lo: int,
                       hi: int) -> torch.Tensor:
    """Rows [lo, hi) of the host matrix ``X`` -> [F, hi - lo] bins on the
    binner's device, through the chunk pipeline: the other rows are never
    read or sent."""
    out = binner.bin_matrix(X[lo:hi])
    obs.counter("ingest/rows_local_host").add(hi - lo)
    log.debug("sharded device ingest: rows [%d, %d) of %d onto %s", lo, hi,
              X.shape[0], binner.device)
    return out


def bin_matrix_multihost(binner: "DeviceBinner", X_local: np.ndarray,
                         row_start: int, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of the global matrix, out of ``X_local``, which holds
    the global rows [row_start, row_start + len(X_local)) (a rank's own
    file): they must cover the block."""
    if not (row_start <= lo and hi <= row_start + X_local.shape[0]):
        raise ValueError(
            f"multihost ingest: the rows [{row_start}, "
            f"{row_start + X_local.shape[0]}) do not cover the block "
            f"[{lo}, {hi}); cut each rank's data with host_row_block")
    return bin_matrix_sharded(binner, X_local, lo - row_start,
                              hi - row_start)


class ShardedIngestStream:
    """The feed-driven variant of ``bin_matrix_sharded`` for the
    two-round loader: every row of the file arrives in order, in
    parser-sized blocks, and only the rows in [lo, hi) go on to an
    ``IngestStream`` of the block's rows (the JAX package's
    ``ShardedIngestStream``, io/ingest.py:1241)."""

    def __init__(self, binner: "DeviceBinner", n_global: int, lo: int,
                 hi: int):
        self._n, self._lo, self._hi = int(n_global), int(lo), int(hi)
        self._inner = IngestStream(binner, self._hi - self._lo)
        self._cursor = 0                # the global row of the next block

    def feed(self, X: np.ndarray) -> None:
        r0, r1 = self._cursor, self._cursor + X.shape[0]
        self._cursor = r1
        a, b = max(r0, self._lo), min(r1, self._hi)
        if a < b:
            self._inner.feed(X[a - r0:b - r0])

    def finish(self) -> torch.Tensor:
        """-> [F, hi - lo] device bins of the block."""
        if self._cursor != self._n:
            raise ValueError(f"sharded ingest stream fed {self._cursor} "
                             f"rows, expected {self._n}")
        obs.counter("ingest/rows_local_host").add(self._hi - self._lo)
        return self._inner.finish()


def start_sharded_stream(binner: "DeviceBinner", n_global: int, lo: int,
                         hi: int) -> ShardedIngestStream:
    return ShardedIngestStream(binner, n_global, lo, hi)


# -- CSR --------------------------------------------------------------------

def sparse_chunk_rows(config, n: int, nnz: int) -> int:
    """Rows per sparse chunk: the ``tpu_ingest_chunk_rows`` knob, or a
    power of two of rows carrying ~64 MB of entries at the matrix's mean
    row length (a chunk's wire bytes are its entries, whatever the
    column count)."""
    knob = int(getattr(config, "tpu_ingest_chunk_rows", 0) or 0)
    if knob > 0:
        return knob
    per_row = max(nnz / max(n, 1), 1.0) * _SPARSE_ENTRY_BYTES
    c = max(int(_TARGET_CHUNK_BYTES // per_row), 1)
    c = 1 << int(np.floor(np.log2(c)))
    return int(min(max(c, _MIN_CHUNK_ROWS), _MAX_CHUNK_ROWS))


class SparseDeviceBinner:
    """The explicit entries of a CSR matrix, binned on the device chunk
    by chunk of rows into the layout of ``io/dataset.py SparseEntries``:
    grouped by inner feature, by row within a feature.

    The host half (the prefetch worker) maps a row chunk's columns to
    inner features (-1: unused) as int32 and counts its entries a row;
    the values go over the wire as float64, 12 bytes an entry. On the
    card each entry's numerical bin is a branchless lower-bound search
    over its feature's bounds (the dense binner's padded table, gathered
    by feature), categorical entries take ``category_bins``, and every
    entry is written at its final position: its feature's start, plus
    that feature's entries in earlier chunks, plus its rank in this
    chunk (a stable sort by feature)."""

    def __init__(self, mappers: List[BinMapper],
                 used_feature_map: np.ndarray, config, device) -> None:
        self.dense = DeviceBinner(mappers, used_feature_map, config,
                                  np.float64, device)
        self.config = config
        self.device = self.dense.device
        self.mappers = mappers
        self.used = np.asarray(used_feature_map, np.int64)
        self.retry_policy = self.dense.retry_policy
        nf = len(mappers)
        # inner feature -> row of the numerical bounds table (0 for a
        # categorical one, whose entries take the category lookup)
        numpos = np.zeros(max(nf, 1), np.int64)
        numpos[self.dense.num_inner] = np.arange(len(self.dense.num_inner))
        self._numpos = torch.from_numpy(numpos).to(self.device)
        # the bounds table padded with +inf to a power of two for the
        # uniform binary search, flattened for a gather by feature
        tab = self.dense._bounds
        width = tab.shape[1]
        self._bp = 1 << int(np.ceil(np.log2(width + 1)))
        padded = torch.full((tab.shape[0], self._bp), float("inf"),
                            dtype=torch.float64, device=self.device)
        padded[:, :width] = tab
        self._flat = padded.reshape(-1)

    def bin_entries(self, sm):
        """CSR ``sm`` -> (codes, rows, feat) [E] int32 on the device and
        ``bounds`` [F + 1] (host), each feature's slice."""
        n, ncol = sm.shape
        nf = len(self.mappers)
        dev = self.device
        real2inner = np.full(ncol, -1, np.int32)
        real2inner[self.used] = np.arange(nf, dtype=np.int32)
        sizes = np.bincount(real2inner[sm.cols][real2inner[sm.cols] >= 0],
                            minlength=nf) if nf else np.zeros(0, np.int64)
        bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        E = int(bounds[-1])
        codes = torch.empty(E, dtype=torch.int32, device=dev)
        rows = torch.empty(E, dtype=torch.int32, device=dev)
        feat = torch.empty(E, dtype=torch.int32, device=dev)
        # where the next entry of each feature goes
        cursor = torch.from_numpy(bounds[:-1].copy()).to(dev)
        C = sparse_chunk_rows(self.config, n, sm.nnz)
        cuda = dev.type == "cuda"

        def stage(r0: int, r1: int):
            if faults.active():
                faults.check("ingest.prep", context=f"{r1 - r0} rows")
            with trace.span("ingest/prep_chunk", cat="ingest",
                            args={"rows": int(r1 - r0), "sparse": True}):
                e0, e1 = int(sm.indptr[r0]), int(sm.indptr[r1])
                inner = real2inner[sm.cols[e0:e1]]
                counts = np.diff(sm.indptr[r0:r1 + 1]).astype(np.int32)
                planes = [torch.from_numpy(np.ascontiguousarray(
                    sm.data[e0:e1])), torch.from_numpy(inner),
                    torch.from_numpy(counts)]
                if cuda:
                    planes = [p.pin_memory() for p in planes]
                return r0, r1, planes

        starts = list(range(0, n, C))
        for r0, r1, planes in prefetch(
                (lambda r0=r0: stage(r0, min(r0 + C, n))
                 for r0 in starts),
                what="sparse ingest chunk", policy=self.retry_policy):
            nbytes = sum(int(p.numel() * p.element_size())
                         for p in planes)

            def put(planes=planes, nbytes=nbytes):
                if faults.active():
                    faults.check("ingest.device_put",
                                 context=f"{nbytes} bytes")
                return [p.to(dev, non_blocking=True) for p in planes]

            with timing.phase("binning/device_xfer"):
                vals, inner, counts = retry.call(
                    put, what="sparse ingest device copy",
                    policy=self.retry_policy)
            obs.counter("ingest/h2d_bytes").add(nbytes)
            obs.counter("ingest/h2d_chunks").add(1)
            obs.counter("ingest/rows_device").add(r1 - r0)
            self._place(r0, vals, inner, counts, codes, rows, feat, cursor)
        log.debug("sparse device ingest: %d rows x %d features (nnz=%d) in "
                  "%d chunk(s) of %d rows", n, nf, sm.nnz, len(starts), C)
        return codes, rows, feat, bounds

    def _place(self, r0, vals, inner, counts, codes, rows, feat,
               cursor) -> None:
        """One chunk's entries binned and written at their positions."""
        from .dataset import category_bins
        dev = self.device
        lrow = torch.repeat_interleave(
            torch.arange(counts.numel(), dtype=torch.int32, device=dev),
            counts.to(torch.int64), output_size=int(inner.numel()))
        keep = inner >= 0
        inner, vals, lrow = inner[keep], vals[keep], lrow[keep]
        if inner.numel() == 0:
            return
        f = inner.to(torch.int64)
        order = torch.sort(f, stable=True).indices
        f, vals, lrow = f[order], vals[order], lrow[order]
        # the chunk's rank of each entry within its feature
        nf = cursor.numel()
        per = torch.bincount(f, minlength=nf)
        first = torch.cumsum(per, 0) - per
        rank = torch.arange(f.numel(), device=dev) - first[f]
        dest = cursor[f] + rank
        cursor += per
        code = self._lower_bound(f, vals)
        for i in self.dense.cat_inner:
            sel = f == i
            if bool(sel.any()):
                code[sel] = category_bins(vals[sel], self.mappers[i])
        codes[dest] = code.to(torch.int32)
        rows[dest] = lrow + r0
        feat[dest] = f.to(torch.int32)

    def _lower_bound(self, f: torch.Tensor, vals: torch.Tensor):
        """Each entry's numerical bin: the count of its feature's bounds
        below the value (NaN as 0.0, or the NaN bin), by a uniform binary
        search over the +inf-padded table."""
        bp, flat = self._bp, self._flat
        row = self._numpos[f]
        base = row * bp
        nan = torch.isnan(vals)
        x = torch.where(nan, 0.0, vals)
        pos = torch.zeros_like(row)
        step = bp
        while step > 1:
            step //= 2
            go = flat[base + pos + (step - 1)] < x
            pos = torch.where(go, pos + step, pos)
        nb = self.dense._nan_bin[row]
        return torch.where(nan & (nb >= 0), nb, pos)
