"""Dataset loading from text / binary files.

The JAX package's ``io/loader.py`` (reference DatasetLoader,
src/io/dataset_loader.cpp:161-1111 LoadFromFile /
ConstructBinMappersFromTextData; column resolution
dataset_loader.cpp:53-159; sidecar files src/io/metadata.cpp:324-431).

Responsibilities: resolve label/weight/group/ignore/categorical columns
(by index or ``name:`` prefix against the header), parse the text file
(io/parser.py), split metadata columns out of the feature matrix, load
``.weight`` / ``.query`` / ``.init`` sidecar files, and construct the
binned set on the loader's device through ``construct_from_matrix``, on
the same row sample as a matrix of the same values (so a file and
``LGBM_DatasetCreateFromMat`` on its matrix give the same bins). Binary
files (``save_binary``) short-circuit to ``BinnedDataset.load_binary``
like dataset_loader.cpp:252-257, and ``<file>.bin`` is the binary cache
of a text file.

``two_round=true`` (or ``tpu_out_of_core=1``) takes the two-round,
memory-light route (``_load_two_round``): the file is read in passes and
the float matrix never exists whole on the host. Its row sample for the
mappers is the one-round route's, so both routes give the same bins.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..config import Config
from ..obs import registry as obs
from ..utils import log, timing
from . import ingest
from .dataset import BinnedDataset, Metadata, find_column_mappers
from .file_io import open_file
from .parser import (ParsedText, _first_data_lines, detect_format,
                     parse_delimited, parse_file, parse_libsvm)


def _parse_column_spec(spec: str, names: List[str], what: str) -> int:
    """'name:foo' or integer index -> index; -1 when unset
    (dataset_loader.cpp:53-112)."""
    spec = spec.strip()
    if not spec:
        return -1
    if spec.startswith("name:"):
        name = spec[5:]
        if name not in names:
            log.fatal(f"Could not find {what} column {name!r} in data file "
                      "(set header=true?)")
        return names.index(name)
    try:
        return int(spec)
    except ValueError:
        log.fatal(f"Bad {what} column spec {spec!r}; use an index or "
                  "'name:column_name'")


def _parse_multi_column_spec(spec: str, names: List[str],
                             what: str) -> Set[int]:
    """Comma-separated indices or 'name:a,b,c' (dataset_loader.cpp:113-159)."""
    spec = spec.strip()
    if not spec:
        return set()
    out: Set[int] = set()
    if spec.startswith("name:"):
        for name in spec[5:].split(","):
            name = name.strip()
            if not name:
                continue
            if name not in names:
                log.fatal(f"Could not find {what} column {name!r} in data "
                          "file (set header=true?)")
            out.add(names.index(name))
        return out
    for tok in spec.split(","):
        tok = tok.strip()
        if tok:
            out.add(int(tok))
    return out


def _read_float_file(path: str) -> Optional[np.ndarray]:
    """One float per line (metadata.cpp LoadWeights/LoadQueryBoundaries)."""
    if not os.path.isfile(path):
        return None
    vals = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if ln and not ln.startswith("#"):
                vals.append([float(x) for x in ln.replace(",", " ").split()])
    if not vals:
        return None
    arr = np.asarray(vals, np.float64)
    return arr[:, 0] if arr.shape[1] == 1 else arr


class DatasetLoader:
    """LoadFromFile / column bookkeeping (dataset_loader.cpp:24-52). Sets
    are binned on ``device`` (None: cuda:0); a valid set on its
    reference's device."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.device = device

    # -- text -> BinnedDataset -----------------------------------------------

    def load_from_file(self, filename: str,
                       reference: Optional[BinnedDataset] = None
                       ) -> BinnedDataset:
        """LoadFromFile (dataset_loader.cpp:161-257). ``reference`` set
        = validation data binned with the train mappers (CreateValid)."""
        cfg = self.config
        bin_cache = filename + ".bin"
        if not BinnedDataset.is_binary_file(filename) and (
                cfg.enable_load_from_binary_file and reference is None
                and BinnedDataset.is_binary_file(bin_cache)):
            log.info("Loading dataset from binary cache %s", bin_cache)
            filename = bin_cache
        if BinnedDataset.is_binary_file(filename):
            log.info("Loading binary dataset %s", filename)
            with timing.phase("io/load_binary") as ph:
                ds = BinnedDataset.load_binary(filename, cfg, self.device)
                ph.watch(ds.bins_t)
            return ds
        if cfg.two_round or cfg.tpu_out_of_core == 1:
            ds = self._load_two_round(filename, reference)
            log.info("Finished loading %s: %d rows, %d used features",
                     filename, ds.num_data, ds.num_features)
            if cfg.save_binary and reference is None:
                ds.save_binary(bin_cache)
            return ds
        with timing.phase("io/parse"):
            X, meta, names, categorical = self._parse_with_metadata(
                filename)
        if reference is not None:
            ds = reference.create_valid(X, meta)
        else:
            ds = BinnedDataset(cfg, self.device).construct_from_matrix(
                X, meta, feature_names=names or None,
                categorical=categorical)
        log.info("Finished loading %s: %d rows, %d used features",
                 filename, ds.num_data, ds.num_features)
        if cfg.save_binary and reference is None:
            ds.save_binary(bin_cache)
        return ds

    # -- two-round (memory-light) loading ------------------------------------

    def _data_blocks(self, filename: str, rows: int):
        """The data lines (as bytes, without their line ends) in lists of
        at most ``rows``: blank and '#' comment lines skipped, and the
        header when ``header`` is set (TextReader parity,
        utils/text_reader.h; the JAX package's ``_data_lines``). The file
        is read in 16 MB pieces split by C-level calls; lines are looked
        at one by one only in a piece holding a '#' or a blank line."""
        header_pending = self.config.header
        pending: List[bytes] = []
        tail = b""
        with open_file(filename, "rb") as fh:
            while True:
                piece = fh.read(_READ_BYTES)
                if piece:
                    buf = tail + piece
                    cut = buf.rfind(b"\n")
                    if cut < 0:
                        tail = buf
                        continue
                    blob, tail = buf[:cut], buf[cut + 1:]
                elif tail:
                    blob, tail = tail, b""
                else:
                    break
                lines = blob.split(b"\n")
                if (b"#" in blob or _BLANK_LINE.search(blob)
                        or not lines[0].strip() or not lines[-1].strip()):
                    lines = [ln for ln in lines
                             if ln.strip() and not ln.lstrip().startswith(b"#")]
                if b"\r" in blob:
                    lines = [ln.rstrip(b"\r") for ln in lines]
                if header_pending and lines:
                    header_pending = False
                    lines = lines[1:]
                pending.extend(lines)
                while len(pending) >= rows:
                    yield pending[:rows]
                    pending = pending[rows:]
        if pending:
            yield pending

    def _load_two_round(self, filename: str,
                        reference: Optional[BinnedDataset] = None
                        ) -> BinnedDataset:
        """two_round=true (or tpu_out_of_core=1): the reference's
        memory-light route (dataset_loader.cpp LoadFromFile with
        two_round, :196-235 and :657-704), as the JAX package's
        ``_load_two_round``. Pass 1 counts the rows (and, for libsvm, the
        columns); pass 2 parses only the rows of the mappers' sample,
        the one-round route's sample (``find_column_mappers``'s
        ``rng.choice``, where the JAX package keeps a reservoir: the two
        agree while the file has no more rows than
        ``bin_construct_sample_cnt``); pass 3 streams the file in blocks
        of ``tpu_ooc_block_rows`` (0: 262,144) rows. Each block feeds an
        ``IngestStream`` (io/ingest.py), so the host holds a block, never
        the matrix; ``tpu_out_of_core=0`` (or ``tpu_ingest`` off) bins
        each block on the host into the [N, F] bins, uploaded once. A
        valid set (``reference``) is binned with its reference's mappers
        and bundles; a train set bundles as the one-round route does,
        from its bins on the device. A rank of a row-sharded learner
        (tree_learner data or voting on several ranks) parses every row
        and bins only its block (io/ingest.py ``ShardedIngestStream``,
        the set's ``row_block``); its bins are not bundled, since ranks
        cannot agree on bundles found from their own rows."""
        cfg = self.config
        block_rows = int(cfg.tpu_ooc_block_rows) or (1 << 18)
        first, head = _first_data_lines(filename, 2, cfg.header, True)
        fmt = detect_format(first)
        delim = "\t" if fmt == "tsv" else ","
        full_names = ([t.strip() for t in head.split(delim)]
                      if cfg.header and head else [])
        label_all = _parse_column_spec(
            cfg.label_column, full_names,
            "label") if cfg.label_column else 0
        if label_all < 0:
            label_all = 0

        def parse_lines(lines, ncol_hint=0) -> ParsedText:
            if fmt == "libsvm":
                return parse_libsvm([ln.decode() for ln in lines],
                                    label_all, ncol_hint)
            return _parse_delimited_fast(lines, delim, label_all)

        # pass 1: count the rows; for libsvm the columns too (a feature
        # absent from the sample must still get its trivial mapper)
        n = 0
        libsvm_maxidx = -1
        with timing.phase("io/two_round_count"):
            for lines in self._data_blocks(filename, block_rows):
                n += len(lines)
                if fmt != "libsvm":
                    continue
                for ln in lines:
                    # indices ascend in well-formed rows: the last pair
                    # carries the row's largest index
                    tail = ln.rstrip().rsplit(None, 1)
                    if len(tail) == 2 and b":" in tail[1]:
                        try:
                            libsvm_maxidx = max(
                                libsvm_maxidx, int(tail[1].split(b":", 1)[0]))
                        except ValueError:
                            pass
        if n == 0:
            log.fatal(f"Data file {filename} is empty")
        # pass 2: the sample's rows only
        cap = max(int(cfg.bin_construct_sample_cnt), 1)
        if n > cap:
            rng = np.random.default_rng(cfg.data_random_seed)
            pick = np.zeros(n, bool)
            pick[rng.choice(n, cap, replace=False)] = True
        else:
            pick = None
        with timing.phase("io/two_round_sample"):
            sample: List[bytes] = []
            row = 0
            for lines in self._data_blocks(filename, block_rows):
                if pick is None:
                    sample.extend(lines)
                else:
                    sample.extend(lines[i] for i in np.flatnonzero(
                        pick[row:row + len(lines)]))
                row += len(lines)
            libsvm_cols = libsvm_maxidx + 1 if fmt == "libsvm" else 0
            sparsed = parse_lines(sample, libsvm_cols)
        del sample
        ncol = max(sparsed.num_columns, libsvm_cols)
        # rows missing trailing delimited columns bin as missing (the
        # one-round parser's semantics); absent libsvm pairs are 0
        pad_value = 0.0 if fmt == "libsvm" else np.nan

        feat_names = list(full_names)
        if feat_names and sparsed.label is not None \
                and len(feat_names) > ncol:
            feat_names.pop(max(label_all, 0))
        (weight_idx, group_idx, keep_cols, categorical,
         feat_names) = self._resolve_columns(feat_names, ncol)

        if reference is not None:
            ds = reference._sharing(n, Metadata())
        else:
            ds = BinnedDataset(cfg, self.device)
            ds.num_data = n
            ds.num_total_features = len(keep_cols)
            ds.feature_names = (feat_names if feat_names else
                                [f"Column_{i}"
                                 for i in range(len(keep_cols))])
            Xs = sparsed.values
            if Xs.shape[1] < ncol:
                Xs = np.pad(Xs, ((0, 0), (0, ncol - Xs.shape[1])),
                            constant_values=pad_value)
            with timing.phase("binning/find_bins"):
                ds.set_mappers(find_column_mappers(
                    Xs[:, keep_cols], cfg, categorical, total_rows=n,
                    presampled=True))
        has_label = sparsed.label is not None
        del sparsed

        # pass 3: stream the blocks into the binner
        stream = None
        from ..parallel import cluster, learners
        if (reference is None and cluster.is_multiprocess()
                and cfg.tree_learner in ("data", "voting")):
            ds.row_block = learners.learner_block(n, cluster.world(),
                                                  cluster.rank())
        if (cfg.tpu_out_of_core != 0 and ingest.ingest_enabled(cfg, ds.device)
                or ds.row_block is not None):
            try:
                binner = ingest.DeviceBinner(
                    ds.mappers, ds.used_feature_map, cfg, np.float64,
                    ds.device)
                stream = (binner.start_stream(n) if ds.row_block is None
                          else ingest.start_sharded_stream(
                              binner, n, *ds.row_block))
            except ingest.IngestUnsupported as e:
                log.debug("two_round: streamed ingest unavailable (%s)", e)
        bins = None
        if stream is None:
            bins = np.zeros((n, max(ds.num_features, 1)),
                            np.uint8 if ds.max_bin_global <= 256
                            else np.int32)
        label = np.zeros(n, np.float32)
        weight = np.zeros(n, np.float32) if weight_idx >= 0 else None
        group_col = np.zeros(n, np.float64) if group_idx >= 0 else None
        row = 0

        def flush(buf):
            nonlocal row
            if not buf:
                return
            obs.counter("ooc/blocks").add(1)
            obs.counter("ooc/disk_bytes").add(sum(map(len, buf)) + len(buf))
            p = parse_lines(buf, ncol)
            Xc = p.values
            if Xc.shape[1] < ncol:
                Xc = np.pad(Xc, ((0, 0), (0, ncol - Xc.shape[1])),
                            constant_values=pad_value)
            elif Xc.shape[1] > ncol:
                if fmt == "libsvm":
                    log.fatal(
                        f"two_round: a libsvm row block has {Xc.shape[1]} "
                        f"columns, expected {ncol}; feature indices are not "
                        "ascending within a row. Sort them or load with "
                        "two_round=false")
                log.warning("two_round: a row block has %d columns, "
                            "expected %d; extra columns ignored",
                            Xc.shape[1], ncol)
                Xc = Xc[:, :ncol]
            k = Xc.shape[0]
            if p.label is not None:
                label[row:row + k] = p.label
            if weight is not None:
                weight[row:row + k] = Xc[:, weight_idx]
            if group_col is not None:
                group_col[row:row + k] = Xc[:, group_idx]
            Xf = Xc if len(keep_cols) == Xc.shape[1] else Xc[:, keep_cols]
            if stream is not None:
                stream.feed(Xf)
            else:
                for i, real in enumerate(ds.used_feature_map):
                    bins[row:row + k, i] = ds.mappers[i].value_to_bin(
                        Xf[:, real])
                obs.counter("ingest/rows_host").add(k)
            obs.counter("loader/two_round_blocks").add(1)
            obs.counter("loader/two_round_rows").add(k)
            row += k

        with timing.phase("io/two_round_stream") as ph:
            for lines in self._data_blocks(filename, block_rows):
                flush(lines)
            if stream is not None:
                bins_t = ph.watch(stream.finish())
            else:
                if ds.row_block is not None:
                    bins = bins[ds.row_block[0]:ds.row_block[1]]
                obs.counter("ingest/h2d_bytes").add(int(bins.nbytes))
                bins_t = ph.watch(torch.from_numpy(
                    np.ascontiguousarray(bins.T)).to(ds.device))
        del bins
        ds.metadata = self._assemble_metadata(
            filename, label if has_label else None,
            weight, group_col)
        ds.metadata.check(n)
        ds.bins_t = bins_t
        with timing.phase("binning/efb"):
            ds._apply_efb(reference.bundles if reference is not None
                          else None if ds.row_block is not None
                          else ds._find_bundles())
        try:
            import resource
            obs.gauge("ooc/rss_peak_mb").set(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0)
        except ImportError:        # not a POSIX host
            pass
        log.info("two_round load: %d rows in %d-row blocks (%s)", n,
                 block_rows, "streamed to the device" if stream is not None
                 else "binned on the host")
        return ds

    def _parse_with_metadata(self, filename: str
                             ) -> Tuple[np.ndarray, Metadata, List[str],
                                        List[int]]:
        cfg = self.config
        # resolve the label against the raw header line (full column
        # set, label included) without parsing the whole file twice
        full_names: List[str] = []
        if cfg.header:
            with open_file(filename) as fh:
                head = fh.readline()
            from .parser import detect_format
            delim = {"csv": ",", "tsv": "\t"}.get(
                detect_format([head]), "\t")
            full_names = [t.strip() for t in head.rstrip("\r\n")
                          .split(delim)]
        label_all = _parse_column_spec(
            cfg.label_column, full_names,
            "label") if cfg.label_column else 0
        if label_all < 0:
            label_all = 0
        parsed, header_names = parse_file(filename, header=cfg.header,
                                          label_idx=label_all)
        X = parsed.values
        label = parsed.label

        (weight_idx, group_idx, keep_cols, categorical,
         feat_names) = self._resolve_columns(list(header_names),
                                             X.shape[1])
        weight = X[:, weight_idx].astype(np.float32) if weight_idx >= 0 \
            else None
        group_col = X[:, group_idx] if group_idx >= 0 else None
        if len(keep_cols) != X.shape[1]:
            X = X[:, keep_cols]

        meta = self._assemble_metadata(filename, label, weight, group_col)
        return X, meta, feat_names, categorical

    def _resolve_columns(self, feat_names: List[str], ncol: int):
        """weight/group/ignore/categorical column resolution. Indices
        do NOT count the label column (docs/Parameters: "index starts
        from 0 ... doesn't count the label column"); names resolve
        against the post-label layout. Returns
        (weight_idx, group_idx, keep_cols, categorical, kept_names)
        with ``categorical`` remapped to the kept layout."""
        cfg = self.config
        weight_idx = _parse_column_spec(
            cfg.weight_column, feat_names,
            "weight") if cfg.weight_column else -1
        group_idx = _parse_column_spec(
            cfg.group_column, feat_names,
            "group") if cfg.group_column else -1
        ignore = _parse_multi_column_spec(cfg.ignore_column, feat_names,
                                          "ignore")
        categorical = _parse_multi_column_spec(
            cfg.categorical_feature, feat_names, "categorical")
        drop = sorted({i for i in (weight_idx, group_idx) if i >= 0}
                      | {i for i in ignore if 0 <= i < ncol})
        keep_cols = [i for i in range(ncol) if i not in drop]
        remap = {old: new for new, old in enumerate(keep_cols)}
        categorical = sorted({remap[c] for c in categorical
                              if c in remap})
        if feat_names:
            feat_names = [feat_names[i] for i in keep_cols
                          if i < len(feat_names)]
        return weight_idx, group_idx, keep_cols, categorical, feat_names

    def _assemble_metadata(self, filename: str, label, weight,
                           group_col) -> Metadata:
        """Metadata from in-file columns + sidecar files
        (metadata.cpp:324-431): <file>.weight, <file>.query, init scores
        from config or <file>.init."""
        cfg = self.config
        if weight is None:
            w = _read_float_file(filename + ".weight")
            if w is not None:
                weight = np.asarray(w, np.float32).reshape(-1)
                log.info("Loading weights from %s.weight", filename)
        group = None
        if group_col is not None:
            # query-id column -> boundaries via run-length counts
            ids = np.asarray(group_col)
            change = np.nonzero(np.diff(ids))[0] + 1
            bounds = np.concatenate([[0], change, [len(ids)]])
            group = np.diff(bounds)
        else:
            q = _read_float_file(filename + ".query")
            if q is None:
                q = _read_float_file(filename + ".query.weight")
            if q is not None:
                group = np.asarray(q, np.int64).reshape(-1)
                log.info("Loading query boundaries from %s.query", filename)
        init_score = None
        init_path = cfg.initscore_filename or (filename + ".init")
        isc = _read_float_file(init_path)
        if isc is not None:
            init_score = np.asarray(isc, np.float64)
            if init_score.ndim == 2:       # [N, K] column-major flatten
                init_score = init_score.T.reshape(-1)
            log.info("Loading initial scores from %s", init_path)
        return Metadata(label=label, weight=weight, init_score=init_score,
                        group=group)

    # -- prediction-side text load ------------------------------------------

    def load_predict_matrix(self, filename: str, num_features: int
                            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Parse a file for prediction: the label column may be absent
        when rows carry exactly num_features columns (Predictor path,
        parser.cpp:25-62 via infer_label_idx)."""
        cfg = self.config
        parsed, _ = parse_file(filename, header=cfg.header, label_idx=0,
                               num_features_hint=num_features)
        X = parsed.values
        if X.shape[1] < num_features:
            X = np.pad(X, ((0, 0), (0, num_features - X.shape[1])),
                       constant_values=np.nan)
        elif X.shape[1] > num_features:
            X = X[:, :num_features]
        return X, parsed.label



_READ_BYTES = 1 << 24
_BLANK_LINE = re.compile(rb"\n[ \t\r\f\v]*\n")   # inside a piece


def _parse_delimited_fast(lines: List[bytes], delim: str,
                          label_idx: int) -> ParsedText:
    """``parse_delimited`` of a block of rows (bytes) by the native
    tokenizer (``native.parse_block_native``, the one-round route's
    parser, every row with the first row's fields; up to 4 threads), or
    by ``parse_delimited`` itself where the native one declines (a
    ragged row)."""
    if lines:
        width = lines[0].count(delim.encode()) + 1
        has_label = 0 <= label_idx < width
        from .native import parse_block_native
        got = parse_block_native(lines, delim,
                                 label_idx if has_label else -1,
                                 width - (1 if has_label else 0),
                                 threads=min(os.cpu_count() or 1, 4))
        if got is not None:
            return ParsedText(*got)
    return parse_delimited([ln.decode() for ln in lines], delim, label_idx)
