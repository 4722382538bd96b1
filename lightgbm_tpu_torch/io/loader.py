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
of a text file. The two-round, out-of-core route (``two_round``,
``tpu_out_of_core``) is not ported yet (ROADMAP item 17).
"""
from __future__ import annotations

import os
from typing import List, Optional, Set, Tuple

import numpy as np

from ..config import Config
from ..utils import log, timing
from .dataset import BinnedDataset, Metadata
from .file_io import open_file
from .parser import parse_file


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
            raise NotImplementedError(
                "two_round / tpu_out_of_core loading is not ported yet "
                "(ROADMAP item 17)")
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
