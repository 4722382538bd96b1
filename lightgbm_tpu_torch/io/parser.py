"""Text parsers: CSV / TSV / LibSVM.

The JAX package's ``io/parser.py``, copied: the reference parser
machinery (src/io/parser.cpp:1-169, src/io/parser.hpp). Format is
auto-detected from delimiter statistics over the first lines
(GetStatistic, parser.cpp:10-23); the label column presence is inferred
the same way the reference does (GetLabelIdxFor{CSV,TSV,Libsvm},
parser.cpp:25-62). Unlike the row-at-a-time C++ parsers, parsing here is
columnar: the whole file is tokenized into a dense float64 matrix up
front — binning immediately consumes full columns, so a row iterator
would just add overhead.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from ..utils import log


class ParsedText:
    """Dense matrix view of a parsed text file.

    ``values``: [N, C] float64 with NaN for missing; ``label``: [N] or
    None when the file has no label column; ``num_columns`` counts the
    feature columns only (label removed).
    """

    def __init__(self, values: np.ndarray, label: Optional[np.ndarray]):
        self.values = values
        self.label = label

    @property
    def num_data(self) -> int:
        return self.values.shape[0]

    @property
    def num_columns(self) -> int:
        return self.values.shape[1]


def _get_statistic(line: str) -> Tuple[int, int, int]:
    """Delimiter counts (parser.cpp:10-23)."""
    return line.count(","), line.count("\t"), line.count(":")


def detect_format(lines: List[str]) -> str:
    """CreateParser's format vote (parser.cpp:87-135): statistics from
    the first lines; ':' wins (libsvm), then tab, then comma."""
    if not lines:
        return "tsv"
    comma, tab, colon = _get_statistic(lines[0])
    if len(lines) > 1:
        c2, t2, l2 = _get_statistic(lines[1])
        # require consistency like the reference's two-line check
        if colon > 0 and l2 > 0:
            return "libsvm"
        if tab > 0 and t2 > 0:
            return "tsv"
        if comma > 0 and c2 > 0:
            return "csv"
    if colon > 0:
        return "libsvm"
    if tab > 0:
        return "tsv"
    if comma > 0:
        return "csv"
    # single column of labels / values
    return "tsv"


_NUM_RE = re.compile(r"^\s*$")


def _to_float_array(tokens: np.ndarray) -> np.ndarray:
    """Vectorized str->float with blanks and na/nan as NaN
    (Common::AtofPrecise semantics for our purposes)."""
    low = np.char.lower(np.char.strip(tokens.astype(str)))
    out = np.full(low.shape, np.nan, np.float64)
    bad = (low == "") | (low == "na") | (low == "nan") | (low == "null") \
        | (low == "none") | (low == "?")
    good = ~bad
    if good.any():
        out[good] = low[good].astype(np.float64)
    return out


def parse_delimited(lines: List[str], delim: str,
                    label_idx: int) -> ParsedText:
    """CSV/TSV parse (parser.hpp CSVParser/TSVParser): every column is
    numeric; ``label_idx`` < 0 means no label column in the file."""
    if not lines:
        return ParsedText(np.zeros((0, 0), np.float64), None)
    rows = [ln.rstrip("\r\n").split(delim) for ln in lines]
    width = max(len(r) for r in rows)
    if min(len(r) for r in rows) != width:
        # ragged rows: pad with blanks (reference errors per-row; we warn)
        log.warning("Text file has ragged rows; padding with NaN")
        rows = [r + [""] * (width - len(r)) for r in rows]
    mat = _to_float_array(np.asarray(rows, dtype=object))
    if label_idx >= 0 and width > label_idx:
        label = mat[:, label_idx].astype(np.float32)
        feats = np.delete(mat, label_idx, axis=1)
        return ParsedText(feats, label)
    return ParsedText(mat, None)


def parse_libsvm(lines: List[str], label_idx: int,
                 num_features_hint: int = 0) -> ParsedText:
    """LibSVM parse (parser.hpp LibSVMParser): 'label i:v j:v ...' with
    0-based feature indices, densified to [N, max_idx+1]."""
    labels: List[float] = []
    entries: List[List[Tuple[int, float]]] = []
    max_idx = num_features_hint - 1
    has_label = label_idx >= 0
    for ln in lines:
        toks = ln.split()
        row: List[Tuple[int, float]] = []
        start = 0
        if has_label and toks and ":" not in toks[0]:
            labels.append(float(toks[0]))
            start = 1
        elif has_label:
            labels.append(0.0)
        for tok in toks[start:]:
            if ":" not in tok:
                continue
            i_s, v_s = tok.split(":", 1)
            idx = int(i_s)
            row.append((idx, float(v_s)))
            if idx > max_idx:
                max_idx = idx
        entries.append(row)
    n, c = len(entries), max(max_idx + 1, 0)
    values = np.zeros((n, c), np.float64)
    for r, row in enumerate(entries):
        for idx, v in row:
            values[r, idx] = v
    label = np.asarray(labels, np.float32) if has_label and labels else None
    return ParsedText(values, label)


def infer_label_idx(lines: List[str], fmt: str, num_features: int,
                    label_idx: int) -> int:
    """GetLabelIdxFor{CSV,TSV,Libsvm} (parser.cpp:25-62): when the
    expected feature count is known (prediction on a model with
    max_feature_idx), a file whose rows carry exactly that many columns
    has no label column."""
    if num_features <= 0 or not lines:
        return label_idx
    first = lines[0].strip()
    if fmt == "libsvm":
        pos_space = re.search(r"\s", first)
        pos_colon = first.find(":")
        if pos_space is None or (pos_colon >= 0
                                 and pos_space.start() < pos_colon):
            return label_idx
        return -1
    delim = "\t" if fmt == "tsv" else ","
    if len(first.split(delim)) == num_features:
        return -1
    return label_idx


def _first_data_lines(filename: str, k: int, header: bool,
                      ignore_comments: bool) -> Tuple[List[str], str]:
    """First k data lines + the raw header line (cheap peek)."""
    head = ""
    out: List[str] = []
    header_pending = header
    from .file_io import open_file
    with open_file(filename, "r") as fh:
        for ln in fh:
            t = ln.strip()
            if not t or (ignore_comments and t.startswith("#")):
                continue
            if header_pending:
                head = ln.rstrip("\r\n")
                header_pending = False
                continue
            out.append(ln.rstrip("\r\n"))
            if len(out) >= k:
                break
    return out, head


def parse_file(filename: str, header: bool = False, label_idx: int = 0,
               num_features_hint: int = 0,
               ignore_comments: bool = True) -> Tuple[ParsedText, List[str]]:
    """Parse a text data file; returns (parsed, header_names).

    header_names is empty when ``header`` is False. Comment lines
    starting with '#' and blank lines are skipped (TextReader parity,
    include/LightGBM/utils/text_reader.h). The heavy tokenization runs
    in the native C++ parser (io/native.py, built from csrc/ at first
    use; a failed build raises); format and label detection peek only
    the first lines either way. The Python parser below is the semantic
    oracle, and takes over where the native one declines a file: ragged
    rows, or a format its one-line sniff reads otherwise than the
    two-line detection (a ':' inside a CSV field).
    """
    first, head = _first_data_lines(filename, 2, header,
                                    ignore_comments)
    fmt = detect_format(first)
    label_idx = infer_label_idx(first, fmt, num_features_hint,
                                label_idx)
    names: List[str] = []
    if header and head:
        delim = {"csv": ",", "tsv": "\t"}.get(fmt, "\t")
        names = [t.strip() for t in head.split(delim)]

    from .native import parse_file_native
    native = (parse_file_native(filename, header, label_idx)
              if ignore_comments else None)
    _FMT_CODE = {"tsv": 0, "csv": 1, "libsvm": 2}
    if native is not None and native[2] != _FMT_CODE[fmt]:
        # the native single-line sniff disagrees with the two-line
        # detection (e.g. a ':' inside a CSV field) — trust the python
        # detector and parser
        native = None
    if native is not None:
        values, labels, _ = native
        if fmt == "libsvm" and num_features_hint > values.shape[1]:
            values = np.pad(values, ((0, 0), (0, num_features_hint
                                              - values.shape[1])))
        parsed = ParsedText(values, labels)
    else:
        from .file_io import open_file
        with open_file(filename, "r") as fh:
            raw = fh.read().splitlines()
        lines = [ln for ln in raw if ln.strip()
                 and not (ignore_comments
                          and ln.lstrip().startswith("#"))]
        if header and lines:
            lines.pop(0)
        if fmt == "libsvm":
            parsed = parse_libsvm(lines, label_idx, num_features_hint)
        else:
            delim = "\t" if fmt == "tsv" else ","
            parsed = parse_delimited(lines, delim, label_idx)
    if names and parsed.label is not None \
            and len(names) > parsed.num_columns:
        # drop the label column's name so names align with features
        names.pop(max(label_idx, 0))
    return parsed, names
