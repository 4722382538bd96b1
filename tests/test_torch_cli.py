"""Port parity for the file entry point: the text parser (Python and
native), the loader's column specs and sidecar files, binary dataset
files and the CLI application of lightgbm_tpu_torch (``device="cpu"``)
against the JAX package on the CPU, on the same files made from a seed
(examples/generate_data.py's generators, cut to 1,280 rows).

Bars: parsed values and labels bit-equal; the port's native parser
bit-equal to its Python parser (tests/test_native_parser.py's cases);
loaded sets' bins, mappers and metadata equal; a binary file saved by
either package loads in the other to the same bins and mappers, and the
``.bin`` cache is read on the second load; the CLI's model texts byte-
equal up to the parameters block for binary, regression and multiclass
(lambdarank: the same tree structures and leaf values within 1e-6, its
gradients part from the JAX package's by ulps, tests/test_torch_
objectives.py), result files of leaf indices and SHAP contributions
equal string for string and of probabilities within 1e-5, the refit
task's model equal, the generated C++ byte-equal, the metric lines and
the early-stopping iteration equal. The JAX package lowers its own log level
under ``verbose=-1``, so each test restores both packages' levels.
"""
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from lightgbm_tpu import application as japp
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import dataset as jdataset
from lightgbm_tpu.io.loader import DatasetLoader as JLoader
from lightgbm_tpu.io.parser import parse_file as jparse
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch import application as tapp
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import native
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.loader import DatasetLoader as TLoader
from lightgbm_tpu_torch.io.parser import (parse_delimited, parse_file,
                                          parse_libsvm)
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {"binary_classification": ("binary", None),
            "regression": ("regression", None),
            "multiclass_classification": ("multiclass", None),
            "lambdarank": ("rank", 20)}
ROWS = 1280
SMALL = ["num_trees=3", "num_leaves=15", "max_bin=63", "verbose=-1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_log_levels():
    levels = jlog.get_level(), tlog.get_level()
    yield
    jlog.set_level(levels[0])
    tlog.set_level(levels[1])


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    """examples/generate_data.py's four data sets (seed 7, as its main),
    the first 1,280 rows of each train file (64 whole queries of 20 rows
    for lambdarank), beside copies of the examples' train.conf."""
    root = tmp_path_factory.mktemp("examples")
    spec = importlib.util.spec_from_file_location(
        "generate_data", os.path.join(ROOT, "examples", "generate_data.py"))
    gd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gd)
    gd.HERE = str(root)
    rng = np.random.default_rng(7)
    for make in (gd.binary, gd.regression, gd.multiclass, gd.lambdarank):
        make(rng)
    for ex, (stem, qsize) in EXAMPLES.items():
        d = root / ex
        shutil.copy(os.path.join(ROOT, "examples", ex, "train.conf"), d)
        path = d / f"{stem}.train"
        lines = path.read_text().splitlines(keepends=True)[:ROWS]
        path.write_text("".join(lines))
        if qsize:
            (d / f"{stem}.train.query").write_text(
                f"{qsize}\n" * (ROWS // qsize))
    return root


def _body(text: str) -> str:
    return text[:text.index("\nparameters:")]


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)
    return str(path)


# -- the parser ----------------------------------------------------------------

def _tsv(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 5))
    X[rng.random(X.shape) < 0.05] = np.nan
    y = rng.integers(0, 2, 300)
    rows = ["# a comment"] + [
        "\t".join([f"{y[i]:d}"] + ["na" if np.isnan(v) else f"{v:.17g}"
                                    for v in X[i]]) for i in range(300)]
    return _write(tmp_path / "d.tsv", "\n".join(rows) + "\n"), {}


def _csv_header(tmp_path):
    rng = np.random.default_rng(1)
    X = rng.integers(-50, 50, size=(200, 4))
    rows = ["y,a,b,c,d"] + [",".join(str(v) for v in [i % 3] + list(X[i]))
                           for i in range(200)]
    return (_write(tmp_path / "d.csv", "\n".join(rows) + "\n"),
            {"header": True})


def _libsvm(tmp_path):
    rng = np.random.default_rng(2)
    rows = []
    for i in range(150):
        idx = np.sort(rng.choice(12, rng.integers(1, 6), replace=False))
        rows.append(" ".join([str(i % 2)] + [f"{j}:{rng.normal():.9g}"
                                             for j in idx]))
    return _write(tmp_path / "d.svm", "\n".join(rows) + "\n"), {}


@pytest.mark.parametrize("make", [_tsv, _csv_header, _libsvm],
                         ids=["tsv", "csv_header", "libsvm"])
def test_parse_file_matches_jax(tmp_path, make):
    path, kw = make(tmp_path)
    jp, jn = jparse(path, **kw)
    tp, tn = parse_file(path, **kw)
    assert tn == jn
    assert tp.values.dtype == jp.values.dtype == np.float64
    np.testing.assert_array_equal(tp.values, jp.values)
    np.testing.assert_array_equal(tp.label, jp.label)


# -- the native parser against the Python oracle (test_native_parser.py) ------

def test_native_tsv_parity(tmp_path):
    path, _ = _tsv(tmp_path)
    values, labels, fmt = native.parse_file_native(path, False, 0)
    lines = [ln.rstrip("\n") for ln in open(path) if ln.strip()
             and not ln.startswith("#")]
    ref = parse_delimited(lines, "\t", 0)
    assert fmt == 0
    np.testing.assert_array_equal(values, ref.values)
    np.testing.assert_array_equal(labels, ref.label)


def test_native_csv_header_and_missing(tmp_path):
    p = _write(tmp_path / "d.csv", "y,a,b\n1,0.5,na\n0,NaN,2.25\n1,,3.5\n")
    parsed, names = parse_file(p, header=True, label_idx=0)
    assert names == ["a", "b"]
    np.testing.assert_array_equal(parsed.label, [1, 0, 1])
    assert parsed.values[0, 0] == 0.5 and np.isnan(parsed.values[0, 1])
    assert np.isnan(parsed.values[1, 0]) and np.isnan(parsed.values[2, 0])
    assert parsed.values[2, 1] == 3.5


def test_native_libsvm_parity(tmp_path):
    path, _ = _libsvm(tmp_path)
    values, labels, fmt = native.parse_file_native(path, False, 0)
    ref = parse_libsvm([ln.rstrip("\n") for ln in open(path)], 0)
    assert fmt == 2
    np.testing.assert_array_equal(values, ref.values)
    np.testing.assert_array_equal(labels, ref.label)


def test_native_format_mismatch_falls_back(tmp_path):
    """A ':' inside a CSV field: the two-line detection says csv, the
    native sniff libsvm; the Python parser takes over and refuses the
    token."""
    p = _write(tmp_path / "odd.csv", "1,12:30,2.5\n0,4.0,5.0\n")
    with pytest.raises(ValueError):
        parse_file(p, label_idx=0)


def test_native_ragged_rows_fall_back(tmp_path):
    """Ragged rows (tests/test_native_parser.py:80): the native parser
    declines, the Python parser pads with NaN, as the JAX package's."""
    p = _write(tmp_path / "ragged.csv", "1,2.0\n0,3.0,4.0\n")
    assert native.parse_file_native(p, False, 0) is None
    parsed, _ = parse_file(p, label_idx=0)
    assert parsed.values.shape == (2, 2)
    assert parsed.values[1, 1] == 4.0 and np.isnan(parsed.values[0, 1])
    np.testing.assert_array_equal(parsed.values, jparse(p)[0].values)


def test_native_label_idx_out_of_range(tmp_path):
    """tests/test_native_parser.py:93."""
    p = _write(tmp_path / "d.csv", "1,2\n3,4\n")
    parsed, _ = parse_file(p, label_idx=5)
    assert parsed.values.shape == (2, 2)
    assert parsed.label is None


# -- the loader: column specs, sidecar files, binary files --------------------

def _loaders(params):
    jc, tc = JConfig(), TConfig()
    jc.set(dict(params))
    tc.set(dict(params))
    return JLoader(jc), TLoader(tc, "cpu")


def _same_set(j, t):
    """The JAX set's bins, mappers and metadata equal the port's."""
    np.testing.assert_array_equal(t.bins_t.numpy().T, j.host_bins())
    assert len(t.mappers) == len(j.mappers)
    for a, b in zip(j.mappers, t.mappers):
        da, db = a.to_dict(), b.to_dict()
        # bounds may hold NaN (a NaN bin), which == cannot compare
        np.testing.assert_array_equal(db.pop("bin_upper_bound"),
                                      da.pop("bin_upper_bound"))
        assert db == da
    np.testing.assert_array_equal(t.used_feature_map, j.used_feature_map)
    assert t.feature_names == j.feature_names
    assert t.num_data == j.num_data
    for name in ("label", "weights", "init_score", "query_boundaries"):
        a, b = getattr(j.metadata, name), getattr(t.metadata, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b, a)


def test_column_specs_match_jax(tmp_path):
    """label, weight, group, ignore and categorical columns by name."""
    rng = np.random.default_rng(3)
    n = 400
    rows = ["qid,w,target,a,b,skip,cat"]
    for i in range(n):
        rows.append(",".join(str(v) for v in (
            i // 20, round(float(rng.uniform(0.5, 2)), 3),
            int(rng.integers(0, 3)), round(float(rng.normal()), 5),
            int(rng.integers(0, 40)), 7, int(rng.integers(0, 5)))))
    path = _write(tmp_path / "spec.csv", "\n".join(rows) + "\n")
    params = {"header": "true", "label_column": "name:target",
              "weight_column": "name:w", "group_column": "name:qid",
              "ignore_column": "name:skip", "categorical_feature": "name:cat",
              "max_bin": "63", "min_data_in_leaf": "5"}
    jl, tl = _loaders(params)
    _same_set(jl.load_from_file(path), tl.load_from_file(path))


def test_sidecar_files_match_jax(tmp_path):
    """<file>.weight, <file>.query and <file>.init beside a TSV."""
    rng = np.random.default_rng(4)
    n = 300
    X = rng.normal(size=(n, 4))
    rows = ["\t".join([str(int(rng.integers(0, 4)))]
                      + [f"{v:.17g}" for v in X[i]]) for i in range(n)]
    path = _write(tmp_path / "d.tsv", "\n".join(rows) + "\n")
    _write(path + ".weight", "".join(f"{w:.4f}\n"
                                     for w in rng.uniform(0.5, 2, n)))
    _write(path + ".query", "".join(f"{q}\n" for q in [100, 150, 50]))
    _write(path + ".init", "".join(f"{v:.9g}\n" for v in rng.normal(size=n)))
    jl, tl = _loaders({"max_bin": "63", "min_data_in_leaf": "5"})
    _same_set(jl.load_from_file(path), tl.load_from_file(path))


@pytest.mark.parametrize("max_bin", [15, 63], ids=["nibble_packed",
                                                    "bytes"])
def test_binary_file_loads_in_both_packages(tmp_path, max_bin):
    """A .bin saved by the JAX package loads in the port to the same
    bins, mappers and metadata, and the other way round (max_bin 15: the
    v2 file's nibble-packed 4-bit columns)."""
    path, _ = _tsv(tmp_path)
    jl, tl = _loaders({"max_bin": str(max_bin), "min_data_in_leaf": "5"})
    j = jl.load_from_file(path)
    t = tl.load_from_file(path)
    _same_set(j, t)
    j.save_binary(str(tmp_path / "jax.bin"))
    t.save_binary(str(tmp_path / "port.bin"))
    assert BinnedDataset.is_binary_file(str(tmp_path / "jax.bin"))
    cfg = TConfig()
    _same_set(j, BinnedDataset.load_binary(str(tmp_path / "jax.bin"), cfg,
                                           "cpu"))
    _same_set(jdataset.TpuDataset.load_binary(str(tmp_path / "port.bin"),
                                              JConfig()), t)
    with open(tmp_path / "jax.bin", "rb") as a, \
            open(tmp_path / "port.bin", "rb") as b:
        assert a.read() == b.read()


def test_binary_cache_is_read_on_the_second_load(tmp_path):
    """``save_binary=true`` writes <file>.bin; the next load reads it
    (the text file is unreadable by then) and gives the same set."""
    path, _ = _tsv(tmp_path)
    tl = _loaders({"save_binary": "true", "max_bin": "63"})[1]
    first = tl.load_from_file(path)
    assert BinnedDataset.is_binary_file(path + ".bin")
    _write(path, "not a data file\n")
    second = tl.load_from_file(path)
    np.testing.assert_array_equal(second.bins_t.numpy(),
                                  first.bins_t.numpy())
    np.testing.assert_array_equal(second.metadata.label,
                                  first.metadata.label)


# -- the CLI ------------------------------------------------------------------

def _run(pkg, args):
    if pkg is tapp:
        tapp.main(args, device="cpu")
    else:
        japp.main(args)


def _structure(text):
    keep = ("split_feature", "left_child", "right_child", "num_leaves")
    return [ln for ln in text.splitlines() if ln.split("=")[0] in keep]


def _leaf_values(text):
    return np.concatenate([
        np.array(ln.split("=")[1].split(), float)
        for ln in text.splitlines() if ln.startswith("leaf_value=")])


@pytest.mark.parametrize("example", list(EXAMPLES))
def test_cli_tasks_match_jax(examples, tmp_path, example):
    """train, predict (probabilities, leaf indices, SHAP contributions),
    refit and convert_model through both packages' Application on the
    example's config (paths relative to it). The result files of leaf
    indices and contributions are equal string for string; the
    probabilities' values within 1e-5 (the JAX package converts in f32,
    the port in float64, so the sixth digit of ``f"{v:g}"`` can part)."""
    conf = str(examples / example / "train.conf")
    stem = EXAMPLES[example][0]
    data = str(examples / example / f"{stem}.train")
    test = str(examples / example / f"{stem}.test")
    got = {"jax": {}, "port": {}}
    for name, pkg in (("jax", japp), ("port", tapp)):
        out = got[name]
        model = str(tmp_path / f"{name}_model.txt")
        _run(pkg, [f"config={conf}", f"output_model={model}"] + SMALL)
        out["text"] = open(model).read()
        for kind, flag in (("pred", []), ("leaf", ["predict_leaf_index=true"]),
                           ("contrib", ["predict_contrib=true"])):
            res = str(tmp_path / f"{name}_{kind}.txt")
            _run(pkg, ["task=predict", f"data={test}", f"input_model={model}",
                       f"output_result={res}", "verbose=-1"] + flag)
            out[kind] = open(res).read().splitlines()
        refit = str(tmp_path / f"{name}_refit.txt")
        _run(pkg, [f"config={conf}", "task=refit", f"data={data}",
                   f"input_model={model}", f"output_model={refit}"] + SMALL)
        out["refit"] = open(refit).read()
        cpp = str(tmp_path / f"{name}.cpp")
        _run(pkg, ["task=convert_model", f"input_model={model}",
                   f"convert_model={cpp}", "verbose=-1"])
        out["cpp"] = open(cpp).read()
    j, t = got["jax"], got["port"]

    def values(lines):
        return np.array([[float(v) for v in ln.split("\t")] for ln in lines])

    np.testing.assert_allclose(values(t["pred"]), values(j["pred"]),
                               rtol=0, atol=1e-5)
    assert t["pred"] == [("\t".join(f"{v:g}" for v in row))
                         for row in values(t["pred"])]
    if example == "lambdarank":
        assert _structure(t["text"]) == _structure(j["text"])
        np.testing.assert_allclose(_leaf_values(t["text"]),
                                   _leaf_values(j["text"]), rtol=0,
                                   atol=1e-6)
        assert t["leaf"] == j["leaf"]
        return
    assert _body(t["text"]) == _body(j["text"])
    assert t["leaf"] == j["leaf"]
    assert t["contrib"] == j["contrib"]
    assert _body(t["refit"]) == _body(j["refit"])
    assert t["cpp"] == j["cpp"]


def test_cli_metric_lines_and_early_stop_match_jax(tmp_path, capsys):
    """A noisy binary set with a valid set and early_stopping_round 3:
    the same "Iteration:" metric lines, the same stop and the same model
    file."""
    rng = np.random.default_rng(5)
    for name, n in (("train.tsv", 900), ("valid.tsv", 300)):
        X = rng.normal(size=(n, 5))
        y = (X[:, 0] + rng.normal(0, 2.0, n) > 0).astype(int)
        _write(tmp_path / name, "".join(
            "\t".join([str(y[i])] + [f"{v:.17g}" for v in X[i]]) + "\n"
            for i in range(n)))
    conf = _write(tmp_path / "es.conf", "\n".join([
        "task = train", "objective = binary", "metric = auc,binary_logloss",
        "data = train.tsv", "valid_data = valid.tsv", "num_trees = 40",
        "learning_rate = 0.3", "num_leaves = 15", "max_bin = 63",
        "early_stopping_round = 3", "is_training_metric = true",
        "verbose = 1"]) + "\n")
    lines, texts = [], []
    for name, pkg in (("jax", japp), ("port", tapp)):
        model = str(tmp_path / f"{name}.txt")
        capsys.readouterr()
        _run(pkg, [f"config={conf}", f"output_model={model}"])
        err = capsys.readouterr().err
        # from the metric or stop message on: the JAX package prefixes
        # its run context ("[t+4.3s it=16] ")
        lines.append([ln[min(i for i in (ln.find("Iteration:"),
                                          ln.find("Early stopping"))
                             if i >= 0):]
                      for ln in err.splitlines()
                      if "Iteration:" in ln or "Early stopping" in ln])
        texts.append(open(model).read())
    assert any("Early stopping" in ln for ln in lines[0])
    assert lines[1] == lines[0]
    assert _body(texts[1]) == _body(texts[0])


def test_cli_runs_on_the_card_by_default(examples):
    """Without ``device``, the CLI runs on cuda:0 and raises where there
    is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    conf = str(examples / "binary_classification" / "train.conf")
    with pytest.raises(tlog.LightGBMError, match="CUDA"):
        tapp.main([f"config={conf}", "verbose=-1"])
