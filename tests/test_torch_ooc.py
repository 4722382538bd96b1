"""Port parity for two-round (out-of-core) file loading
(lightgbm_tpu_torch/io/loader.py ``_load_two_round``) against the port's
one-round route and the JAX package's ``_load_two_round``, on the CPU.

What is held, and to which bar:
- bins, mappers and metadata (label, weights, query boundaries) equal
  to the one-round route's and to the JAX package's two-round route's,
  on a TSV, a CSV with a header and weight and query-id columns, and a
  libsvm file; under ``tpu_out_of_core`` 1 (blocks streamed into the
  device binner, ``tpu_ingest=1``) and 0 (host bins); at small
  ``tpu_ooc_block_rows``;
- with fewer ``bin_construct_sample_cnt`` than rows, the one-round
  route's bins (the mappers' sample is the one-round route's; the JAX
  package's reservoir sample is another, so it is not compared there);
- a valid set read in two rounds: its reference's mappers, never derived
  again, and the bins of ``create_valid``;
- model text trained from a two-round load byte-equal to the one-round
  route's and to the JAX package's from its two-round load;
- the ooc counters: blocks, the text's bytes, the peak RSS gauge.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.loader import DatasetLoader
from lightgbm_tpu_torch.obs import registry as tobs

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.loader import DatasetLoader as JLoader

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = {"objective": "binary", "max_bin": 63, "min_data_in_leaf": 10,
        "enable_bundle": "false", "verbose": "-1"}


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)
    return str(path)


def _tsv(tmp_path, n=1100, seed=0, name="d.tsv"):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 5))
    X[::9, 1] = np.nan
    y = (X[:, 0] > 0).astype(int)
    return _write(tmp_path / name, "".join(
        "\t".join([str(y[i])] + [repr(float(v)) for v in X[i]]) + "\n"
        for i in range(n)))


def _csv_header(tmp_path, n=900, seed=1):
    """A header, a query-id and a weight column beside the label."""
    r = np.random.default_rng(seed)
    rows = ["qid,w,target,a,b,c"]
    for i in range(n):
        rows.append(",".join(str(v) for v in (
            i // 30, round(float(r.uniform(0.5, 2)), 3),
            int(r.integers(0, 3)), repr(float(r.normal())),
            int(r.integers(0, 40)), repr(float(r.uniform())))))
    return _write(tmp_path / "d.csv", "\n".join(rows) + "\n")


CSV_COLS = {"header": "true", "label_column": "name:target",
            "weight_column": "name:w", "group_column": "name:qid"}


def _libsvm(tmp_path, n=700, seed=2):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 6))
    y = (X[:, 0] > 0).astype(int)
    lines = []
    for i in range(n):
        feats = " ".join(f"{j}:{X[i, j]:.6g}" for j in range(6)
                         if abs(X[i, j]) > 0.3)
        lines.append(f"{y[i]} {feats}")
    return _write(tmp_path / "d.svm", "\n".join(lines) + "\n")


FILES = {"tsv": (_tsv, {}), "csv_header": (_csv_header, CSV_COLS),
         "libsvm": (_libsvm, {})}


def _port(path, **kw):
    p = {**BASE, **kw}
    return DatasetLoader(TConfig().set(p), "cpu").load_from_file(path)


def _jax(path, **kw):
    p = {**BASE, **kw}
    return JLoader(JConfig().set(p)).load_from_file(path)


def _same_meta(a, b):
    for name in ("label", "weights", "init_score", "query_boundaries"):
        x, z = getattr(a.metadata, name), getattr(b.metadata, name)
        assert (x is None) == (z is None), name
        if x is not None:
            np.testing.assert_array_equal(x, z)


@pytest.mark.parametrize("ooc", [1, 0])
@pytest.mark.parametrize("fmt", list(FILES))
def test_two_round_matches_one_round_and_jax(fmt, ooc, tmp_path):
    make, cols = FILES[fmt]
    path = make(tmp_path)
    one = _port(path, **cols)
    two = _port(path, two_round="true", tpu_ingest=1, tpu_out_of_core=ooc,
                tpu_ingest_chunk_rows=256, tpu_ooc_block_rows=300, **cols)
    assert torch.equal(two.bins_t, one.bins_t)
    assert two.feature_names == one.feature_names
    np.testing.assert_array_equal(two.used_feature_map, one.used_feature_map)
    _same_meta(two, one)
    j = _jax(path, two_round="true", **cols)
    np.testing.assert_array_equal(two.bins_t.numpy().T, j.bins)
    for a, b in zip(two.mappers, j.mappers):
        assert a.feature_info() == b.feature_info()
    _same_meta(two, j)


def test_streamed_blocks_move_the_device_counters(tmp_path):
    """tpu_out_of_core=1 streams every row through the device binner and
    counts the text's bytes; 0 bins on the host."""
    path = _tsv(tmp_path)
    c = tobs.counter
    d0, h0 = c("ingest/rows_device").value, c("ingest/rows_host").value
    b0 = c("ooc/disk_bytes").value
    _port(path, tpu_out_of_core=1, tpu_ingest=1)
    assert c("ingest/rows_device").value - d0 == 1100
    import os
    assert c("ooc/disk_bytes").value - b0 == os.path.getsize(path)
    assert (tobs.gauge("ooc/rss_peak_mb").value or 0) > 0
    h1 = c("ingest/rows_host").value
    _port(path, two_round="true", tpu_ingest=1, tpu_out_of_core=0)
    assert c("ingest/rows_host").value - h1 == 1100
    assert h1 == h0


@pytest.mark.parametrize("block_rows", [64, 1000])
def test_block_rows_knob(block_rows, tmp_path):
    path = _tsv(tmp_path, n=640)
    b0 = tobs.counter("ooc/blocks").value
    small = _port(path, tpu_out_of_core=1, tpu_ooc_block_rows=block_rows)
    assert tobs.counter("ooc/blocks").value - b0 == -(-640 // block_rows)
    assert torch.equal(small.bins_t, _port(path).bins_t)


def test_sample_is_the_one_round_sample(tmp_path):
    """More rows than ``bin_construct_sample_cnt``: the mappers come from
    the one-round route's row sample."""
    path = _tsv(tmp_path, n=1500, seed=5)
    one = _port(path, bin_construct_sample_cnt=400)
    two = _port(path, two_round="true", bin_construct_sample_cnt=400,
                tpu_ingest=1, tpu_ooc_block_rows=128)
    for a, b in zip(one.mappers, two.mappers):
        assert a.feature_info() == b.feature_info()
    assert torch.equal(two.bins_t, one.bins_t)


def test_valid_set_uses_the_reference_mappers(tmp_path, monkeypatch):
    path = _tsv(tmp_path)
    vpath = _tsv(tmp_path, n=400, seed=7, name="valid.tsv")
    train = _port(path, two_round="true", tpu_ingest=1)
    import lightgbm_tpu_torch.io.loader as lmod

    def boom(*a, **k):
        raise AssertionError("a valid set derived its own mappers")

    monkeypatch.setattr(lmod, "find_column_mappers", boom)
    cfg = TConfig().set({**BASE, "two_round": "true", "tpu_ingest": 1})
    v = DatasetLoader(cfg, "cpu").load_from_file(vpath, reference=train)
    assert v.mappers is train.mappers
    monkeypatch.undo()
    ref = _port(path)
    vr = DatasetLoader(TConfig().set(dict(BASE)), "cpu").load_from_file(
        vpath, reference=ref)
    assert torch.equal(v.bins_t, vr.bins_t)


@pytest.mark.parametrize("fmt", ["tsv", "csv_header"])
def test_model_text_matches_one_round_and_jax(fmt, tmp_path):
    make, cols = FILES[fmt]
    path = make(tmp_path)
    p = {**BASE, **cols, "num_leaves": 15, "enable_bundle": "true"}
    if fmt == "csv_header":
        p["objective"] = "lambdarank"
    two = {**p, "two_round": "true", "tpu_ooc_block_rows": 256}

    def body(b):
        return b.model_to_string().split("parameters:")[0]

    t2 = lgt.train(two, lgt.Dataset(path, params=two), 5, device="cpu")
    t1 = lgt.train(p, lgt.Dataset(path, params=p), 5, device="cpu")
    j2 = lgb.train(two, lgb.Dataset(path, params=two), 5)
    assert body(t2) == body(t1)
    assert body(t2) == body(j2)
