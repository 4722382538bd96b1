"""Port parity for the streamed device ingest (lightgbm_tpu_torch/io/
ingest.py) against the JAX package's (lightgbm_tpu/io/ingest.py) and the
port's one-copy route, on the CPU.

What is held, and to which bar:
- the streamed ``[F, N]`` bins (``tpu_ingest=1``, chunks small enough to
  leave a tail) bit-equal to the JAX package's ``DeviceBinner`` bins
  under ``tpu_ingest=1`` and to the port's one-copy route
  (``tpu_ingest=0``): float32 and float64 matrices with NaN, zeros, the
  ±kZeroThreshold crossing and a categorical column; ``zero_as_missing``;
  the int32 tier at ``max_bin`` > 256; values on and one ulp beside each
  bin bound; unseen, NaN and negative categories; a valid set;
- ``prefetch``: a chunk that fails after its retries raises
  ``PrefetchError`` naming it; a transient failure recovers in place;
- ``SparseDeviceBinner``: the entries, in order, of the one-upload
  ``SparseEntries``; its [F, N] bins and its entries equal to the JAX
  package's ``SparseDeviceBinner``'s (the JAX coordinates sorted by
  feature and row, sentinel entries dropped); it runs only under
  ``tpu_ingest=1``, the default being the one upload on a card too;
- each ingest knob moves the route (a counter) and leaves the bins
  equal: ``tpu_ingest``, ``tpu_ingest_chunk_rows``, ``two_round``,
  ``tpu_out_of_core``, ``tpu_ooc_block_rows``; the one-copy routes count
  their rows apart from the rows binned on the host;
- training on streamed bins: model text byte-equal to the one-copy
  route's.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import ingest as ting
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.io.sparse import SparseMatrix as TSparse
from lightgbm_tpu_torch.obs import registry as tobs
from lightgbm_tpu_torch.utils import faults as tfaults

try:
    import jax
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Metadata as JMeta
    from lightgbm_tpu.io.dataset import TpuDataset
    from lightgbm_tpu.io.sparse import SparseMatrix as JSparse
except ImportError:          # on the card's machine
    jax = None

pytestmark = pytest.mark.torch_port

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(ingest, chunk=0, **kw):
    p = {"objective": "regression", "max_bin": 63, "min_data_in_leaf": 20,
         "enable_bundle": False, "tpu_ingest": ingest,
         "tpu_ingest_chunk_rows": chunk, "verbose": -1}
    p.update(kw)
    return p


def _port(X, params, categorical=()):
    return BinnedDataset(TConfig().set(dict(params)), "cpu") \
        .construct_from_matrix(np.asarray(X), Metadata(
            label=np.zeros(len(X), np.float32)), categorical=categorical)


def _jax_dev_bins(X, params, categorical=()):
    ds = TpuDataset(JConfig().set(dict(params))).construct_from_matrix(
        np.asarray(X), JMeta(label=np.zeros(len(X), np.float32)),
        categorical=categorical)
    assert ds.bins_t_dev is not None, "the JAX device ingest did not engage"
    return np.asarray(ds.bins_t_dev)[:, :len(X)]


def _check(X, params=None, categorical=(), chunk=257):
    """The streamed bins against the port's one-copy route and the JAX
    package's device binner."""
    params = params or {}
    rows0 = tobs.counter("ingest/rows_device").value
    streamed = _port(X, _params(1, chunk, **params), categorical)
    assert tobs.counter("ingest/rows_device").value - rows0 == len(X)
    one_copy = _port(X, _params(0, **params), categorical)
    assert streamed.bins_t.dtype == one_copy.bins_t.dtype
    assert torch.equal(streamed.bins_t, one_copy.bins_t)
    if jax is not None:
        np.testing.assert_array_equal(
            streamed.bins_t.numpy(),
            _jax_dev_bins(X, _params(1, chunk, **params), categorical))
    return streamed


def nasty_matrix(n=1601, seed=0):
    """Every BinMapper edge case in one matrix: continuous, NaN, zero
    heavy, the -0.0 / kZeroThreshold crossing, a categorical column and
    a column of three values (tests/test_ingest.py's)."""
    r = np.random.default_rng(seed)
    zero_cross = np.concatenate([
        [-0.0, 0.0, 1e-36, -1e-36, 5e-324, -5e-324, 1e-35, -1e-35,
         np.nextafter(1e-35, 1), np.nextafter(-1e-35, -1)],
        r.normal(size=n - 10) * 1e-30])
    return np.column_stack([
        r.normal(size=n),
        np.where(r.uniform(size=n) < 0.15, np.nan, r.normal(size=n)),
        np.where(r.uniform(size=n) < 0.5, 0.0, r.normal(size=n)),
        r.integers(0, 9, n).astype(np.float64),      # categorical
        zero_cross,
        r.integers(0, 3, n).astype(np.float64),
    ])


# -- binning parity ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nasty_matrix_bit_identical(dtype):
    _check(nasty_matrix().astype(dtype), categorical=[3])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_zero_as_missing(dtype):
    _check(nasty_matrix(seed=1).astype(dtype),
           params={"zero_as_missing": True})


def test_int32_tier():
    X = np.random.default_rng(2).normal(size=(1500, 3))
    ds = _check(X, params={"max_bin": 500, "min_data_in_bin": 1})
    assert ds.bins_t.dtype == torch.int32


def test_values_at_bin_boundaries():
    """Values on each bound and one ulp either side: where a rounded
    comparison would part."""
    base = np.random.default_rng(3).normal(size=1200)
    ds = _port(base[:, None], _params(0))
    b = ds.mappers[0].bin_upper_bound[:-1]
    adv = np.concatenate([b, np.nextafter(b, -np.inf),
                          np.nextafter(b, np.inf), base])
    _check(adv[:, None])
    _check(adv[:, None].astype(np.float32))


def test_unseen_and_negative_categories():
    n = 1200
    r = np.random.default_rng(4)
    col = r.integers(0, 5, n).astype(np.float64)
    col[::7] = 99.0
    col[::11] = np.nan
    col[::13] = -3.0
    X = np.column_stack([col, r.normal(size=n)])
    ds = _check(X, categorical=[0])
    # categories the mappers never saw, read into a valid set
    Xv = X.copy()
    Xv[::3, 0] = 1234.0
    Xv[1::5, 0] = -7.5
    one_copy = _port(X, _params(0), [0])
    assert torch.equal(
        ds.create_valid(Xv, Metadata(label=np.zeros(n))).bins_t,
        one_copy.create_valid(Xv, Metadata(label=np.zeros(n))).bins_t)


def test_multi_chunk_tail():
    """Chunking is invisible: an odd row count, chunks smaller than the
    matrix, a partly filled tail."""
    X = np.random.default_rng(5).normal(size=(999, 4)).astype(np.float32)
    c0 = tobs.counter("ingest/h2d_chunks").value
    b0 = tobs.counter("ingest/h2d_bytes").value
    _check(X, chunk=123)
    assert tobs.counter("ingest/h2d_chunks").value - c0 == 9
    # only the used columns cross, in the matrix's own dtype
    assert tobs.counter("ingest/h2d_bytes").value - b0 == X.nbytes \
        + X.nbytes        # the one-copy route's upload of the whole matrix


def test_create_valid_streams_the_reference_mappers():
    r = np.random.default_rng(8)
    X = r.normal(size=(1000, 4))
    ds = _port(X, _params(1, 300))
    Xv = r.normal(size=(500, 4))
    rows0 = tobs.counter("ingest/rows_device").value
    vd = ds.create_valid(Xv, Metadata(label=np.zeros(500)))
    assert tobs.counter("ingest/rows_device").value - rows0 == 500
    assert vd.mappers is ds.mappers
    ref = _port(X, _params(0))
    assert torch.equal(
        vd.bins_t, ref.create_valid(Xv, Metadata(label=np.zeros(500))).bins_t)


# -- the pipeline ----------------------------------------------------------------------

@pytest.fixture
def _faults():
    yield tfaults
    tfaults.clear()


def test_prefetch_error_names_the_chunk(_faults):
    """A persistent failure of chunk 2's preparation surfaces as a
    PrefetchError naming it; a transient one is retried in place."""
    X = np.random.default_rng(6).normal(size=(1000, 3))
    _faults.configure("ingest.prep@3")
    with pytest.raises(ting.PrefetchError, match="chunk 2 failed") as ei:
        _port(X, _params(1, 200))
    assert isinstance(ei.value.__cause__, tfaults.InjectedFault)
    _faults.clear()
    _faults.configure("ingest.prep@2:transient")
    ds = _port(X, _params(1, 200))
    assert torch.equal(ds.bins_t, _port(X, _params(0)).bins_t)


def test_prefetch_yields_in_order_with_bounded_lookahead():
    started = []

    def thunk(i):
        def run():
            started.append(i)
            return i
        return run

    out = []
    for v in ting.prefetch((thunk(i) for i in range(7)), depth=2):
        # when result v is in hand, at most v + 2 thunks have started
        assert len(started) <= v + 2
        out.append(v)
    assert out == list(range(7))


def test_ingest_enabled_gate():
    cfg = TConfig()
    assert not ting.ingest_enabled(cfg, "cpu")
    assert ting.ingest_enabled(cfg, torch.device("cuda", 0))
    assert ting.ingest_enabled(TConfig().set({"tpu_ingest": 1}), "cpu")
    assert not ting.ingest_enabled(TConfig().set({"tpu_ingest": 0}),
                                   torch.device("cuda", 0))


# -- CSR -------------------------------------------------------------------------------

def _csr(n, f, density, seed):
    r = np.random.default_rng(seed)
    mask = r.uniform(size=(n, f)) < density
    vals = np.where(mask, r.normal(size=(n, f)), 0.0)
    vals[mask & (r.uniform(size=(n, f)) < 0.05)] = np.nan
    indptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
    cols = np.nonzero(mask)[1]
    return indptr, cols, vals[mask], vals


@pytest.mark.parametrize("chunk", [0, 97])
def test_sparse_binner_matches_entries_and_jax(chunk):
    n, f = 2000, 12
    indptr, cols, data, dense = _csr(n, f, 0.08, 9)
    data = data.copy()
    cols = cols.copy()
    # a constant column is trivial and dropped: its entries must be too
    cols[cols == 4] = 5
    p = _params(1, chunk, sparse_threshold=0.5)
    sm = TSparse.from_csr(indptr, cols, data, f)
    ds = BinnedDataset(TConfig().set(dict(p)), "cpu").construct_from_matrix(
        sm, Metadata(label=np.zeros(n)))
    binner = ting.SparseDeviceBinner(ds.mappers, ds.used_feature_map,
                                     ds.config, "cpu")
    codes, rows, feat, bounds = binner.bin_entries(sm)
    from lightgbm_tpu_torch.io.dataset import SparseEntries
    ref = SparseEntries.upload(sm, ds.mappers, ds.used_feature_map, "cpu")
    np.testing.assert_array_equal(bounds, ref.bounds)
    for a, b in ((codes, ref.codes), (rows, ref.rows), (feat, ref.feat)):
        assert torch.equal(a, b)
    # the set built on the streamed entries: its bins are the one-copy's
    one = BinnedDataset(TConfig().set(dict(_params(0, sparse_threshold=0.5))),
                        "cpu").construct_from_matrix(
        sm, Metadata(label=np.zeros(n)))
    assert torch.equal(ds.bins_t, one.bins_t)
    if jax is None:
        return
    from lightgbm_tpu.io.ingest import SparseDeviceBinner as JBinner
    jcfg = JConfig().set(dict(p))
    jds = TpuDataset(jcfg).construct_from_matrix(
        JSparse.from_csr(indptr, cols, data, f),
        JMeta(label=np.zeros(n, np.float32)))
    np.testing.assert_array_equal(jds.used_feature_map, ds.used_feature_map)
    jb, (jc, jf, jr) = JBinner(jds.mappers, jds.used_feature_map,
                               jcfg).bin_matrix_sparse(
        JSparse.from_csr(indptr, cols, data, f), want_coords=True)
    np.testing.assert_array_equal(ds.bins_t.numpy(), np.asarray(jb)[:, :n])
    jc, jf, jr = (np.asarray(a) for a in (jc, jf, jr))
    keep = jf < len(ds.mappers)
    order = np.lexsort((jr[keep], jf[keep]))
    np.testing.assert_array_equal(feat.numpy(), jf[keep][order])
    np.testing.assert_array_equal(rows.numpy(), jr[keep][order])
    np.testing.assert_array_equal(codes.numpy(), jc[keep][order])


def test_sparse_ingest_gate():
    """The streamed sparse route only where ``tpu_ingest=1`` forces it:
    the default keeps the one upload on a card too."""
    assert not ting.sparse_ingest_enabled(TConfig())
    assert not ting.sparse_ingest_enabled(TConfig().set({"tpu_ingest": 0}))
    assert ting.sparse_ingest_enabled(TConfig().set({"tpu_ingest": 1}))


@pytest.mark.parametrize("ingest", [-1, 0, 1])
def test_sparse_route_counters(ingest):
    """A CSR set's rows are counted by the route that binned them: the
    one upload (``ingest/rows_one_copy``) unless ``tpu_ingest=1`` streams
    them (``ingest/rows_device``); none is counted as binned on the host,
    and the bins are equal either way."""
    n, f = 1500, 10
    indptr, cols, data, _ = _csr(n, f, 0.1, 21)
    sm = TSparse.from_csr(indptr, cols, data, f)
    c = tobs.counter
    before = {k: c(k).value for k in ("ingest/rows_one_copy",
                                      "ingest/rows_device",
                                      "ingest/rows_host")}
    ds = BinnedDataset(TConfig().set(dict(_params(
        ingest, 97, sparse_threshold=0.5))), "cpu").construct_from_matrix(
        sm, Metadata(label=np.zeros(n)))
    moved = {k: c(k).value - v for k, v in before.items()}
    streamed = ingest == 1
    assert moved == {"ingest/rows_one_copy": 0 if streamed else n,
                     "ingest/rows_device": n if streamed else 0,
                     "ingest/rows_host": 0}, moved
    ref = BinnedDataset(TConfig().set(dict(_params(
        0, sparse_threshold=0.5))), "cpu").construct_from_matrix(
        sm, Metadata(label=np.zeros(n)))
    assert torch.equal(ds.bins_t, ref.bins_t)


def test_dense_one_copy_rows_counted_apart():
    """The dense one-copy route bins on the device: its rows go to
    ``ingest/rows_one_copy``, not to ``ingest/rows_host``."""
    X = np.random.default_rng(22).normal(size=(700, 4))
    c = tobs.counter
    o0, h0, d0 = (c("ingest/rows_one_copy").value,
                  c("ingest/rows_host").value, c("ingest/rows_device").value)
    _port(X, _params(0))
    assert c("ingest/rows_one_copy").value - o0 == 700
    assert c("ingest/rows_host").value == h0
    assert c("ingest/rows_device").value == d0


# -- the knobs move the route ----------------------------------------------------------

def _write_tsv(path, X, y):
    with open(path, "w") as fh:
        for i in range(len(y)):
            fh.write("\t".join([str(int(y[i]))]
                               + [repr(float(v)) for v in X[i]]) + "\n")


def _load(path, **kw):
    from lightgbm_tpu_torch.io.loader import DatasetLoader
    p = {"objective": "binary", "max_bin": 63, "verbose": -1}
    p.update(kw)
    return DatasetLoader(TConfig().set(p), "cpu").load_from_file(str(path))


@pytest.mark.parametrize("knob", ["tpu_ingest", "tpu_ingest_chunk_rows",
                                  "two_round", "tpu_out_of_core",
                                  "tpu_ooc_block_rows"])
def test_ingest_knobs_change_the_route(knob, tmp_path):
    """Each knob that was accepted and ignored now moves a counter, and
    the bins stay equal."""
    r = np.random.default_rng(12)
    X = r.normal(size=(900, 5))
    y = (X[:, 0] > 0).astype(float)
    c = tobs.counter
    path = tmp_path / "d.tsv"
    _write_tsv(path, X, y)
    names = {"tpu_ingest": "ingest/rows_device",
             "tpu_ingest_chunk_rows": "ingest/h2d_chunks",
             "two_round": "loader/two_round_rows",
             "tpu_out_of_core": "ingest/rows_device",
             "tpu_ooc_block_rows": "ooc/blocks"}
    settings = {"tpu_ingest": ({"tpu_ingest": 0}, {"tpu_ingest": 1}),
                "tpu_ingest_chunk_rows": (
                    {"tpu_ingest": 1},
                    {"tpu_ingest": 1, "tpu_ingest_chunk_rows": 100}),
                "two_round": ({}, {"two_round": True}),
                "tpu_out_of_core": (
                    {"two_round": True, "tpu_ingest": 1,
                     "tpu_out_of_core": 0},
                    {"two_round": True, "tpu_ingest": 1}),
                "tpu_ooc_block_rows": (
                    {"two_round": True},
                    {"two_round": True, "tpu_ooc_block_rows": 100})}[knob]
    moved, bins = [], []
    for s in settings:
        v0 = c(names[knob]).value
        bins.append(_load(path, **s).bins_t)
        moved.append(c(names[knob]).value - v0)
    assert moved[1] > moved[0], (knob, moved)
    assert torch.equal(bins[0], bins[1])


def test_training_same_trees():
    """Trees grown on streamed bins are the one-copy route's."""
    import lightgbm_tpu_torch as lgt
    r = np.random.default_rng(13)
    X = r.normal(size=(2000, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1}
    texts = [lgt.train({**p, "tpu_ingest": t, "tpu_ingest_chunk_rows": 300},
                       lgt.Dataset(X, label=y), 5,
                       device="cpu").model_to_string().split("parameters:")[0]
             for t in (0, 1)]
    assert texts[0] == texts[1]
