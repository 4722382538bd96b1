"""Port parity for the sparse (CSR/CSC) route: lightgbm_tpu_torch against
lightgbm_tpu on the CPU.

What is held, and to which bar:
- ``SparseMatrix`` from CSR (duplicates: the last wins), CSC and scipy
  matrices: the JAX package's arrays, equal; chunked rows, ``take_rows``
  and ``to_dense`` equal;
- the mappers sampled from CSR (``find_column_mappers_sparse``, copied):
  equal to the JAX package's, ``to_dict`` for ``to_dict``, and to the
  densified input's;
- the bins of the sparse route, binned on the device from the explicit
  entries: cell for cell the JAX package's ``host_bins_from_sparse``,
  over NaN, values either side of ±kZeroThreshold and a categorical
  column whose category 0 has no bin of its own; ``route_sparse`` on
  either side of ``sparse_threshold``; a 1%-density set builds no
  [N, F] host array (``to_dense`` banned, the host's allocation peak
  under a uint8 [N, F]);
- ``wave_histogram_sparse`` against the JAX package's: bit for bit on
  the CPU in f32 (the serial scatter order of XLA's CPU scatter) and in
  the int8 tier (integer sums, dequantized as the dense tier);
- training: sparse input with EFB (default parameters) and without, the
  f32 sparse tier forced (``tpu_sparse=1``) and the int8 tier with exact
  counts, where the auto rule takes the sparse tier: model texts byte-
  equal to the JAX package's, and the int8 sparse tier's text equal to
  the port's dense int8 text (``tpu_sparse=0``); under EFB the bar of
  tests/test_torch_efb.py (``assert_bundled_texts_match``);
- the five CSR/CSC C entry points (``LGBM_DatasetCreateFromCSR``,
  ``...FromCSC``, ``LGBM_DatasetPushRowsByCSR``,
  ``LGBM_BoosterPredictForCSR``, ``...ForCSC``) and ``Booster.predict``
  on a scipy matrix: model texts equal to the JAX C API's, predictions
  within 1e-5 of its (the JAX package converts in f32) and bit-equal to
  the port's dense predictions; chunked prediction bit-equal to one
  chunk.
"""
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import sparse as tsp
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.ops import hist_wave as thw
from lightgbm_tpu_torch.utils import log as tlog

try:
    import jax.numpy as jnp
    import lightgbm_tpu as lgb
    from lightgbm_tpu import capi as jcapi
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io import sparse as jsp
    from lightgbm_tpu.ops import hist_wave as jhw
    from lightgbm_tpu.utils import log as jlog
except ImportError:          # on the card's machine: the card test only
    jsp = None

pytestmark = pytest.mark.torch_port

needs_jax = pytest.mark.skipif(jsp is None, reason="needs the JAX package")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small PyTorch ops: one thread each under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_log_levels():
    """verbose=-1 lowers either package's process-wide log level."""
    levels = (jlog.get_level() if jsp is not None else None,
              tlog.get_level())
    yield
    if jsp is not None:
        jlog.set_level(levels[0])
    tlog.set_level(levels[1])


def body(text: str) -> str:
    return text.split("parameters:")[0]


def sparse_task(n=3_000, f=18, density=0.05, seed=0, cat_col=None,
                nan_frac=0.0, tiny_col=None):
    """(dense X, scipy CSR, y) with the binning edge cases on demand: a
    categorical column, NaN entries, values either side of
    ±kZeroThreshold (the JAX package's tests/test_sparse.py maker)."""
    r = np.random.default_rng(seed)
    mask = r.uniform(size=(n, f)) < density
    X = np.where(mask, r.normal(size=(n, f)) * 2, 0.0)
    if cat_col is not None:
        X[:, cat_col] = np.where(mask[:, cat_col],
                                 r.integers(0, 7, n).astype(float), 0.0)
    if tiny_col is not None:
        X[:, tiny_col] = np.where(
            mask[:, tiny_col],
            np.sign(r.normal(size=n)) * 10.0 ** r.uniform(-37, -33, n),
            0.0)
    if nan_frac:
        X[(r.uniform(size=(n, f)) < nan_frac) & mask] = np.nan
    y = (np.nansum(X[:, : min(6, f)], axis=1)
         + 0.3 * r.normal(size=n) > 0).astype(np.float64)
    return X, ssp.csr_matrix(X), y


def one_hot_sparse(n: int, seed: int):
    """4 sparse normal columns, a 30-way one-hot and an 8-way valued
    one: density about 0.066, under the sparse tier's ceiling."""
    r = np.random.default_rng(seed)
    Xn = r.normal(size=(n, 4))
    Xn = np.where(np.abs(Xn) > 1.3, Xn, 0.0)
    c1, c2 = r.integers(0, 30, n), r.integers(0, 8, n)
    oh1 = np.zeros((n, 30))
    oh1[np.arange(n), c1] = 1.0
    oh2 = np.zeros((n, 8))
    oh2[np.arange(n), c2] = r.normal(size=n)
    y = ((Xn[:, 0] + 0.3 * (c1 % 4) + oh2[:, 1]
          + 0.5 * r.normal(size=n)) > 0.5).astype(np.float64)
    X = np.hstack([Xn, oh1, oh2])
    return X, ssp.csr_matrix(X), y


# -- the representation, mappers and bins ----------------------------------------

@needs_jax
def test_sparse_matrix_constructors_equal():
    r = np.random.default_rng(1)
    n, f = 50, 9
    rows = np.sort(r.integers(0, n, 120))
    cols = r.integers(0, f, 120)
    vals = r.normal(size=120)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    for mk in (lambda m: m.from_csr(indptr, cols, vals, f),
               lambda m: m.from_csc(*_csc(rows, cols, vals, f), n, f),
               lambda m: m.from_scipy(ssp.coo_matrix((vals, (rows, cols)),
                                                     shape=(n, f)))):
        a, b = mk(tsp.SparseMatrix), mk(jsp.SparseMatrix)
        for k in ("data", "cols", "indptr"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.to_dense(), b.to_dense())
        idx = np.array([3, 0, 7, 7, 41])
        np.testing.assert_array_equal(a.take_rows(idx).to_dense(),
                                      b.take_rows(idx).to_dense())
        np.testing.assert_array_equal(a.to_dense_rows(5, 17),
                                      b.to_dense_rows(5, 17))


def _csc(rows, cols, vals, f):
    order = np.lexsort((rows, cols))
    col_ptr = np.concatenate([[0], np.cumsum(np.bincount(cols,
                                                         minlength=f))])
    return col_ptr, rows[order], vals[order]


@needs_jax
@pytest.mark.parametrize("zam", [False, True])
def test_mappers_and_bins_equal(zam):
    X, csr, _ = sparse_task(n=2_500, f=12, seed=4, cat_col=3,
                            nan_frac=0.1, tiny_col=5)
    params = {"zero_as_missing": str(zam).lower(), "min_data_in_leaf": "5",
              "enable_bundle": "false"}
    tcfg, jcfg = TConfig().set(params), JConfig().set(params)
    tsm, jsm = tsp.SparseMatrix.from_scipy(csr), jsp.SparseMatrix.from_scipy(
        csr)
    tm = tsp.find_column_mappers_sparse(tsm, tcfg, {3})
    jm = jsp.find_column_mappers_sparse(jsm, jcfg, {3})
    # (assert_equal: a NaN upper bound equals itself)
    np.testing.assert_equal([m.to_dict() for m in tm],
                            [m.to_dict() for m in jm])
    ds = BinnedDataset(tcfg, "cpu").construct_from_matrix(
        tsm, Metadata(label=np.zeros(2_500)), categorical=[3])
    assert ds.bundles is None and ds.sparse_nnz == csr.nnz
    used = [m for m in jm if not m.is_trivial]
    want = jsp.host_bins_from_sparse(jsm, used, ds.used_feature_map,
                                     np.uint8)
    np.testing.assert_array_equal(ds.bins_t.numpy().T, want)
    np.testing.assert_array_equal(ds.sparse_zero_bins, jsp.zero_bins(used))
    # the dense route on the densified rows bins alike
    dense = BinnedDataset(tcfg, "cpu").construct_from_matrix(
        X, Metadata(label=np.zeros(2_500)), categorical=[3])
    np.testing.assert_array_equal(dense.bins_t.numpy(), ds.bins_t.numpy())


@needs_jax
def test_route_sparse_at_the_threshold():
    X, csr, y = sparse_task(n=400, f=10, density=0.2, seed=2)
    sm = tsp.SparseMatrix.from_scipy(csr)
    d = sm.density
    for thr, want in ((1.0 - d - 1e-9, True), (1.0 - d + 1e-3, False)):
        cfg = TConfig().set({"sparse_threshold": repr(thr)})
        assert tsp.route_sparse(cfg, sm) is want
        assert jsp.route_sparse(JConfig().set({"sparse_threshold":
                                               repr(thr)}),
                                jsp.SparseMatrix.from_scipy(csr)) is want
        ds = BinnedDataset(cfg, "cpu").construct_from_matrix(
            sm, Metadata(label=y))
        assert (ds.sparse_density is not None) is want
    off = TConfig().set({"is_enable_sparse": "false"})
    assert not tsp.route_sparse(off, sm)


def test_sparse_route_builds_no_dense_host_matrix(monkeypatch):
    """A 1%-density set trains without a dense [N, F]: ``to_dense``
    banned, and the host's allocation peak during construction and
    training under a uint8 [N, F] (the float64 one is 8 times that)."""
    import tracemalloc
    r = np.random.default_rng(15)
    n, f = 60_000, 100
    cols = r.integers(0, f, n)            # one entry a row
    vals = r.normal(size=n) + 2.0
    indptr = np.arange(n + 1, dtype=np.int64)
    sm = tsp.SparseMatrix(vals, cols, indptr, (n, f))
    y = (vals > 2.0).astype(np.float64)
    assert sm.density <= 0.0105

    def boom(*a, **kw):
        raise AssertionError("dense [N, F] built on the sparse route")

    monkeypatch.setattr(tsp.SparseMatrix, "to_dense", boom)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "enable_bundle": False, "min_data_in_leaf": 5}
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    bst = lgt.train(params, lgt.Dataset(sm, label=y), 3, device="cpu")
    peak = tracemalloc.get_traced_memory()[1] - base
    tracemalloc.stop()
    assert bst._gbdt.train_data.sparse_density is not None
    assert peak < n * f, peak


# -- the sparse histogram tier -------------------------------------------------

def _coords(bins_t, zb):
    """(codes, feat, row) of the cells of [F, N] bins off their zero bin,
    feature by feature in row order (the JAX package's entry order)."""
    feat, row = np.nonzero(bins_t != zb[:, None])
    return bins_t[feat, row].astype(np.int32), feat.astype(np.int32), \
        row.astype(np.int32)


@needs_jax
@pytest.mark.parametrize("tier", ["f32", "int8"])
@pytest.mark.parametrize("W", [1, 7])
def test_wave_histogram_sparse_equal_jax(tier, W):
    r = np.random.default_rng(W)
    F, n, B, L = 6, 4_000, 32, 12
    zb = r.integers(0, 4, F).astype(np.int32)
    bins = np.where(r.uniform(size=(F, n)) < 0.1,
                    r.integers(0, B, (F, n)), zb[:, None]).astype(np.uint8)
    codes, feat, row = _coords(bins, zb)
    leaf = r.integers(-1, L, n).astype(np.int32)
    wl = r.permutation(L)[:W].astype(np.int32)
    if W > 1:
        wl[1] = -1
    if tier == "int8":
        g = r.integers(-127, 128, n).astype(np.int8)
        h = r.integers(0, 128, n).astype(np.int8)
        scale = (np.float32(0.013), np.float32(0.007))
        jg, jh = g.astype(np.float32), h.astype(np.float32)
    else:
        g = r.normal(size=n).astype(np.float32)
        h = r.uniform(0.1, 1, n).astype(np.float32)
        scale, jg, jh = None, g, h
    want = np.asarray(jhw.wave_histogram_sparse(
        (jnp.asarray(codes), jnp.asarray(feat), jnp.asarray(row),
         jnp.asarray(zb)), jnp.asarray(jg), jnp.asarray(jh),
        jnp.asarray(leaf), jnp.asarray(wl), num_bins=B, num_features=F,
        gh_scale=None if scale is None else tuple(jnp.float32(s)
                                                  for s in scale)))
    t = [torch.from_numpy(a) for a in (codes, feat, row, zb)]
    got = thw.wave_histogram_sparse(
        t, torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(leaf),
        torch.from_numpy(wl), B, F, L,
        gh_scale=None if scale is None else tuple(torch.tensor(s)
                                                  for s in scale)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # and against the dense tier: integers always, f32 off the zero bins
    dense = thw.wave_histogram_plain(
        torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(leaf), torch.from_numpy(wl), B)
    if tier == "int8":
        raw = thw.wave_histogram_sparse(
            t, torch.from_numpy(g), torch.from_numpy(h),
            torch.from_numpy(leaf), torch.from_numpy(wl), B, F, L)
        assert torch.equal(raw, dense)


# -- training -------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("name,extra", [
    ("unbundled", {"enable_bundle": False}),
    ("f32_sparse_tier", {"enable_bundle": False, "tpu_sparse": 1}),
    ("int8_sparse_tier", {"enable_bundle": False,
                          "tpu_quantized_hist": True, "tpu_count_proxy": 0}),
    ("int8_dense_tier", {"enable_bundle": False, "tpu_quantized_hist": True,
                         "tpu_count_proxy": 0, "tpu_sparse": 0})])
def test_sparse_training_equal_jax(name, extra):
    X, csr, y = one_hot_sparse(12_000, 0)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1, **extra}
    jb = lgb.train(p, lgb.Dataset(csr, label=y), 8)
    tb = lgt.train(p, lgt.Dataset(csr, label=y), 8, device="cpu")
    tier = tb._gbdt._grower_cfg.sparse_hist
    assert tier == jb._gbdt._grower_cfg.sparse_hist
    assert tier == (name.endswith("sparse_tier"))
    assert body(tb.model_to_string()) == body(jb.model_to_string())
    if name == "int8_sparse_tier":
        dense = lgt.train({**p, "tpu_sparse": 0}, lgt.Dataset(X, label=y), 8,
                          device="cpu")
        assert body(dense.model_to_string()) == body(tb.model_to_string())


@needs_jax
def test_sparse_with_efb_equal_jax():
    from test_torch_efb import assert_bundled_texts_match
    X, csr, y = one_hot_sparse(12_000, 1)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1}
    jb = lgb.train(p, lgb.Dataset(csr, label=y), 8)
    ds = lgt.Dataset(csr, label=y)
    tb = lgt.train(p, ds, 8, device="cpu")
    td = tb._gbdt.train_data
    assert td.bundles == jb._gbdt.train_data.bundles is not None
    assert td.sparse_coords is None
    assert_bundled_texts_match(jb.model_to_string(), tb.model_to_string())
    # the bundle columns from the entries: the dense route's, bundled
    dense = BinnedDataset(TConfig(), "cpu").construct_from_matrix(
        X, Metadata(label=y))
    assert torch.equal(dense.bins_t, td.bins_t)
    # a sparse valid set bundled with the train set's bundles
    Xv, csrv, yv = one_hot_sparse(3_000, 2)
    v = ds._inner.create_valid(tsp.SparseMatrix.from_scipy(csrv),
                               Metadata(label=yv))
    vd = ds._inner.create_valid(Xv, Metadata(label=yv))
    assert v.bundles is td.bundles and torch.equal(v.bins_t, vd.bins_t)


@needs_jax
def test_capi_csr_csc_equal_jax():
    X, csr, y = one_hot_sparse(6_000, 3)
    Xn, csrn, _ = one_hot_sparse(2_000, 4)
    params = "objective=binary num_leaves=15 verbose=-1"

    def train(capi, handle, **kw):
        capi.LGBM_DatasetSetField(handle, "label", y.astype(np.float32))
        bst = capi.LGBM_BoosterCreate(handle, params, **kw)
        for _ in range(5):
            capi.LGBM_BoosterUpdateOneIter(bst)
        return bst

    csc = csr.tocsc()
    texts, preds = {}, {}
    for name, capi, kw in (("jax", jcapi, {}), ("port", tcapi, {})):
        dkw = {"device": "cpu"} if name == "port" else {}
        h_csr = capi.LGBM_DatasetCreateFromCSR(
            csr.indptr, 3, csr.indices, csr.data, 1, len(csr.indptr),
            csr.nnz, csr.shape[1], params, **dkw)
        h_csc = capi.LGBM_DatasetCreateFromCSC(
            csc.indptr, 3, csc.indices, csc.data, 1, len(csc.indptr),
            csc.nnz, csc.shape[0], params, **dkw)
        b1, b2 = train(capi, h_csr), train(capi, h_csc)
        texts[name] = [capi.LGBM_BoosterSaveModelToString(b)
                       for b in (b1, b2)]
        preds[name] = [
            np.asarray(capi.LGBM_BoosterPredictForCSR(
                b1, csrn.indptr, 3, csrn.indices, csrn.data, 1,
                len(csrn.indptr), csrn.nnz, csrn.shape[1])),
            np.asarray(capi.LGBM_BoosterPredictForCSC(
                b1, csrn.tocsc().indptr, 3, csrn.tocsc().indices,
                csrn.tocsc().data, 1, len(csrn.tocsc().indptr),
                csrn.tocsc().nnz, csrn.shape[0])),
            np.asarray(capi.LGBM_BoosterPredictForMat(b1, Xn))]
    from test_torch_efb import assert_bundled_texts_match
    for a, b in zip(texts["jax"], texts["port"]):
        assert_bundled_texts_match(a, b)
    assert body(texts["port"][0]) == body(texts["port"][1])
    for a, b in zip(preds["jax"], preds["port"]):
        np.testing.assert_allclose(b, a, atol=1e-5)
    np.testing.assert_array_equal(preds["port"][0], preds["port"][2])
    np.testing.assert_array_equal(preds["port"][1], preds["port"][2])
    # Booster.predict on the scipy matrix: the C API's answers
    bst = lgt.Booster(model_str=texts["port"][0], device="cpu")
    np.testing.assert_array_equal(bst.predict(csrn), preds["port"][0])
    np.testing.assert_array_equal(bst.predict(csrn, raw_score=True),
                                  bst.predict(Xn, raw_score=True))


@needs_jax
def test_capi_push_rows_by_csr_equal_jax():
    X, csr, y = sparse_task(n=2_000, f=8, density=0.3, seed=9)
    sample_idx = np.arange(0, 2_000, 4)
    cols = [X[sample_idx, j] for j in range(8)]
    nz = [np.nonzero(c)[0] for c in cols]
    out = {}
    for name, capi in (("jax", jcapi), ("port", tcapi)):
        kw = {"device": "cpu"} if name == "port" else {}
        h = capi.LGBM_DatasetCreateFromSampledColumn(
            [c[i] for c, i in zip(cols, nz)], [i for i in nz], 8,
            [len(i) for i in nz], len(sample_idx), 2_000,
            "objective=binary verbose=-1", **kw)
        for r0 in range(0, 2_000, 700):
            blk = csr[r0:r0 + 700]
            capi.LGBM_DatasetPushRowsByCSR(
                h, blk.indptr, 3, blk.indices, blk.data, 1,
                len(blk.indptr), blk.nnz, 8, r0)
        capi.LGBM_DatasetSetField(h, "label", y.astype(np.float32))
        bst = capi.LGBM_BoosterCreate(h, "objective=binary num_leaves=7 "
                                      "verbose=-1")
        for _ in range(4):
            capi.LGBM_BoosterUpdateOneIter(bst)
        out[name] = capi.LGBM_BoosterSaveModelToString(bst)
    assert body(out["port"]) == body(out["jax"])


def test_chunked_predict_equal_unchunked(monkeypatch):
    X, csr, y = one_hot_sparse(5_000, 5)
    bst = lgt.train({"objective": "binary", "num_leaves": 15,
                     "verbose": -1}, lgt.Dataset(X, label=y), 5,
                    device="cpu")
    whole = bst.predict(csr)
    leaves = bst.predict(csr, pred_leaf=True)
    monkeypatch.setattr(tsp, "PREDICT_CHUNK_ROWS", 777)
    assert tsp.predict_chunk_rows(csr.shape[1]) == 777
    np.testing.assert_array_equal(bst.predict(csr), whole)
    np.testing.assert_array_equal(bst.predict(csr, pred_leaf=True), leaves)
    np.testing.assert_array_equal(whole, bst.predict(X))


# -- the card: the sparse tier and the bundled K2 against plain ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def test_sparse_tier_on_the_card(cuda):
    """The sparse tier's PyTorch ops on the card against the same ops on
    the CPU: int8 bit for bit, f32 the same bits on two runs and within
    ``refit.sum_bound`` of the CPU's serial sums (the card sorts the
    entries by cell and adds each cell's segment in XLA's order)."""
    from lightgbm_tpu_torch.ops.refit import sum_bound
    r = np.random.default_rng(21)
    F, n, B, L, W = 40, 300_000, 64, 64, 24
    zb = r.integers(0, 3, F).astype(np.int32)
    bins = np.where(r.uniform(size=(F, n)) < 0.02,
                    r.integers(0, B, (F, n)), zb[:, None]).astype(np.uint8)
    codes, feat, row = _coords(bins, zb)
    leaf = torch.from_numpy(r.integers(-1, L, n).astype(np.int32))
    wl = torch.from_numpy(r.permutation(L)[:W].astype(np.int32))
    sp = [torch.from_numpy(a) for a in (codes, feat, row, zb)]
    spc = [t.to(cuda) for t in sp]
    gq = torch.from_numpy(r.integers(-127, 128, n).astype(np.int8))
    hq = torch.from_numpy(r.integers(0, 128, n).astype(np.int8))
    a = thw.wave_histogram_sparse(sp, gq, hq, leaf, wl, B, F, L)
    b = thw.wave_histogram_sparse(spc, gq.to(cuda), hq.to(cuda),
                                  leaf.to(cuda), wl.to(cuda), B, F, L)
    assert torch.equal(a, b.cpu())
    g = torch.from_numpy(r.normal(size=n).astype(np.float32))
    h = torch.from_numpy(r.uniform(0.1, 1, n).astype(np.float32))
    cpu = thw.wave_histogram_sparse(sp, g, h, leaf, wl, B, F, L)
    args = (spc, g.to(cuda), h.to(cuda), leaf.to(cuda), wl.to(cuda), B, F, L)
    c1 = thw.wave_histogram_sparse(*args)
    c2 = thw.wave_histogram_sparse(*args)
    assert torch.equal(c1, c2)
    # each cell adds at most n rows, and the zero bins subtract two such
    # sums: within twice the bound of a sum of all |g|, plus the
    # roundings of the completion itself
    want = cpu[..., :2].double().numpy()
    got = c1[..., :2].cpu().double().numpy()
    tol = (2 * sum_bound(np.array([n]), np.array([
        float(g.abs().sum()), float(h.abs().sum())])) + 4 * np.spacing(
            np.abs(want).astype(np.float32)).astype(np.float64))
    assert np.all(np.abs(got - want) <= tol)
    assert torch.equal(c1[..., 2].cpu(), cpu[..., 2])
