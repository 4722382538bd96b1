"""Port parity for exclusive feature bundling (EFB): lightgbm_tpu_torch
against lightgbm_tpu on the CPU.

What is held, and to which bar:
- ``find_bundles`` and the host ``bundle_bins`` (copied host code) at
  conflict rates 0 and 0.05: the same bundles and integers as the JAX
  package's; the device twins ``bundle_bins_device`` (from [F, N] member
  bins) and ``bundle_bins_sparse`` (from a sparse set's binned entries):
  the host version's integers, conflicts won by the later member;
- ``expand_bundle_histogram`` on random f32 histograms: bit for bit
  (its two sums over bins add in XLA's CPU order, ``xla_sum``);
  ``member_column``: equal;
- the split search's prefix sums at widths 2-256 (the bundled route's
  histogram width is not bucketed): bit for bit against the JAX
  package's einsum, compiled on its own. Inside its jitted grower XLA
  fuses that product otherwise at some widths below 241 (max_bin 31
  here): there the port's trees are the JAX grower's run eagerly, and
  the model texts below keep to widths of 255 and 256;
- training on one-hot data with default parameters (the fault this
  slice repairs: the port accepted ``enable_bundle`` and ignored it):
  model text byte-equal to the JAX package's default text, which itself
  differs from its unbundled text; forced splits under bundles; a valid
  set sharing the train set's bundles (evals within 1e-6 relative, the
  float32 AUC of the JAX package against the port's float64); ``cv``'s
  folds keeping the parent's bundles (means within 1e-6 relative, stdv
  within 1e-6); the binary file round trip, which stores member bins and
  no bundles in both packages, so both train unbundled after a load.
  The JAX package trains a bundled set with its per-booster jitted step
  (its step cache does not take EFB sets, gbdt.py:784), which XLA
  contracts otherwise than the cached step the port follows: beyond the
  probe, the texts are held line for line but for the split gains, each
  within 1e-5 of the JAX package's (``assert_bundled_texts_match``;
  trees, thresholds, leaf values and counts equal, so the scores are).
  Multiclass on three classes of pure leaves is held byte for byte: there
  a candidate's gain equals the leaf's up to rounding, and the step
  holds the candidates against the leaf's gain contracted into one fused
  multiply-add (``ops/split.py find_best_split``'s ``cmp_shift``);
- the int8 tier with exact counts under bundles: every tree equal in
  structure and counts, the first three byte-equal; from the fourth on
  the root's gain can part by an ulp (ROADMAP queue 3 E: XLA rounds the
  right side's g sum twice in about one root split in ten).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import tree_diff
from lightgbm_tpu_torch.io import efb as tefb
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.ops.split import FeatureMeta
from lightgbm_tpu_torch.utils import log as tlog

try:
    import jax
    import jax.numpy as jnp
    import lightgbm_tpu as lgb
    from lightgbm_tpu.io import efb as jefb
    from lightgbm_tpu.ops import partition as jpart
    from lightgbm_tpu.utils import log as jlog
except ImportError:          # on the card's machine: the card test only
    jax = None

pytestmark = pytest.mark.torch_port

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


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
    levels = (jlog.get_level() if jax is not None else None,
              tlog.get_level())
    yield
    if jax is not None:
        jlog.set_level(levels[0])
    tlog.set_level(levels[1])


REL = 1e-6


def one_hot_data(n: int, seed: int):
    """4 normal columns, 12 one-hot columns of one category and 5 of
    another (valued), the label from both."""
    r = np.random.default_rng(seed)
    Xn = r.normal(size=(n, 4))
    c1, c2 = r.integers(0, 12, n), r.integers(0, 5, n)
    oh1 = np.zeros((n, 12))
    oh1[np.arange(n), c1] = 1.0
    oh2 = np.zeros((n, 5))
    oh2[np.arange(n), c2] = r.normal(size=n)
    y = ((Xn[:, 0] + 0.5 * (c1 % 3) + oh2[:, 1]
          + 0.5 * r.normal(size=n)) > 0.5).astype(np.float64)
    return np.hstack([Xn, oh1, oh2]), y


def probe_data():
    """The fault's probe: 20,000 rows, 4 normal and 12 one-hot columns."""
    r = np.random.default_rng(0)
    n = 20_000
    Xn = r.normal(size=(n, 4))
    cat = r.integers(0, 12, n)
    oh = np.zeros((n, 12))
    oh[np.arange(n), cat] = 1.0
    y = ((Xn[:, 0] + 0.5 * (cat % 3) + 0.5 * r.normal(size=n))
         > 0.5).astype(np.float64)
    return np.hstack([Xn, oh]), y


def body(text: str) -> str:
    return text.split("parameters:")[0]


GAIN_REL = 1e-5


def assert_bundled_texts_match(jax_text: str, port_text: str) -> None:
    """The bar where the JAX package trains with its per-booster step:
    every line of the model text before its parameters equal but the
    split gains (and ``tree_sizes``, their strings' lengths), and each
    gain within ``GAIN_REL`` of the JAX package's, relative to the larger
    of the two."""
    a, b = body(jax_text).splitlines(), body(port_text).splitlines()
    assert len(a) == len(b)
    for x, z in zip(a, b):
        if x == z or x.startswith("tree_sizes="):
            continue
        assert x.startswith("split_gain="), (x[:80], z[:80])
        ga = np.array(x.split("=")[1].split(), np.float64)
        gb = np.array(z.split("=")[1].split(), np.float64)
        assert np.all(np.abs(ga - gb)
                      <= GAIN_REL * np.maximum(np.abs(ga), np.abs(gb))), \
            (ga, gb)


def exclusive_bins(n, seed, conflict):
    """Host bins [n, 14]: two numerical-like columns, then 12 columns
    that are 0 (their default) except in one row block each; with
    ``conflict`` that share of rows gets a second non-default column."""
    r = np.random.default_rng(seed)
    nb = np.array([40, 17] + [3, 4, 2, 5, 3, 6, 2, 2, 7, 3, 4, 2], np.int32)
    db = np.zeros(14, np.int32)
    db[1] = 3
    bins = np.zeros((n, 14), np.uint8)
    bins[:, 0] = r.integers(0, 40, n)
    bins[:, 1] = r.integers(0, 17, n)
    which = r.integers(2, 14, n)
    bins[np.arange(n), which] = r.integers(1, nb[which])
    k = int(conflict * n)
    rows = r.choice(n, k, replace=False)
    other = 2 + (which[rows] - 2 + 1 + r.integers(0, 10, k)) % 12
    bins[rows, other] = r.integers(1, nb[other])
    return bins, db, nb


@needs_jax
@pytest.mark.parametrize("conflict", [0.0, 0.05])
@pytest.mark.parametrize("n", [3_000, 60_000])
def test_find_and_bundle_bins_equal(conflict, n):
    bins, db, nb = exclusive_bins(n, 7, conflict)
    want = jefb.find_bundles(bins, db, nb, conflict)
    got = tefb.find_bundles(bins, db, nb, conflict)
    assert got == want
    assert len(got) < bins.shape[1]
    jb = jefb.bundle_bins(bins, want, db, nb)
    hb = tefb.bundle_bins(bins, got, db, nb)
    np.testing.assert_array_equal(hb[0], jb[0])
    for a, b in zip(hb[1:], jb[1:]):
        np.testing.assert_array_equal(a, b)
    # the device twin from member bins [F, N]
    dev, mb, mo, width = tefb.bundle_bins_device(
        torch.from_numpy(np.ascontiguousarray(bins.T)), got, db, nb)
    np.testing.assert_array_equal(dev.numpy().T, jb[0])
    assert width == jb[3]
    np.testing.assert_array_equal(mb, jb[1])
    np.testing.assert_array_equal(mo, jb[2])
    # and from a sparse set's entries: column j's cells are zero_bin[j]
    # (here its default, or for column 1 another bin) but for entries
    zb = db.copy()
    zb[1] = 0
    rows, cols = np.nonzero(bins != zb[None, :])
    order = np.argsort(cols, kind="stable")
    rows, cols = rows[order], cols[order]
    bounds = np.searchsorted(cols, np.arange(15))
    sp, *_ = tefb.bundle_bins_sparse(
        n, torch.from_numpy(bins[rows, cols].astype(np.int32)), bounds,
        torch.from_numpy(rows.astype(np.int64)), zb, got, db, nb,
        torch.uint8)
    np.testing.assert_array_equal(sp.numpy().T, jb[0])


@needs_jax
@pytest.mark.parametrize("lead,nbs,B_out", [
    ((5,), [3, 5, 7, 2, 40], 64), ((1,), [2] * 100 + [50], 256),
    ((32,), [2] * 127, 255), ((3,), [4, 4, 3], 16), ((2, 4), [31] * 3
                                                      + [2] * 70, 31)])
def test_expand_bundle_histogram_bit_equal(lead, nbs, B_out):
    r = np.random.default_rng(len(nbs))
    nb = np.array(nbs, np.int32)
    f = len(nb)
    bundles = [[0], list(range(1, f))]
    mb, mo, width = tefb.bundle_layout(bundles, nb, f)
    db = r.integers(0, nb).astype(np.int32)
    shape = lead + (2, max(width, 2), 3)
    h = (r.normal(size=shape) * r.choice([1.0, 1e3, 1e-3], size=shape)
         ).astype(np.float32)
    B = max(B_out, int(nb.max()))
    want = np.asarray(jax.jit(lambda x: jefb.expand_bundle_histogram(
        x, mb, mo, nb, db, B))(jnp.asarray(h)))
    got = tefb.expand_bundle_histogram(torch.from_numpy(h), mb, mo, nb, db,
                                       B).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@needs_jax
def test_member_column_equal():
    bins, db, nb = exclusive_bins(5_000, 3, 0.05)
    bundles = tefb.find_bundles(bins, db, nb, 0.05)
    bb, mb, mo, _ = tefb.bundle_bins(bins, bundles, db, nb)
    f = bins.shape[1]
    z = np.zeros(f, np.int32)
    from lightgbm_tpu.ops.split import FeatureMeta as JMeta
    jmeta = JMeta(num_bin=nb, missing_type=z, default_bin=db, monotone=z,
                  penalty=np.ones(f, np.float32), bundle=mb, offset=mo)
    tmeta = FeatureMeta(num_bin=nb, missing_type=z, default_bin=db,
                        monotone=z, penalty=np.ones(f, np.float32),
                        bundle=mb, offset=mo)
    bt = np.ascontiguousarray(bb.T)
    for j in range(f):
        want = np.asarray(jpart.member_column(jnp.asarray(bt), j, jmeta))
        got = tpart.member_column(torch.from_numpy(bt), j, tmeta).numpy()
        np.testing.assert_array_equal(got, want)
    # the unbundled meta reads the row itself
    plain = FeatureMeta(num_bin=nb, missing_type=z, default_bin=db,
                        monotone=z, penalty=np.ones(f, np.float32))
    assert torch.equal(tpart.member_column(
        torch.from_numpy(np.ascontiguousarray(bins.T)), 5, plain),
        torch.from_numpy(bins[:, 5].astype(np.int32)))


@needs_jax
@pytest.mark.parametrize("B", [2, 3, 5, 7, 12, 17, 19, 20, 23, 24, 31, 33,
                               40, 50, 63, 65, 70, 84, 99, 130, 161, 200,
                               241, 255, 256])
def test_prefix_sums_every_width(B):
    r = np.random.default_rng(B)
    x = (r.normal(size=(9, B, 3)) * r.choice([1.0, 1e4, 1e-4],
                                             size=(9, B, 3))
         ).astype(np.float32)
    want = np.asarray(jax.jit(lambda c: jnp.einsum(
        "bk,fkc->fbc", jnp.tril(jnp.ones((B, B), jnp.float32)), c,
        precision=jax.lax.Precision.HIGHEST))(jnp.asarray(x)))
    got = ts.prefix_sums(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- training -------------------------------------------------------------------

@needs_jax
def test_default_params_on_one_hot_data_equal_jax():
    """The repaired fault: with default parameters the JAX package
    bundles the 12 one-hot columns, and the port now does too, to its
    model text byte for byte."""
    X, y = probe_data()
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1}
    jb = lgb.train(p, lgb.Dataset(X, label=y), 5)
    j_text = jb.model_to_string()
    j_flat = lgb.train({**p, "enable_bundle": False},
                       lgb.Dataset(X, label=y), 5).model_to_string()
    tb = lgt.train(p, lgt.Dataset(X, label=y), 5, device="cpu")
    td = tb._gbdt.train_data
    assert td.bundles == jb._gbdt.train_data.bundles
    assert td.bundles[-1] == list(range(4, 16))
    assert td.bins_t.shape == (5, 20_000)
    assert body(j_text) != body(j_flat)
    assert body(tb.model_to_string()) == body(j_text)
    flat = lgt.train({**p, "enable_bundle": False}, lgt.Dataset(X, label=y),
                     5, device="cpu")
    assert flat._gbdt.train_data.bundles is None
    assert body(flat.model_to_string()) == body(j_flat)


@needs_jax
@pytest.mark.parametrize("extra", [
    {}, {"bagging_fraction": 0.8, "bagging_freq": 2,
         "feature_fraction": 0.8},
    {"objective": "regression", "lambda_l2": 1.0},
    {"objective": "multiclass", "num_class": 3}])
def test_bundled_training_equal_jax(extra):
    multiclass = extra.get("objective") == "multiclass"
    if multiclass:
        # three classes of |2 x0|: pure leaves whose candidates' gains
        # are rounding noise around the leaf's own (ROADMAP queue 3 M)
        X, _ = one_hot_data(6_000, 5)
        y = (np.abs(2 * X[:, 0]).astype(int) % 3).astype(np.float64)
    else:
        X, y = one_hot_data(12_000, 1)
    rounds = 4 if multiclass else 8
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1, **extra}
    jt = lgb.train(p, lgb.Dataset(X, label=y), rounds).model_to_string()
    tb = lgt.train(p, lgt.Dataset(X, label=y), rounds, device="cpu")
    assert tb._gbdt.train_data.bundles is not None
    assert tb._gbdt._grower_cfg.bundle_bins > 0
    if multiclass:
        assert body(tb.model_to_string()) == body(jt)
    else:
        assert_bundled_texts_match(jt, tb.model_to_string())


@needs_jax
def test_forced_splits_under_bundles(tmp_path):
    import json
    spec = {"feature": 0, "threshold": 0.1,
            "left": {"feature": 5, "threshold": 0.5},
            "right": {"feature": 17, "threshold": 0.2}}
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(spec))
    X, y = one_hot_data(8_000, 2)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "forcedsplits_filename": str(path)}
    jt = lgb.train(p, lgb.Dataset(X, label=y), 5).model_to_string()
    tb = lgt.train(p, lgt.Dataset(X, label=y), 5, device="cpu")
    assert tb._gbdt.train_data.bundles is not None
    assert len(tb._gbdt._grower_cfg.forced) == 3
    assert_bundled_texts_match(jt, tb.model_to_string())


@needs_jax
def test_int8_under_bundles():
    X, y = one_hot_data(20_000, 0)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "tpu_quantized_hist": True, "tpu_count_proxy": 0}
    jb = lgb.train(p, lgb.Dataset(X, label=y), 8)
    tb = lgt.train(p, lgt.Dataset(X, label=y), 8, device="cpu")
    cfg = tb._gbdt._grower_cfg
    assert cfg.precision == "int8" and not cfg.count_proxy
    assert tb._gbdt.train_data.bundles is not None
    jt, tt = jb.model_to_string(), tb.model_to_string()
    assert jt.split("Tree=")[1:4] == tt.split("Tree=")[1:4]
    tb._gbdt._ensure_host_trees()
    jm = lgb.Booster(model_str=jt)._gbdt.models
    assert tree_diff(jm, tb._gbdt.models) is None


@needs_jax
def test_valid_set_shares_bundles():
    X, y = one_hot_data(12_000, 3)
    Xv, yv = one_hot_data(4_000, 4)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "metric": "auc,binary_logloss"}
    ej, et = {}, {}
    jt = lgb.train(p, lgb.Dataset(X, label=y), 8,
                   valid_sets=[lgb.Dataset(Xv, label=yv)],
                   evals_result=ej, verbose_eval=False).model_to_string()
    dt = lgt.Dataset(X, label=y)
    dv = lgt.Dataset(Xv, label=yv, reference=dt)
    tb = lgt.train(p, dt, 8, valid_sets=[dv], evals_result=et,
                   verbose_eval=False, device="cpu")
    assert dv._inner.bundles is dt._inner.bundles is not None
    assert dv._inner.bins_t.shape[0] == len(dt._inner.bundles)
    assert_bundled_texts_match(jt, tb.model_to_string())
    for name in ("auc", "binary_logloss"):
        for a, b in zip(et["valid_0"][name], ej["valid_0"][name]):
            assert abs(a - b) <= REL * max(abs(a), abs(b)), (name, a, b)


@needs_jax
def test_cv_folds_keep_bundles():
    X, y = one_hot_data(6_000, 5)
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "metric": "binary_logloss"}
    rj = lgb.cv(p, lgb.Dataset(X, label=y, free_raw_data=False), 5,
                nfold=3, stratified=False, seed=3)
    ds = lgt.Dataset(X, label=y, free_raw_data=False)
    rt = lgt.cv(p, ds, 5, nfold=3, stratified=False, seed=3, device="cpu")
    assert ds._inner.bundles is not None
    sub = ds._inner.subset(np.arange(0, 6_000, 2), Metadata(
        label=y[::2].astype(np.float32)))
    assert sub.bundles is ds._inner.bundles
    assert torch.equal(sub.bins_t, ds._inner.bins_t[:, ::2])
    for key in rj:
        for a, b in zip(rt[key], rj[key]):
            # a stdv's error is its means' (1e-6 relative of a loss < 1)
            scale = 1.0 if key.endswith("-stdv") else max(abs(a), abs(b))
            assert abs(a - b) <= REL * scale, (key, a, b)


@needs_jax
def test_binary_file_round_trip_unbundled(tmp_path):
    """Both packages' binary files hold member bins and no bundles: the
    port's file of a bundled set loads unbundled in either package and
    trains their unbundled texts, equal to each other."""
    X, y = one_hot_data(8_000, 6)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1}
    tpath, jpath = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    d = lgt.Dataset(X, label=y)
    d.construct(device="cpu")
    assert d._inner.bundles is not None
    d.save_binary(tpath)
    lgb.Dataset(X, label=y).save_binary(jpath)
    flat = body(lgb.train({**p, "enable_bundle": False},
                          lgb.Dataset(X, label=y), 5).model_to_string())
    for path in (tpath, jpath):
        tb = lgt.train(p, lgt.Dataset(path), 5, device="cpu")
        assert tb._gbdt.train_data.bundles is None
        assert body(tb.model_to_string()) == flat
        jt = lgb.train(p, lgb.Dataset(path), 5).model_to_string()
        assert body(jt) == flat
    # the member bins the port wrote: the set's own, decoded
    loaded = BinnedDataset.load_binary(tpath, TConfig(), "cpu")
    assert torch.equal(loaded.bins_t, d._inner.member_bins())


def test_bundles_follow_enable_bundle_and_given_mappers():
    """``enable_bundle=false`` and mappers given (the C API's sampled
    columns) leave the set unbundled, as in the JAX package."""
    X, y = one_hot_data(3_000, 8)
    cfg = TConfig()
    ds = BinnedDataset(cfg, "cpu").construct_from_matrix(X, Metadata(
        label=y))
    assert ds.bundles is not None and ds.bundled_bins is ds.bins_t
    meta = ds.feature_meta()
    assert meta.bundled and meta.bundle.shape == (ds.num_features,)
    np.testing.assert_array_equal(
        ds.member_bins().numpy(),
        BinnedDataset(TConfig().set({"enable_bundle": "false"}), "cpu")
        .construct_from_matrix(X, Metadata(label=y)).bins_t.numpy())
    cfg2 = TConfig().set({"enable_bundle": "false"})
    assert BinnedDataset(cfg2, "cpu").construct_from_matrix(
        X, Metadata(label=y)).bundles is None
    from lightgbm_tpu_torch.io.dataset import find_column_mappers
    mappers = find_column_mappers(X, cfg)
    assert BinnedDataset(cfg, "cpu").construct_from_matrix(
        X, Metadata(label=y), mappers=mappers).bundles is None


# -- the card: K2 over bundle columns ------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def test_k2_over_bundle_columns_kernel(cuda):
    """K2 at a bundled wave's shape (W = 24 slots, 12 bundle columns,
    255 bins) bit for bit against its plain version in the kernel's
    order, two launches bit-identical, and the expanded member
    histograms from either bit-equal."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    r = np.random.default_rng(11)
    n, Fb, B, W = 400_000, 12, 255, 24
    bins = torch.from_numpy(r.integers(0, B, (Fb, n), dtype=np.uint8))
    g = torch.from_numpy(r.normal(size=n).astype(np.float32))
    h = torch.from_numpy(r.uniform(0.1, 1, n).astype(np.float32))
    leaf = torch.from_numpy(r.integers(-1, 2 * W, n).astype(np.int32))
    wl = torch.from_numpy(r.permutation(2 * W)[:W].astype(np.int32))
    args = [t.to(cuda) for t in (bins, g, h, leaf, wl)]
    k1 = hw.wave_histogram(*args, B)
    k2 = hw.wave_histogram(*args, B)
    plain = hw.plain_in_kernel_order(hw.wave_histogram_plain, *args, B)
    assert torch.equal(k1, k2)
    assert torch.equal(k1, plain)
