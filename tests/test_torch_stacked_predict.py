"""Port parity: lightgbm_tpu_torch.ops (stacked tables, binning, the forest
walk) and convert.py against lightgbm_tpu.ops.stacked_predict.

Bars: host tables, bin codes and leaf indices bit-equal; raw scores at
atol 1e-5, rtol 1e-6, because the JAX package sums each tree chunk
through a dot while the port adds tree by tree. The kernel itself runs
only on a CUDA card; here its plain version stands in, and the test
that holds the kernel against it skips without a card.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from conftest import TEST_PARAMS, fit_gbdt
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.ops import stacked_predict as jsp
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch.convert import stacked_from_numpy
from lightgbm_tpu_torch.models.gbdt import GBDT as TorchGBDT
from lightgbm_tpu_torch.ops import forest as forest_ops
from lightgbm_tpu_torch.ops import stacked_predict as tsp
from lightgbm_tpu_torch.utils import log as tlog
from lightgbm_tpu_torch.utils.log import LightGBMError

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _restore_log_levels():
    """Training with verbose=-1 lowers either package's process-wide log
    level; later tests in the same worker may read warnings, so each
    test puts both levels back."""
    levels = jlog.get_level(), tlog.get_level()
    yield
    jlog.set_level(levels[0])
    tlog.set_level(levels[1])


DATA = os.path.join(os.path.dirname(__file__), "data", "golden2")
GOLDEN = ["binary", "regl2", "regl1", "multic", "catbin", "dart", "goss",
          "contin", "rank", "wbin"]
CPU = torch.device("cpu")
TABLES = ("_offsets", "_rep_sizes", "_Wtot", "_S", "_L", "_dev_bin_ok")
JAX_LAYOUT = ("_W_host", "_P_host", "_tgt_host", "_leaf_host")
EDGE_TABLES = ("_E_f32", "_off32", "_nan_slot")


def _pair_from_text(text):
    """(JAX StackedModel, port StackedModel, JAX GBDT, port GBDT) of one
    model text."""
    jg = JaxGBDT().load_model_from_string(text)
    jg._ensure_host_trees()
    tg = TorchGBDT(device="cpu").load_model_from_string(text)
    nf = jg.max_feature_idx + 1
    jsm = jsp.StackedModel(jg.models, nf, jg.num_tree_per_iteration)
    tsm = tsp.StackedModel(tg.models, nf, tg.num_tree_per_iteration, CPU)
    assert jsm.ok and tsm.ok
    return jsm, tsm, jg, tg


def _golden_pair(name):
    with open(os.path.join(DATA, f"g2_{name}_model.txt")) as fh:
        return _pair_from_text(fh.read())


def _golden_X(name, special=True):
    X = np.fromfile(os.path.join(DATA, f"g2_{name}_X.bin"),
                    np.float64).reshape(600, 8).copy()
    if special:
        X[::7, 0] = np.nan
        X[::11, 1] = 0.0
        X[::13, 2] = -0.0
        X[::17, 3] = 1e-36
        X[::19, 4] = -np.inf
        X[::23, 5] = np.inf
    return X


@pytest.fixture(scope="module")
def trained_models():
    """Small JAX-trained models: NaN, zero-as-missing and a categorical
    feature (binary), and multiclass with NaN. Module-scoped, it runs
    before ``_restore_log_levels`` reads the levels, so it puts back
    the level its verbose=-1 training lowers itself."""
    level = jlog.get_level()
    r = np.random.default_rng(5)
    n = 1500
    X = r.normal(size=(n, 5))
    X[:, 0] = r.integers(0, 9, n)
    X[r.random(n) < 0.3, 1] = 0.0
    X[r.random(n) < 0.1, 2] = np.nan
    y = ((np.isin(X[:, 0], [1, 4, 6]) ^ (X[:, 1] > 0))
         | (X[:, 2] > 1)).astype(np.float32)
    gb = lgb.train(dict(TEST_PARAMS, objective="binary",
                        zero_as_missing=True, verbose=-1),
                   lgb.Dataset(X, y, categorical_feature=[0]),
                   num_boost_round=8).model_to_string()
    jlog.set_level(level)
    assert "num_cat=0" not in gb.split("end of trees")[0], \
        "every tree should hold a categorical split"
    yk = ((X[:, 3] > 0).astype(int) + (X[:, 4] > 0.5)).astype(np.float32)
    gm = fit_gbdt(X, yk, dict(TEST_PARAMS, objective="multiclass",
                              num_class=3), num_round=4)
    Xt = r.normal(size=(400, 5))
    Xt[:, 0] = r.integers(-1, 12, 400)
    Xt[::5, 1] = 0.0
    Xt[::7, 2] = np.nan
    Xt[::9, 0] = np.nan
    return {"catzero": (gb, Xt),
            "multic": (gm.model_to_string(), Xt)}


def _assert_tables_equal(jsm, tsm, tg):
    for name in TABLES:
        a, b = getattr(jsm, name), getattr(tsm, name)
        assert np.array_equal(a, b), name
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
    for name, b in zip(JAX_LAYOUT, tsm.jax_layout(tg.models)):
        a = getattr(jsm, name)
        assert np.array_equal(a, b) and a.dtype == b.dtype, name
    np.testing.assert_array_equal(tsm.forest.leaf.numpy(), jsm._leaf_host)
    for f, (a, b) in enumerate(zip(jsm._edges, tsm._edges)):
        assert (a is None) == (b is None) and (
            a is None or np.array_equal(a, b)), f"edges[{f}]"
    for f, (a, b) in enumerate(zip(jsm._cats, tsm._cats)):
        assert (a is None) == (b is None) and (
            a is None or np.array_equal(a, b)), f"cats[{f}]"
    if jsm._dev_bin_ok:
        for name in EDGE_TABLES:
            assert np.array_equal(getattr(jsm, name), getattr(tsm, name)), \
                name


def _assert_predictions(jsm, tsm, X):
    T = tsm.num_trees
    for first, ntree in ((0, T), (1, max(T - 2, 1))):
        np.testing.assert_array_equal(
            tsm.predict(X, first, ntree, pred_leaf=True),
            jsm.predict(X, first, ntree, pred_leaf=True))
        np.testing.assert_allclose(tsm.predict(X, first, ntree),
                                   jsm.predict(X, first, ntree),
                                   atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_tables_codes_and_predictions(name):
    jsm, tsm, _, tg = _golden_pair(name)
    _assert_tables_equal(jsm, tsm, tg)
    X = _golden_X(name)
    np.testing.assert_array_equal(tsm._bin_rows(X), jsm._bin_rows(X))
    _assert_predictions(jsm, tsm, X)                 # host binning
    if tsm._dev_bin_ok:
        _assert_predictions(jsm, tsm,                # device binning
                            X.astype(np.float32).astype(np.float64))


@pytest.mark.parametrize("kind", ["catzero", "multic"])
def test_trained_tables_and_predictions(trained_models, kind):
    text, Xt = trained_models[kind]
    jsm, tsm, _, tg = _pair_from_text(text)
    _assert_tables_equal(jsm, tsm, tg)
    np.testing.assert_array_equal(tsm._bin_rows(Xt), jsm._bin_rows(Xt))
    _assert_predictions(jsm, tsm, Xt)


@pytest.mark.parametrize("name", ["binary", "regl2", "goss"])
def test_device_binning_codes_bit_equal(name):
    """codes_from_x (one searchsorted per feature) equals the JAX
    package's sum(x > E) and the host float64 binning, including NaN,
    +-0.0, +-inf and values on and next to every f32 edge."""
    jsm, tsm, _, _ = _golden_pair(name)
    E = tsm._E_f32
    finite = E[np.isfinite(E)]
    vals = np.concatenate([
        finite, np.nextafter(finite, np.inf), np.nextafter(finite, -np.inf),
        [np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-36, -1e-36]]).astype(
            np.float32)
    F = E.shape[0]
    x = np.resize(vals, (len(vals) * 2 // F + F) * F).reshape(-1, F)
    x = np.concatenate([x, _golden_X(name).astype(np.float32)])
    got = tsp.codes_from_x(torch.from_numpy(x), *tsm.edges).numpy()
    want = np.asarray(jsp._codes_from_x(jnp.asarray(x),
                                        jnp.asarray(jsm._E_f32),
                                        jnp.asarray(jsm._off32),
                                        jnp.asarray(jsm._nan_slot)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tsm._bin_rows(
        x.astype(np.float64)).T)


@pytest.mark.parametrize("name", ["binary", "multic", "catbin"])
def test_convert_carries_jax_tables(name):
    """The port scores from the JAX StackedModel's own host arrays
    (convert.py) and matches the JAX scan (_run_chunk): leaf indices bit
    for bit, raw scores at atol 1e-5, rtol 1e-6. The tables carried
    across equal the ones the port builds from the model text."""
    jsm, tsm, jg, _ = _golden_pair(name)
    arrays = {k: getattr(jsm, k, None)
              for k in JAX_LAYOUT + TABLES + EDGE_TABLES}
    arrays["num_class"] = jsm.num_class
    for key in ("split_feature", "left_child", "right_child"):
        arrays[key] = [getattr(t, key)[:t.num_leaves - 1]
                       for t in jg.models]
    forest, edges = stacked_from_numpy(arrays, device="cpu")
    assert (edges is None) == (not jsm._dev_bin_ok)
    for field in ("nodes", "dec", "leaf", "root"):
        assert torch.equal(getattr(forest, field),
                           getattr(tsm.forest, field)), field
    np.testing.assert_array_equal(forest.depth, tsm.forest.depth)
    X = _golden_X(name)
    codes = jsm._bin_rows(X)
    T = jsm.num_trees
    dev = jsm._device_arrays(0, T)
    want_leaf = np.asarray(jsp._run_chunk(jnp.asarray(codes), *dev,
                                          jsm._Wtot, True))[:, :T]
    want = np.asarray(jsp._run_chunk(jnp.asarray(codes), *dev,
                                     jsm._Wtot, False))
    codes_t = torch.from_numpy(np.ascontiguousarray(codes.T))
    got_leaf = forest_ops.forest_predict(codes_t, forest, 0, T,
                                         leaf_mode=True).numpy()
    got = forest_ops.forest_predict(codes_t, forest, 0, T).numpy()
    np.testing.assert_array_equal(got_leaf, want_leaf)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    if edges is not None:
        x32 = X.astype(np.float32)
        np.testing.assert_array_equal(
            tsp.codes_from_x(torch.from_numpy(x32), *edges).numpy(),
            np.asarray(jsp._codes_from_x(
                jnp.asarray(x32), jnp.asarray(jsm._E_f32),
                jnp.asarray(jsm._off32), jnp.asarray(jsm._nan_slot))))


def test_plain_walk_matches_pallas_kernel_interpret():
    """The JAX package's TPU kernel (interpret mode, as its own tests run
    it off-TPU) and the port's plain walk score the same rows alike."""
    jsm, tsm, _, _ = _golden_pair("binary")
    X = _golden_X("binary")[:256]
    want = jsm.predict(X, 2, 11, use_pallas=True)
    np.testing.assert_allclose(tsm.predict(X, 2, 11), want, atol=1e-5,
                               rtol=1e-6)


def test_single_leaf_and_padded_trees():
    """A single-leaf tree walks to leaf 0; trees smaller than the widest
    keep padded leaves that no row reaches."""
    text = open(os.path.join(DATA, "g2_binary_model.txt")).read()
    head, rest = text.split("Tree=0\n", 1)
    stump = ("Tree=0\nnum_leaves=1\nnum_cat=0\nsplit_feature=\n"
             "split_gain=\nthreshold=\ndecision_type=\nleft_child=\n"
             "right_child=\nleaf_value=0.25\nleaf_count=600\n"
             "internal_value=\ninternal_count=\nshrinkage=1\n\n\n")
    jsm, tsm, _, _ = _pair_from_text(head + stump + "Tree=0\n" + rest)
    X = _golden_X("binary")
    leaves = tsm.predict(X, pred_leaf=True)
    assert (leaves[:, 0] == 0).all()
    np.testing.assert_array_equal(leaves, jsm.predict(X, pred_leaf=True))
    np.testing.assert_allclose(tsm.predict(X), jsm.predict(X), atol=1e-5,
                               rtol=1e-6)


def test_malformed_children_are_refused():
    """Child pointers that do not form a tree would never end the walk;
    the stacker refuses them before anything reaches a device."""
    tg = TorchGBDT(device="cpu").load_model_from_string(
        open(os.path.join(DATA, "g2_binary_model.txt")).read())
    tg.models[3].left_child[1] = 0        # node 1 loops back to the root
    with pytest.raises(LightGBMError, match="malformed"):
        tg.predict_raw(_golden_X("binary"))


def test_forest_predict_checks_inputs():
    _, tsm, _, _ = _golden_pair("binary")
    codes = torch.from_numpy(np.ascontiguousarray(
        tsm._bin_rows(_golden_X("binary")).T))
    with pytest.raises(LightGBMError, match="int32"):
        forest_ops.forest_predict(codes.long(), tsm.forest, 0, 3)
    with pytest.raises(LightGBMError, match="features"):
        forest_ops.forest_predict(codes[:4], tsm.forest, 0, 3)
    with pytest.raises(LightGBMError, match="range"):
        forest_ops.forest_predict(codes, tsm.forest, 0, 10_000)


def test_kernel_bit_equal_to_plain_on_card():
    """The CUDA kernel against its plain version on the card, scores and
    leaf indices bit for bit (the launch count shows the kernel ran)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the forest kernel has no CPU mode")
    _, tsm, _, _ = _golden_pair("multic")
    dev = torch.device("cuda:0")
    codes = torch.from_numpy(np.ascontiguousarray(
        tsm._bin_rows(_golden_X("multic")).T))
    fc = tsm.forest.to(dev)
    T = tsm.num_trees
    before = forest_ops.launches.value
    for leaf_mode in (False, True):
        got = forest_ops.forest_predict(codes.to(dev), fc, 1, T - 1,
                                        leaf_mode=leaf_mode).cpu()
        want = forest_ops.forest_predict_plain(codes, tsm.forest, 1, T - 1,
                                               leaf_mode=leaf_mode)
        assert torch.equal(got, want)
    assert forest_ops.launches.value == before + 2
