"""Port parity: lightgbm_tpu_torch.ops (stacked tables, binning, the forest
walk) and convert.py against lightgbm_tpu.ops.stacked_predict.

Bars: host tables, bin codes and leaf indices bit-equal; raw scores at
atol 1e-5, rtol 1e-6, because the JAX package sums each tree chunk
through a dot while the port adds tree by tree. The kernel itself runs
only on a CUDA card; here its plain version stands in. On the CPU the
kernel's compact tables are held against the decision rows they were
built from (every node at every code), walked as the kernel reads them
(``_walk_compact``) bit for bit against the plain version, and its
launch plan (``forest_plan``) against the limits it was made from at odd
shapes. The tests that hold the kernel against the plain version skip
without a card (on a card without JAX: ``pytest --noconftest
tests/test_torch_stacked_predict.py -k card``).
"""
import os

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    import lightgbm_tpu as lgb
    from conftest import TEST_PARAMS, fit_gbdt
    from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
    from lightgbm_tpu.ops import stacked_predict as jsp
    from lightgbm_tpu.utils import log as jlog
except ImportError:
    # a machine with a card and no JAX runs the card tests alone:
    # pytest --noconftest tests/test_torch_stacked_predict.py -k card
    jlog = None
from lightgbm_tpu_torch.convert import stacked_from_numpy
from lightgbm_tpu_torch.models.gbdt import GBDT as TorchGBDT
from lightgbm_tpu_torch.ops import forest as forest_ops
from lightgbm_tpu_torch.ops import stacked_predict as tsp
from lightgbm_tpu_torch.testing import random_model_text
from lightgbm_tpu_torch.utils import log as tlog
from lightgbm_tpu_torch.utils.log import LightGBMError

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread a test worker, restored after: under parallel
    workers on a shared CPU, each small op's thread pool only contends
    (as in test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_log_levels():
    """Training with verbose=-1 lowers either package's process-wide log
    level; later tests in the same worker may read warnings, so each
    test puts both levels back."""
    levels = jlog and jlog.get_level(), tlog.get_level()
    yield
    if jlog:
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
    for field in ("nodes", "dec", "leaf"):
        assert torch.equal(getattr(forest, field),
                           getattr(tsm.forest, field)), field
    np.testing.assert_array_equal(forest.root_host, tsm.forest.root_host)
    assert torch.equal(forest.walk.root, tsm.forest.walk.root)
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


# -- the kernel's compact tables and launch plan ------------------------------

# odd shapes: (trees, leaves, classes, first, last from the end, rows,
# features); "u16" has a feature of more than 256 codes
SHAPES = {
    "1tree": (1, 15, 1, 0, 0, 1000, 5),
    "31trees": (31, 15, 1, 0, 0, 1000, 5),
    "33trees": (33, 15, 1, 0, 0, 1000, 5),
    "K3": (34, 15, 3, 0, 0, 1000, 5),
    "first5": (70, 15, 1, 5, 1, 1000, 5),
    "N1": (40, 15, 1, 0, 0, 1, 5),
    "N262145": (40, 15, 1, 0, 0, 262_145, 5),
    "u16": (64, 63, 1, 0, 0, 1007, 2),
}
_models = {}


def _port_model(text):
    """(port StackedModel, its GBDT) of one model text, without JAX."""
    tg = TorchGBDT(device="cpu").load_model_from_string(text)
    sm = tg._stacked_model()
    assert sm is not None and sm.ok
    return sm, tg


def _shape_model(name):
    """A random model of SHAPES[name] (``random_model_text``: every
    missing type, default directions mixed) and codes of its rows."""
    if name not in _models:
        T, leaves, K, _, _, n, F = SHAPES[name]
        r = np.random.default_rng(len(name))
        X = r.normal(size=(3000, F))
        obj = "binary sigmoid:1" if K == 1 else f"multiclass num_class:{K}"
        sm, tg = _port_model(random_model_text(X, T, leaves, len(name),
                                               objective=obj))
        X[::7, 0] = np.nan
        X[::5, -1] = 0.0
        X = np.resize(X, (n, F))
        _models[name] = sm, tg, torch.from_numpy(
            np.ascontiguousarray(sm._bin_rows(X).T))
    return _models[name]


def _node_lists(models):
    return tuple([np.asarray(getattr(t, key)[:t.num_leaves - 1], np.int64)
                  for t in models]
                 for key in ("split_feature", "left_child", "right_child"))


def _rebuilt_walk(sm, tg, wide):
    """The model's compact tables built again with ``wide`` records."""
    f = sm.forest
    return tsp._compact_tables(*_node_lists(tg.models), f.dec.numpy(),
                               sm._rep_sizes, f.leaf.numpy(), f.root_host,
                               sm._offsets, sm._zero_bands(sm._reps), wide,
                               CPU)


def _walk_compact(codes, walk, first, last, K, leaf_mode=False):
    """The kernel's arithmetic in numpy, reading what it reads: codes
    staged through the feature table, the tree-interleaved records and
    leaf values, the bitset words; sums in model order."""
    codes = codes.numpy().astype(np.int64)
    n = codes.shape[1]
    nan_v = (1 << 8 * walk.code_bytes) - 1
    staged = []
    for f, off, w, band in walk.feat.numpy().astype(np.int64):
        c = np.clip(codes[f] - off, 0, w - 1)
        v = np.where(c == w - 1, nan_v, c)
        if band >= 0:
            v = np.where((c != w - 1) & (c >= band & 0xFFFF)
                         & (c <= band >> 16), nan_v - 1, v)
        staged.append(v)
    staged = np.array(staged).reshape(-1, n)
    rec, leafc = walk.rec.numpy(), walk.leaf.numpy()
    bits = walk.bits.numpy().view(np.uint32).astype(np.int64)
    base = walk.bits_base.numpy().astype(np.int64)
    if leaf_mode:
        out = np.zeros((n, last - first), np.int32)
    else:
        out = np.zeros((n, K), np.float32)
    rows = np.arange(n)
    for t in range(first, last):
        c, j = divmod(t, 32)
        node = np.full(n, walk.root.numpy()[t], np.int64)
        while (node >= 0).any():
            live = node >= 0
            r = rec[c, node[live], j]
            if walk.rec_bytes == 8:
                u = r.view(np.uint64)
                lo, hi = u & 0xFFFFFFFF, (u >> 32).astype(np.int64)
                left = (lo & 0xFFFF).astype(np.uint16).view(np.int16)
                right = (lo >> 16).astype(np.uint16).view(np.int16)
                slot, meta = (hi & 0xFFFF) // walk.code_bytes, hi >> 16
            else:
                left, right = r[:, 0], r[:, 1]
                slot = r[:, 2] // walk.code_bytes
                meta = r[:, 3].view(np.uint32).astype(np.int64)
            v = staged[slot, rows[live]]
            pay = meta >> 3
            word = bits[np.minimum(base[t] + pay + (v >> 5), bits.size - 1)]
            go = np.where(v == nan_v, meta & 1,
                          np.where(v == nan_v - 1, meta >> 1 & 1,
                                   np.where(meta & 4, word >> (v & 31) & 1,
                                            v < pay)))
            node[live] = np.where(go != 0, left, right)
        if leaf_mode:
            out[:, t - first] = ~node
        else:
            out[:, t % K] += leafc[c, ~node, j]
    return torch.from_numpy(out)


def _assert_compact_walks_as_plain(sm, tg, codes, first, last):
    for wide in (None, True):
        walk = sm.forest.walk if wide is None else _rebuilt_walk(sm, tg, wide)
        assert walk.rec_bytes == (16 if wide else 8)
        for leaf_mode in (False, True):
            want = forest_ops.forest_predict_plain(
                codes, sm.forest, first, last, leaf_mode)
            got = _walk_compact(codes, walk, first, last,
                                sm.forest.num_class, leaf_mode)
            assert torch.equal(got, want), (wide, leaf_mode)


@pytest.mark.parametrize("name", GOLDEN)
def test_compact_tables_decide_as_rows_golden(name):
    """Every record of a golden2 model decides as its decision row at
    every code (``check_compact``, run again here on both record widths),
    and the tables, read as the kernel reads them, score and place the
    golden rows (NaN, +-0, 1e-36, +-inf among them) as the plain version
    does, bit for bit, over the whole range and [1, T - 1)."""
    with open(os.path.join(DATA, f"g2_{name}_model.txt")) as fh:
        sm, tg = _port_model(fh.read())
    feats, lefts, rights = _node_lists(tg.models)
    tsp.check_compact(sm.forest.walk, sm.forest.dec.numpy(), feats, lefts,
                      rights)
    tsp.check_compact(_rebuilt_walk(sm, tg, True), sm.forest.dec.numpy(),
                      feats, lefts, rights)
    codes = torch.from_numpy(np.ascontiguousarray(
        sm._bin_rows(_golden_X(name)).T))
    T = sm.num_trees
    _assert_compact_walks_as_plain(sm, tg, codes, 0, T)
    _assert_compact_walks_as_plain(sm, tg, codes, 1, max(T - 1, 2))


@pytest.mark.parametrize("kind", ["catzero", "multic"])
def test_compact_tables_decide_as_rows_trained(trained_models, kind):
    """The same on the JAX-trained models: a categorical feature with
    zero-as-missing nodes (their zero band staged apart), multiclass;
    and on tables built from the JAX package's own W (``walk_tables``,
    which knows no zero band: its zero-as-missing rows become
    thresholds or bitset rows)."""
    text, Xt = trained_models[kind]
    jsm, tsm, jg, tg = _pair_from_text(text)
    codes = torch.from_numpy(np.ascontiguousarray(tsm._bin_rows(Xt).T))
    _assert_compact_walks_as_plain(tsm, tg, codes, 0, tsm.num_trees)
    feats, lefts, rights = _node_lists(jg.models)
    forest = tsp.walk_tables(jsm._W_host, jsm._leaf_host, jsm._offsets,
                             jsm._rep_sizes, feats, lefts, rights,
                             num_class=jsm.num_class, device=CPU)
    for leaf_mode in (False, True):
        assert torch.equal(
            _walk_compact(codes, forest.walk, 0, tsm.num_trees,
                          jsm.num_class, leaf_mode),
            forest_ops.forest_predict_plain(codes, tsm.forest, 0,
                                            tsm.num_trees, leaf_mode))


@pytest.mark.parametrize("name", list(SHAPES))
def test_compact_tables_decide_as_rows_random(name):
    """The same on random models of the odd shapes (every missing type,
    zero bands, u16 codes where a feature has more than 256)."""
    sm, tg, codes = _shape_model(name)
    T, _, _, first, back, _, _ = SHAPES[name]
    assert sm.forest.walk.code_bytes == (2 if name == "u16" else 1)
    _assert_compact_walks_as_plain(sm, tg, codes[:, :3000], first, T - back)


def test_compact_check_raises_on_a_forged_record():
    """A record that decides otherwise than its row at one code (its NaN
    decision flipped) is refused, and so is a row holding a value other
    than 0 or 1."""
    with open(os.path.join(DATA, "g2_binary_model.txt")) as fh:
        sm, tg = _port_model(fh.read())
    walk = sm.forest.walk
    feats, lefts, rights = _node_lists(tg.models)
    rec = walk.rec.clone()
    rec[0, 0, 0] ^= 1 << 48                 # meta bit 0: the NaN decision
    with pytest.raises(LightGBMError, match="decides"):
        tsp.check_compact(walk._replace(rec=rec), sm.forest.dec.numpy(),
                          feats, lefts, rights)
    dec = sm.forest.dec.numpy().copy()
    dec[0, 0, 0] = 2
    with pytest.raises(LightGBMError, match="0 and 1"):
        tsp.compact_tables(feats, lefts, rights, dec, sm._rep_sizes,
                           sm.forest.leaf.numpy(), sm.forest.root_host,
                           sm._offsets, device=CPU)


def _plan_cases():
    """(name, plan arguments) at the odd shapes (both record widths and
    modes) and at shapes that push each limit: trees too large for
    shared memory, many features, many classes."""
    cases = []
    for name, (T, leaves, K, first, back, n, F) in SHAPES.items():
        for rb in (8, 16):
            for score in (True, False):
                cases.append((f"{name}-{rb}-{'score' if score else 'leaf'}",
                              (n, first, T - back, leaves - 1, leaves, F, K,
                               2 if name == "u16" else 1, rb, score,
                               T == 1)))
    cases += [("big_trees", (500_000, 0, 100, 2047, 2048, 28, 1, 2, 8, True,
                             False)),
              ("higgs", (262_144, 0, 500, 254, 255, 28, 1, 2, 8, True,
                         False)),
              ("lrb", (65_536, 0, 50, 30, 31, 53, 1, 1, 8, True, False)),
              ("airline", (262_144, 0, 10, 254, 255, 8, 1, 2, 8, True,
                           True)),
              ("features", (10_000, 0, 64, 30, 31, 9000, 1, 2, 16, True,
                            False)),
              ("classes", (10_000, 3, 300, 30, 31, 10, 100, 1, 8, True,
                           False))]
    return cases


@pytest.mark.parametrize("name,args", _plan_cases(),
                         ids=[c[0] for c in _plan_cases()])
def test_forest_plan_fits_its_limits(name, args):
    """forest_plan's launch fits the limits it was made from: shared
    memory within a block's and the planned blocks' share of an SM,
    whole batches of rows for every warp, tiles covering every row, the
    range's chunks resident, one slot or read from global memory;
    batches of 8 rows for a range walked in groups, else 16 (fewer only
    where they do not fit)."""
    n, first, last, S, L, Fu, K, cb, rb, score, grouped = args
    p = forest_ops.forest_plan(n, first, last, S, L, Fu, K, cb, rb, score,
                               grouped)
    batch = forest_ops.BATCH_GROUPED if grouped else forest_ops.BATCH
    assert p.batch == batch or (name == "features" and p.batch < batch)
    assert p.smem == forest_ops.smem_bytes(S, L, Fu, K, cb, rb, score,
                                           p.warps, p.batch, p.rows,
                                           p.buffers)
    assert p.smem <= forest_ops.SMEM_MAX
    assert p.smem + forest_ops.SMEM_RESERVED <= forest_ops.SMEM_PER_SM
    assert 1 <= p.warps <= forest_ops.WARPS and 1 <= p.batch <= 32
    assert p.rows >= p.warps * p.batch and p.rows % (p.warps * p.batch) == 0
    assert p.tiles == -(-n // p.rows)
    assert p.chunks == len(range(first // 32, (last - 1) // 32 + 1))
    assert p.buffers in (p.chunks, 1, 0)
    # the rows shared evenly over the SMs' rounds of tiles, to a unit
    rounds = -(-p.tiles // forest_ops.NUM_SMS)
    assert p.rows < -(-n // (forest_ops.NUM_SMS * rounds)) \
        + p.warps * p.batch
    if name == "big_trees":
        assert p.buffers == 0
    if name == "higgs":
        assert (p.buffers, p.warps, p.code_bytes) == (1, 32, 2)
    if name == "lrb":
        assert p.buffers == p.chunks == 2 and p.warps == 32
    if name == "airline":
        assert p.buffers == p.chunks == 1 and p.warps == 32


@pytest.mark.parametrize("name,first,last,grouped", [
    ("1tree", 0, 1, True), ("33trees", 0, 33, False),
    ("33trees", 32, 33, True), ("33trees", 31, 33, False),
    ("K3", 32, 34, True), ("K3", 33, 34, False), ("31trees", 0, 31, False)])
def test_plan_for_groups_only_a_whole_last_chunk(name, first, last,
                                                 grouped):
    """plan_for gives the grouped batch exactly where the kernel walks
    the range in groups of rows: the range is the model's last chunk of
    m <= 16 trees, all of them."""
    sm, _, codes = _shape_model(name)
    p = forest_ops.plan_for(sm.forest, codes.shape[1], first, last)
    assert p.batch == (forest_ops.BATCH_GROUPED if grouped
                       else forest_ops.BATCH)


def test_card_plan_reads_the_library_queries():
    """launch_plan's step on the card (utils.device.card_plan) with the
    library's queries stood in by C functions of the same kind (ctypes
    function pointers, as the library's are): the plan's bytes must
    equal the library's, the grid is one round of resident blocks or the
    tiles, and a repeated query is answered from the cache."""
    import ctypes
    from lightgbm_tpu_torch.utils import device as device_mod
    libc = ctypes.CDLL(None)
    libc.abs.argtypes, libc.abs.restype = [ctypes.c_int], ctypes.c_int
    p = forest_ops.forest_plan(262_144, 0, 500, 254, 255, 28, 1, 2, 8, True)
    dev = torch.device("cpu")
    device_mod._sms[dev.index] = forest_ops.NUM_SMS
    try:
        got = device_mod.card_plan(p, p.tiles, dev, (libc.abs, p.smem),
                                   (libc.abs, 1))
        assert got["grid"] == min(p.tiles, forest_ops.NUM_SMS)
        assert got["blocks_per_sm"] == 1 and got["smem"] == p.smem
        assert device_mod.card_plan(p, p.tiles, dev, (libc.abs, p.smem),
                                    (libc.abs, 1)) is got
        with pytest.raises(LightGBMError, match="shared memory"):
            device_mod.card_plan(p, p.tiles, dev, (libc.abs, p.smem + 16),
                                 (libc.abs, 2))
        with pytest.raises(LightGBMError, match="fits no SM"):
            device_mod.card_plan(p, p.tiles, dev, (libc.abs, p.smem),
                                 (libc.abs, 0))
    finally:
        device_mod._sms.pop(dev.index)


# -- the kernel: only on a CUDA card -----------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the forest kernel has no CPU mode")
    return torch.device("cuda:0")


def _card_case(case):
    """(StackedModel, GBDT, host codes, first, last, walk, plan override)
    of a card case."""
    shape, _, over = case.partition("_")
    if shape in SHAPES:
        sm, tg, codes = _shape_model(shape)
        T, _, _, first, back, _, _ = SHAPES[shape]
        walk = _rebuilt_walk(sm, tg, True) if "wide" in over else None
        plan = {"global": {"buffers": 0}, "double": {"buffers": 2},
                "single": {"buffers": 1}, "wide": {"buffers": 1}}
        return sm, tg, codes, first, T - back, walk, plan.get(over, {})
    if case == "stump":
        text = open(os.path.join(DATA, "g2_binary_model.txt")).read()
        head, rest = text.split("Tree=0\n", 1)
        stump = ("Tree=0\nnum_leaves=1\nnum_cat=0\nsplit_feature=\n"
                 "split_gain=\nthreshold=\ndecision_type=\nleft_child=\n"
                 "right_child=\nleaf_value=0.25\nleaf_count=600\n"
                 "internal_value=\ninternal_count=\nshrinkage=1\n\n\n")
        text = head + stump + "Tree=0\n" + rest
        name = "binary"
    else:
        name = case.split("_")[0]
        text = open(os.path.join(DATA, f"g2_{name}_model.txt")).read()
    sm, tg = _port_model(text)
    codes = torch.from_numpy(np.ascontiguousarray(
        sm._bin_rows(np.resize(_golden_X(name), (4099, 8))).T))
    T = sm.num_trees
    first, last = (1, T - 1) if case == "multic_range" else (0, T)
    walk = _rebuilt_walk(sm, tg, True) if case == "binary_wide" else None
    return sm, tg, codes, first, last, walk, {}


@pytest.mark.parametrize("case", ["multic_range", "catbin", "stump",
                                  "binary_wide", "first5_global",
                                  "first5_double", "first5_single",
                                  "u16_wide", *SHAPES])
def test_kernel_bit_equal_to_plain_on_card(cuda, case):
    """The CUDA kernel against its plain version on the card, scores and
    leaf indices bit for bit (the launch count shows the kernel ran): K
    > 1 over [1, T - 1), categorical bitsets, single-leaf and padded
    trees, 16-byte records (with chunks loaded one at a time), records
    read from global memory, chunks double- and single-buffered over a
    range of three chunks that starts off a chunk boundary, and
    forest_plan's own plan at every odd shape (one tree, 31 and 33 trees,
    K = 3 with T not a multiple of K, ``first`` off a chunk boundary, N =
    1 and 262,145, u16 codes), which the library must accept."""
    sm, tg, codes, first, last, walk, over = _card_case(case)
    fc = sm.forest.to(cuda)
    if walk is not None:
        fc = fc._replace(walk=walk.to(cuda))
    w = fc.walk
    S, L, Fu = w.rec.shape[1], w.leaf.shape[1], w.feat.shape[0]
    codes_d = codes.to(cuda)
    before = forest_ops.launches.value
    for leaf_mode in (False, True):
        plan = None
        if over:
            plan = forest_ops._plan(
                codes.shape[1], first, last, S, L, Fu, fc.num_class,
                w.code_bytes, w.rec_bytes, not leaf_mode, **over)
        got = forest_ops._predict(codes_d, fc, first, last, leaf_mode, plan)
        want = forest_ops.forest_predict_plain(codes_d, fc, first, last,
                                               leaf_mode=leaf_mode)
        assert torch.equal(got.cpu(), want.cpu()), leaf_mode
    assert forest_ops.launches.value == before + 2
