"""Port parity for refit, SHAP contributions, model dumps and edits, and
the C entry points of this slice: lightgbm_tpu_torch (``device="cpu"``)
against the JAX package on the CPU, on the same numpy inputs made from a
seed (1,280 rows x 8, 15 leaves, max_bin 63: one XLA compile a shape).

Refit's order of addition. The JAX package's ``refit_one``
(models/gbdt.py:2263-2268) sums each leaf's g and h with
``zeros(L).at[leaf].add(g)`` and ``full(L, KEPSILON).at[leaf].add(h)``,
an XLA scatter: on the CPU it adds the rows serially in row order
(``test_xla_scatter_add_is_serial_in_row_order`` confirms it against
numpy's unbuffered ``np.add.at``). The port's plain path (CPU tensors,
ops/refit.py ``leaf_sums``) is the same serial loop (``index_add_``), and
follows XLA's rounding of the blend (``fma(decay, old, (1 - decay) *
new)``, or at decay 0.5 XLA's factored ``(old + out * shrink) * 0.5``
with the shrinkage contracted), so its leaf outputs are bit-equal to the
JAX package's: model texts byte-equal up to the parameters block. The
card sums each leaf's stably sorted rows in XLA's order of a reduction
(``sorted_leaf_sums``), the same on every run; it differs from the
serial sums by at most ``sum_bound``, the f32 rounding of two orders of
addition (2 gamma(n + 1) times the leaf's sum of |g|, or of h), which
``test_sorted_leaf_sums_within_bound`` holds here and the card test on
the card.

Other bars: SHAP contributions within 1e-12 of the JAX package's (the
same float64 TreeSHAP), rows summing to the raw score within 1e-5;
``dump_model`` equal; leaf edits, shuffles (the JAX seed), subsets of
whole queries and sampled-column datasets with pushed rows giving the
JAX package's model texts; a pickled Booster's model text unchanged.
On a card without JAX: ``pytest --noconftest tests/test_torch_refit.py
-k card``.
"""
import pickle

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    import lightgbm_tpu as lgb
    from lightgbm_tpu import capi as jcapi
    from lightgbm_tpu.utils import log as jlog
except ImportError:
    # a machine with a card and no JAX runs the card test alone:
    # pytest --noconftest tests/test_torch_refit.py -k card
    jax = jnp = lgb = jcapi = jlog = None
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.ops.refit import (leaf_sums, refit_leaf_outputs,
                                          sorted_leaf_sums, sum_bound)
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port

N, F = 1280, 8
PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 5, "verbose": -1}
OBJ_PARAMS = {"binary": {},
              "regression": {"objective": "regression"},
              "multiclass": {"objective": "multiclass", "num_class": 3}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_log_levels():
    level = tlog.get_level()
    jlevel = jlog.get_level() if jlog is not None else None
    yield
    tlog.set_level(level)
    if jlog is not None:
        jlog.set_level(jlevel)


def _rows(seed, shift=0.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F)) + shift
    lin = X[:, 0] + 0.5 * X[:, 1] - X[:, 2] * X[:, 3]
    return X, lin, rng


def _labels(objective, lin, rng):
    if objective == "binary":
        return (lin + rng.normal(0, 0.5, N) > 0).astype(float)
    if objective == "multiclass":
        return np.digitize(lin, [-0.5, 0.5]).astype(float)
    return lin + rng.normal(0, 0.3, N)


@pytest.fixture(scope="module")
def models():
    """Per objective: its params, the JAX model's text (6 iterations on
    the train rows), and shifted rows and labels for the refit."""
    out = {}
    for objective, extra in OBJ_PARAMS.items():
        params = {**PARAMS, **extra}
        X, lin, rng = _rows(0)
        y = _labels(objective, lin, rng)
        text = lgb.train(dict(params), lgb.Dataset(X, label=y),
                         6).model_to_string()
        X2, lin2, rng2 = _rows(1, shift=0.3)
        out[objective] = (params, text, X, X2, _labels(objective, lin2,
                                                       rng2))
    return out


def _body(text: str) -> str:
    return text[:text.index("\nparameters:")]


def _leaf_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("leaf_value=")]


# -- refit -------------------------------------------------------------------

def test_xla_scatter_add_is_serial_in_row_order():
    """The JAX refit's jitted scatter-add on the CPU adds in row order:
    equal to numpy's serial ``np.add.at`` and to the port's plain
    ``leaf_sums``, on values of mixed magnitude whose sums round by their
    order."""
    rng = np.random.default_rng(2)
    L = 15
    leaf = rng.integers(0, L, 5000).astype(np.int32)
    g = (rng.standard_normal(5000)
         * 10.0 ** rng.integers(-3, 4, 5000)).astype(np.float32)
    h = rng.random(5000).astype(np.float32)
    xla = jax.jit(lambda i, v, w: (jnp.zeros(L, jnp.float32).at[i].add(v),
                                   jnp.full(L, 1e-15, jnp.float32)
                                   .at[i].add(w)))
    sg_x, sh_x = (np.asarray(a) for a in xla(leaf, g, h))
    sg_np = np.zeros(L, np.float32)
    np.add.at(sg_np, leaf, g)
    sh_np = np.full(L, np.float32(1e-15), np.float32)
    np.add.at(sh_np, leaf, h)
    sg_t, sh_t = leaf_sums(*(torch.from_numpy(a) for a in (leaf, g, h)), L)
    np.testing.assert_array_equal(sg_x, sg_np)
    np.testing.assert_array_equal(sh_x, sh_np)
    np.testing.assert_array_equal(sg_t.numpy(), sg_x)
    np.testing.assert_array_equal(sh_t.numpy(), sh_x)


def test_sorted_leaf_sums_within_bound():
    """The card's sums (stable sort by leaf, XLA's reduction order), run
    here on CPU tensors: the same bits twice, and within ``sum_bound`` of
    the serial sums."""
    rng = np.random.default_rng(3)
    L = 31
    leaf = torch.from_numpy(rng.integers(0, L - 3, 20000).astype(np.int32))
    g = torch.from_numpy((rng.standard_normal(20000)
                          * 10.0 ** rng.integers(-3, 3, 20000))
                         .astype(np.float32))
    h = torch.from_numpy(rng.random(20000).astype(np.float32))
    a = sorted_leaf_sums(leaf, g, h, L)
    b = sorted_leaf_sums(leaf, g, h, L)
    serial = leaf_sums(leaf, g, h, L)
    n = np.bincount(leaf.numpy(), minlength=L)
    for (s, t, x), v in zip(zip(a, b, serial), (g, h)):
        assert torch.equal(s, t)
        abs_sum = np.bincount(leaf.numpy(), np.abs(v.numpy().astype(
            np.float64)), minlength=L)
        d = np.abs(s.numpy().astype(np.float64) - x.numpy())
        assert (d <= sum_bound(n, abs_sum) + 1e-15).all()
    assert not torch.equal(a[0], serial[0])   # the orders do part here


@pytest.mark.parametrize("objective,decay", [
    ("binary", 0.9), ("binary", 0.5), ("binary", 0.0), ("regression", 0.9),
    ("regression", 0.3), ("multiclass", 0.9)])
def test_refit_matches_jax(models, objective, decay):
    """``Booster.refit`` on shifted rows: the model text byte-equal to the
    JAX package's ``refit_existing`` up to its parameters."""
    params, text, _, X2, y2 = models[objective]
    j = lgb.Booster(params=dict(params), model_str=text).refit(
        X2, y2, decay_rate=decay)
    t = lgt.Booster(params=dict(params), model_str=text, device="cpu") \
        .refit(X2, y2, decay_rate=decay)
    assert _body(t.model_to_string()) == _body(j.model_to_string())
    np.testing.assert_allclose(t.predict(X2, raw_score=True),
                               j.predict(X2, raw_score=True), rtol=0,
                               atol=1e-5)


def test_refit_decay_one_is_identity(models):
    """decay_rate=1 keeps every leaf output (FitByExistingTree's blend,
    serial_tree_learner.cpp:243; tests/test_refit_predearly.py:37)."""
    params, text, X, X2, y2 = models["binary"]
    bst = lgt.Booster(params=dict(params), model_str=text, device="cpu")
    same = bst.refit(X2, y2, decay_rate=1.0)
    assert _leaf_lines(same.model_to_string()) == _leaf_lines(text)


def test_refit_improves_on_shifted_data(models):
    """tests/test_refit_predearly.py:21 on the port."""
    params, text, _, X2, y2 = models["binary"]
    bst = lgt.Booster(params=dict(params), model_str=text, device="cpu")

    def logloss(p):
        p = np.clip(p, 1e-12, 1 - 1e-12)
        return float(-np.mean(y2 * np.log(p) + (1 - y2) * np.log(1 - p)))

    r = bst.refit(X2, y2, decay_rate=0.5)
    assert r.num_trees() == bst.num_trees()
    assert logloss(r.predict(X2)) < logloss(bst.predict(X2))


def test_capi_refit_matches_jax(models):
    """``LGBM_BoosterRefit`` after ``LGBM_BoosterResetTrainingData`` on a
    loaded model, against the JAX package's."""
    params, text, _, X2, y2 = models["binary"]
    texts = []
    for capi, kw in ((jcapi, {}), (tcapi, {"device": "cpu"})):
        ds = capi.LGBM_DatasetCreateFromMat(X2, parameters=params, **kw)
        capi.LGBM_DatasetSetField(ds, "label", y2)
        h = capi.LGBM_BoosterLoadModelFromString(text, **kw)
        h.cfg.set({k: str(v) for k, v in params.items()})
        capi.LGBM_BoosterResetTrainingData(h, ds)
        capi.LGBM_BoosterRefit(h)
        texts.append(capi.LGBM_BoosterSaveModelToString(h))
    assert _body(texts[1]) == _body(texts[0])


def test_refit_on_card():
    """On the card: the same bits on every run, each leaf's output within
    the f32 bound of the plain (serial) sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(4)
    L = 31
    leaf = rng.integers(0, L, 65536).astype(np.int32)
    g = rng.standard_normal(65536).astype(np.float32)
    h = rng.random(65536).astype(np.float32)
    old = (rng.standard_normal(L) * 0.1).astype(np.float32)
    args = (0.0, 0.0, 0.0, 0.1, 0.9)
    card = [refit_leaf_outputs(*(torch.from_numpy(a).to(dev)
                                 for a in (leaf, g, h, old)), *args).cpu()
            for _ in range(2)]
    plain = refit_leaf_outputs(*(torch.from_numpy(a)
                                 for a in (leaf, g, h, old)), *args)
    assert torch.equal(card[0], card[1])
    n = np.bincount(leaf, minlength=L)
    sh = np.bincount(leaf, h.astype(np.float64), minlength=L)
    sg = np.bincount(leaf, g.astype(np.float64), minlength=L)
    dg = sum_bound(n, np.bincount(leaf, np.abs(g.astype(np.float64)),
                                  minlength=L))
    dh = sum_bound(n, sh)
    bound = 0.1 * 0.1 * (dg + np.abs(sg) / sh * dh) / (sh - dh) \
        + 4 * np.abs(plain.numpy()) * 2.0 ** -23
    assert (np.abs(card[0].numpy().astype(np.float64)
                   - plain.numpy()) <= bound).all()


# -- SHAP, dumps, leaf edits, shuffles -----------------------------------------

@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_pred_contrib_matches_jax(models, objective):
    params, text, X, _, _ = models[objective]
    j = lgb.Booster(model_str=text)
    t = lgt.Booster(model_str=text, device="cpu")
    jc = j.predict(X[:200], pred_contrib=True)
    tc = t.predict(X[:200], pred_contrib=True)
    k = 3 if objective == "multiclass" else 1
    assert tc.shape == (200, k * (F + 1))
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-12)
    raw = t.predict(X[:200], raw_score=True).reshape(200, k)
    np.testing.assert_allclose(tc.reshape(200, k, F + 1).sum(2), raw,
                               rtol=0, atol=1e-5)
    h = tcapi.LGBM_BoosterLoadModelFromString(text, device="cpu")
    np.testing.assert_array_equal(tcapi.LGBM_BoosterPredictForMat(
        h, X[:200], predict_type=tcapi.C_API_PREDICT_CONTRIB), tc)


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_dump_model_matches_jax(models, objective):
    _, text, _, _, _ = models[objective]
    jd = lgb.Booster(model_str=text).dump_model()
    td = lgt.Booster(model_str=text, device="cpu").dump_model()
    assert td == jd
    h = tcapi.LGBM_BoosterLoadModelFromString(text, device="cpu")
    assert tcapi.LGBM_BoosterDumpModel(h, num_iteration=2) == \
        lgb.Booster(model_str=text).dump_model(num_iteration=2)


def test_leaf_edits_and_shuffle_match_jax(models):
    """``SetLeafValue``, then ``ShuffleModels`` (the JAX package's draw
    from data_random_seed), on a trained booster: the JAX package's model
    text, and predictions that follow the edit (the stacked tables built
    again)."""
    params, _, X, X2, _ = models["binary"]
    y = (X[:, 0] > 0).astype(float)
    out = []
    for capi, kw in ((jcapi, {}), (tcapi, {"device": "cpu"})):
        ds = capi.LGBM_DatasetCreateFromMat(X, parameters=params, **kw)
        capi.LGBM_DatasetSetField(ds, "label", y)
        h = capi.LGBM_BoosterCreate(ds, params)
        for _ in range(6):
            capi.LGBM_BoosterUpdateOneIter(h)
        before = np.asarray(capi.LGBM_BoosterPredictForMat(h, X2))
        value = capi.LGBM_BoosterGetLeafValue(h, 2, 1) + 0.5
        capi.LGBM_BoosterSetLeafValue(h, 2, 1, value)
        assert capi.LGBM_BoosterGetLeafValue(h, 2, 1) == value
        edited = np.asarray(capi.LGBM_BoosterPredictForMat(h, X2))
        assert not np.array_equal(before, edited)
        capi.LGBM_BoosterShuffleModels(h, 1, 5)
        out.append((capi.LGBM_BoosterSaveModelToString(h), edited,
                    np.asarray(capi.LGBM_BoosterPredictForMat(h, X2))))
    (jt, je, js), (tt, te, ts) = out
    assert _body(tt) == _body(jt)
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    host = lgt.Booster(model_str=tt, device="cpu")._gbdt
    raw = sum(t.predict(X2) for t in host.models)
    np.testing.assert_allclose(ts, 1 / (1 + np.exp(-raw)), rtol=0, atol=1e-5)


# -- datasets through the C API ------------------------------------------------

def _train_text(capi, ds, params, kw, iters=4):
    h = capi.LGBM_BoosterCreate(ds, params)
    for _ in range(iters):
        capi.LGBM_BoosterUpdateOneIter(h)
    return capi.LGBM_BoosterSaveModelToString(h)


def test_subset_whole_queries_matches_jax():
    """``LGBM_DatasetGetSubset`` of whole queries on ranking data: the
    JAX package's model; a query cut in two is refused."""
    X, lin, rng = _rows(5)
    y = np.clip(np.digitize(lin, [-1, 0, 1]), 0, 3).astype(float)
    group = np.full(64, 20)
    params = {**PARAMS, "objective": "lambdarank"}
    keep = np.concatenate([np.arange(q * 20, q * 20 + 20)
                           for q in range(0, 64, 2)])
    texts = []
    for capi, kw in ((jcapi, {}), (tcapi, {"device": "cpu"})):
        ds = capi.LGBM_DatasetCreateFromMat(X, parameters=params, **kw)
        capi.LGBM_DatasetSetField(ds, "label", y)
        capi.LGBM_DatasetSetField(ds, "group", group)
        sub = capi.LGBM_DatasetGetSubset(ds, keep)
        assert list(capi.LGBM_DatasetGetField(sub, "group")) == [20] * 32
        texts.append(_train_text(capi, sub, params, kw, iters=2))
        with pytest.raises(Exception, match="whole queries"):
            capi.LGBM_DatasetGetSubset(ds, np.arange(10))
    tt, jt = texts[1], texts[0]
    keys = ("split_feature", "left_child", "right_child")
    assert [ln for ln in tt.splitlines() if ln.split("=")[0] in keys] == \
        [ln for ln in jt.splitlines() if ln.split("=")[0] in keys]


def test_sampled_column_push_rows_matches_jax():
    """``CreateFromSampledColumn`` (mappers from every fourth row's
    nonzero values) filled by ``PushRows`` in two blocks, and
    ``CreateByReference`` filled the same way, as a valid set: the JAX
    package's model text and valid metrics (within 1e-6 relative, the
    port's in float64), feature names set and read back."""
    X, lin, rng = _rows(6)
    X[rng.random(X.shape) < 0.3] = 0.0
    y = (lin > 0).astype(float)
    rows = np.arange(0, N, 4)
    cols = [X[rows, j] for j in range(F)]
    idx = [np.flatnonzero(c) for c in cols]
    vals = [c[i] for c, i in zip(cols, idx)]
    names = [f"f{j}" for j in range(F)]
    texts = []
    for capi, kw in ((jcapi, {}), (tcapi, {"device": "cpu"})):
        ds = capi.LGBM_DatasetCreateFromSampledColumn(
            vals, idx, F, [len(i) for i in idx], len(rows), N,
            parameters=PARAMS, **kw)
        f64 = capi.C_API_DTYPE_FLOAT64
        capi.LGBM_DatasetPushRows(ds, X[:700], f64, 700, F, 0)
        capi.LGBM_DatasetPushRows(ds, X[700:], f64, N - 700, F, 700)
        capi.LGBM_DatasetSetField(ds, "label", y)
        capi.LGBM_DatasetSetFeatureNames(ds, names)
        assert capi.LGBM_DatasetGetFeatureNames(ds) == names
        ref = capi.LGBM_DatasetCreateByReference(ds, N)
        capi.LGBM_DatasetPushRows(ref, X, f64, N, F, 0)
        capi.LGBM_DatasetSetField(ref, "label", y)
        h = capi.LGBM_BoosterCreate(ds, PARAMS)
        capi.LGBM_BoosterAddValidData(h, ref)
        for _ in range(4):
            capi.LGBM_BoosterUpdateOneIter(h)
        texts.append((capi.LGBM_BoosterSaveModelToString(h),
                      capi.LGBM_BoosterGetEval(h, 1)))
    (jt, je), (tt, te) = texts
    assert _body(tt) == _body(jt)
    assert [n for n, _ in te] == [n for n, _ in je]
    np.testing.assert_allclose([v for _, v in te], [v for _, v in je],
                               rtol=1e-6)


def test_file_dataset_and_predict_for_file_match_jax(models, tmp_path):
    """``DatasetCreateFromFile`` and ``DatasetSaveBinary`` (the .bin read
    back by the other package), training on it, ``SaveModel``, and
    ``PredictForFile``: leaf indices string for string, probabilities
    within 1e-5."""
    params, _, X, X2, _ = models["binary"]
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    path = str(tmp_path / "train.tsv")
    with open(path, "w") as fh:
        fh.writelines("\t".join([str(y[i])] + [f"{v:.17g}" for v in X[i]])
                      + "\n" for i in range(N))
    test = str(tmp_path / "test.tsv")
    with open(test, "w") as fh:
        fh.writelines("\t".join(f"{v:.17g}" for v in X2[i]) + "\n"
                      for i in range(200))
    out = {}
    for name, capi, kw in (("jax", jcapi, {}),
                           ("port", tcapi, {"device": "cpu"})):
        ds = capi.LGBM_DatasetCreateFromFile(path, PARAMS, **kw)
        capi.LGBM_DatasetSaveBinary(ds, str(tmp_path / f"{name}.bin"))
        h = capi.LGBM_BoosterCreate(ds, PARAMS)
        for _ in range(4):
            capi.LGBM_BoosterUpdateOneIter(h)
        model = str(tmp_path / f"{name}_model.txt")
        capi.LGBM_BoosterSaveModel(h, filename=model)
        for kind, ptype in (("leaf", capi.C_API_PREDICT_LEAF_INDEX),
                            ("prob", capi.C_API_PREDICT_NORMAL)):
            res = str(tmp_path / f"{name}_{kind}.txt")
            capi.LGBM_BoosterPredictForFile(h, test, predict_type=ptype,
                                            result_filename=res)
            out[name, kind] = open(res).read().splitlines()
        out[name] = open(model).read()
    assert _body(out["port"]) == _body(out["jax"])
    assert out["port", "leaf"] == out["jax", "leaf"]
    np.testing.assert_allclose(np.array(out["port", "prob"], float),
                               np.array(out["jax", "prob"], float),
                               rtol=0, atol=1e-5)
    # each package trains the same model from the other's .bin
    jb = jcapi.LGBM_DatasetCreateFromFile(str(tmp_path / "port.bin"), PARAMS)
    tb = tcapi.LGBM_DatasetCreateFromFile(str(tmp_path / "jax.bin"), PARAMS,
                                          device="cpu")
    assert _body(_train_text(jcapi, jb, PARAMS, {})) == _body(out["jax"])
    assert _body(_train_text(tcapi, tb, PARAMS, {})) == _body(out["jax"])


def test_booster_pickles(models):
    """A pickled Booster unpickles onto cuda:0 (the device is not part of
    its state) with its model text, best iteration and params."""
    params, text, X, _, _ = models["binary"]
    bst = lgt.Booster(params=dict(params), model_str=text, device="cpu")
    bst.best_iteration = 4
    again = pickle.loads(pickle.dumps(bst))
    assert again.model_to_string() == bst.model_to_string()
    assert again.best_iteration == 4 and again.params == bst.params
    assert again._gbdt.device is None
    fresh = lgt.Booster(model_str=text, device="cpu").model_from_string(
        again.model_to_string(num_iteration=-1, start_iteration=0))
    np.testing.assert_array_equal(fresh.predict(X[:50], num_iteration=4),
                                  bst.predict(X[:50]))


def test_last_error():
    assert tcapi.LGBM_GetLastError() == jcapi.LGBM_GetLastError()
    tcapi.LGBM_SetLastError("boom")
    assert tcapi.LGBM_GetLastError() == "boom"
    tcapi.LGBM_SetLastError("Everything is fine")
