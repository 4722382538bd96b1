"""Port parity for valid sets, evaluation and early stopping: the port
(lightgbm_tpu_torch, ``device="cpu"``) against the JAX package on the
CPU, on the same numpy inputs made from a seed.

A valid set rides the grower's bin matrix as weight-0 passenger columns
after the training rows in both packages (the JAX package's
gbdt.py:1165). Bars:
- the trees, and the model text before its parameters block, are the
  same with a valid set as without it, byte for byte, on the f32 exact
  tier, the int8 tier with exact counts, the count-proxy tier, 4-bit
  packed bins and with categorical columns; against the JAX package's
  run with the same valid set, the trees are equal (structure, counts,
  leaf and internal values bit for bit, split gains within 4 ulp, as
  tests/test_torch_categorical.py holds them) and the valid scores bit
  for bit. The HIGGS-shape sets are tests/test_torch_quant.py's, clear
  of the int8 tier's fusion differences for 20 iterations; the
  categorical one is tests/test_torch_categorical.py's;
- the valid metrics within 1e-6 relative of the JAX package's (the port
  sums in float64, JAX in f32);
- a valid set added after some iterations (its scores by a replay of
  the trees so far) and ``rollback_one_iter`` (a replay subtracted with
  shrink -1.0) give the JAX package's train and valid scores bit for
  bit;
- ``train`` with ``early_stopping_rounds``: ``best_iteration``,
  ``best_score`` (1e-6 relative) and ``evals_result`` as the JAX
  package's, with a user callback called once an iteration;
- ``feval``, ``learning_rates`` (``reset_parameter``),
  ``record_evaluation``, ``cv`` (``stratified=False``), the C API's
  valid-set calls and ``feature_importance`` against the JAX package's.

The JAX package lowers its own log level under ``verbose=-1`` and never
puts it back, so each test restores both packages' levels.
"""
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from chip_smoke import (TRAIN_PARAMS, lrb_labels, make_higgs_like,
                        make_lrb_rows, tree_diff)
from lightgbm_tpu import capi as jcapi
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.metrics import create_metrics as j_create_metrics
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.objectives import create_objective as j_create_objective
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.metrics import create_metrics, metric_names
from lightgbm_tpu_torch.models.gbdt import GBDT as TorchGBDT
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port

REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small PyTorch ops: one thread each under parallel test
    workers, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_log_levels():
    """Training with verbose=-1 lowers either package's process-wide log
    level; each test puts both back."""
    levels = jlog.get_level(), tlog.get_level()
    yield
    jlog.set_level(levels[0])
    tlog.set_level(levels[1])


def _lrb_params(**extra):
    p = {k: v for k, v in TRAIN_PARAMS.items() if k != "num_iterations"}
    return {**p, **extra}


def _lrb_sets(n=3000, nv=1500, noisy=False):
    """LRB-shape train and valid rows; ``noisy`` flips 30% of the valid
    labels, so the valid logloss turns up after a few iterations."""
    X = make_lrb_rows(n, seed=5)
    y = lrb_labels(X, seed=6)
    Xv = make_lrb_rows(nv, seed=7)
    yv = lrb_labels(Xv, seed=8)
    if noisy:
        flip = np.random.default_rng(9).random(nv) < 0.3
        yv = np.where(flip, 1.0 - yv, yv).astype(np.float32)
    return X, y, Xv, yv


def _body(text: str) -> str:
    """Model text before its parameters block."""
    return text[:text.index("\nparameters:")]


def _same_trees(jtext: str, ttext: str) -> None:
    """Trees equal: structure and counts, leaf and internal values bit
    for bit, categorical bitsets, split gains within 4 ulp."""
    jm = JaxGBDT().load_model_from_string(jtext)
    tm = TorchGBDT(device="cpu").load_model_from_string(ttext)
    assert len(jm.models) == len(tm.models)
    assert tree_diff(jm.models, tm.models) is None
    for a, b in zip(jm.models, tm.models):
        assert (b.cat_boundaries, b.cat_threshold) == \
            (a.cat_boundaries, a.cat_threshold)
        np.testing.assert_array_equal(b.leaf_value, a.leaf_value)
        np.testing.assert_array_equal(b.internal_value, a.internal_value)
        ga = np.asarray(a.split_gain, np.float32)
        gb = np.asarray(b.split_gain, np.float32)
        np.testing.assert_array_less(np.abs(ga - gb),
                                     4 * np.spacing(np.abs(ga)) + 1e-30)


def _close(a, b, rel=REL):
    assert abs(a - b) <= rel * max(abs(a), abs(b), 1e-12), (a, b)


def _higgs_case(extra, seed):
    X, y = make_higgs_like(8000, seed=seed)
    Xv, yv = make_higgs_like(2000, seed=12)
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 31,
              "min_data_in_leaf": 20, "bagging_fraction": 0.8,
              "bagging_freq": 3, "verbose": -1,
              "metric": "binary_logloss,auc,binary_error", **extra}
    return X, y, Xv, yv, params, {}


def _catbin_case():
    import os
    data = os.path.join(os.path.dirname(__file__), "data", "golden2")
    X = np.fromfile(os.path.join(data, "g2_catbin_X.bin"),
                    np.float64).reshape(600, 8)
    y = np.fromfile(os.path.join(data, "g2_catbin_y.bin"), np.float32)
    params = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
              "min_data_in_leaf": 10, "min_data_per_group": 5,
              "max_bin": 63, "min_data_in_bin": 3, "verbose": -1,
              "metric": "auc,binary_logloss"}
    return X, y, X[::2], y[::2], params, {"categorical_feature": [0, 2]}


CASES = {
    "f32": lambda: (*_lrb_sets(), _lrb_params(
        metric="binary_logloss,auc,binary_error"), {}),
    "int8": lambda: _higgs_case({"tpu_quantized_hist": True,
                                 "tpu_count_proxy": 0}, 8),
    "proxy": lambda: _higgs_case({"tpu_quantized_hist": True}, 8),
    "packed4": lambda: _higgs_case({"max_bin": 15}, 8),
    "categorical": _catbin_case,
}
ROUNDS = 10


@pytest.mark.parametrize("case", sorted(CASES))
def test_valid_set_changes_no_tree_and_matches_jax(case):
    X, y, Xv, yv, params, ds_kw = CASES[case]()
    res_t, res_j = {}, {}
    tb = lgt.train(params, lgt.Dataset(X, label=y, **ds_kw), ROUNDS,
                   valid_sets=[lgt.Dataset(Xv, label=yv, **ds_kw)],
                   valid_names=["v"], evals_result=res_t,
                   verbose_eval=False, keep_training_booster=True,
                   device="cpu")
    alone = lgt.train(params, lgt.Dataset(X, label=y, **ds_kw), ROUNDS,
                      verbose_eval=False, device="cpu")
    jb = lgb.train(params, lgb.Dataset(X, label=y, **ds_kw), ROUNDS,
                   valid_sets=[lgb.Dataset(Xv, label=yv, **ds_kw)],
                   valid_names=["v"], evals_result=res_j,
                   verbose_eval=False, keep_training_booster=True)
    g = tb._gbdt
    cfg = g._grower_cfg
    assert cfg.packed4 == (case == "packed4")
    assert cfg.count_proxy == (case == "proxy")
    assert cfg.precision == ("int8" if case in ("int8", "proxy")
                             else "f32")
    assert cfg.hp.has_cat == (case == "categorical")
    assert g._n_total == len(y) + len(yv)
    ttext = tb.model_to_string()
    assert _body(ttext) == _body(alone.model_to_string())
    _same_trees(jb.model_to_string(), ttext)
    np.testing.assert_array_equal(g.valid_scores(1).numpy(),
                                  np.asarray(jb._gbdt._valid_scores[0]))
    np.testing.assert_array_equal(g.train_scores().numpy(),
                                  np.asarray(jb._gbdt.train_scores()))
    assert list(res_t["v"]) == list(res_j["v"])
    for name in res_j["v"]:
        assert len(res_t["v"][name]) == ROUNDS
        for a, b in zip(res_t["v"][name], res_j["v"][name]):
            _close(a, b)
    jev = jb._gbdt.get_eval_at(1)
    tev = g.get_eval_at(1)
    assert [e[0] for e in tev] == [e[0] for e in jev]
    for (_, a, ba), (_, b, bb) in zip(tev, jev):
        _close(a, b)
        assert ba == bb


def _gbdts(params, X, y):
    """A port GBDT and a JAX GBDT set up on (X, y) with the configured
    metrics, the way the boosters set them up."""
    out = []
    for mod in ("torch", "jax"):
        if mod == "torch":
            cfg = TConfig().set(params)
            ds = BinnedDataset(cfg, "cpu").construct_from_matrix(
                X, Metadata(label=y))
            obj = create_objective(cfg.objective, cfg)
            obj.init(ds.metadata, ds.num_data)
            g = TorchGBDT().init(cfg, ds, obj, create_metrics(
                metric_names(cfg), cfg, ds.metadata, ds.num_data))
        else:
            from lightgbm_tpu.io.dataset import TpuDataset
            cfg = JConfig().set(params)
            ds = TpuDataset(cfg).construct_from_matrix(X, JMeta(label=y))
            obj = j_create_objective(cfg.objective, cfg)
            obj.init(ds.metadata, ds.num_data)
            g = JaxGBDT()
            g.init(cfg, ds, obj, j_create_metrics(
                list(cfg.metric), cfg, ds.metadata, ds.num_data))
        out.append((g, ds, cfg))
    return out


def _add_valid(g, ds, cfg, Xv, yv, jax: bool):
    if jax:
        vs = ds.create_valid(Xv, JMeta(label=yv))
        g.add_valid_data(vs, j_create_metrics(list(cfg.metric), cfg,
                                              vs.metadata, vs.num_data),
                         "v")
    else:
        vs = ds.create_valid(Xv, Metadata(label=yv))
        g.add_valid_data(vs, create_metrics(metric_names(cfg), cfg,
                                            vs.metadata, vs.num_data), "v")


def _scores(t, j):
    """Train and valid scores of the two GBDTs, bit for bit."""
    np.testing.assert_array_equal(t.train_scores().numpy(),
                                  np.asarray(j.train_scores()))
    for i, vs in enumerate(j._valid_scores):
        np.testing.assert_array_equal(t.valid_scores(i + 1).numpy(),
                                      np.asarray(vs))


def test_add_valid_after_iterations_and_rollback_match_jax():
    """A valid set added after 4 iterations gets its scores by a replay
    of the 4 trees at shrink 1.0; training goes on with it as passengers;
    two rollbacks subtract the last trees' replays (shrink -1.0): train
    and valid scores bit-equal to the JAX package's at every step, and
    the rolled-back model's text is the one saved before those
    iterations."""
    X, y, Xv, yv = _lrb_sets(2000, 800)
    params = _lrb_params(metric="binary_logloss,auc")
    (t, tds, tcfg), (j, jds, jcfg) = _gbdts(params, X, y)
    for _ in range(4):
        t.train_one_iter()
        j.train_one_iter()
    _add_valid(t, tds, tcfg, Xv, yv, jax=False)
    _add_valid(j, jds, jcfg, Xv, yv, jax=True)
    _scores(t, j)
    saved = []
    for _ in range(4):
        saved.append(_body(t.model_to_string()))
        t.train_one_iter()
        j.train_one_iter()
    _scores(t, j)
    _same_trees(j.model_to_string(), t.model_to_string())
    for _ in range(2):
        t.rollback_one_iter()
        j.rollback_one_iter()
        _scores(t, j)
        assert _body(t.model_to_string()) == saved.pop()
    assert t.current_iteration == j.current_iteration == 6
    for (a, va, _), (b, vb, _) in zip(t.get_eval_at(1), j.get_eval_at(1)):
        assert a == b
        _close(va, vb)


def test_init_scores_and_boost_from_average_on_valid_sets():
    """Init scores of the train and valid sets start their scores (and
    switch boost_from_average off, as in the JAX package)."""
    X, y, Xv, yv = _lrb_sets(2000, 600)
    params = _lrb_params()
    r = np.random.default_rng(3)
    init, vinit = r.normal(0, 0.3, len(y)), r.normal(0, 0.3, len(yv))
    res_t, res_j = {}, {}
    tb = lgt.train(params, lgt.Dataset(X, label=y, init_score=init), 5,
                   valid_sets=[lgt.Dataset(Xv, label=yv, init_score=vinit)],
                   evals_result=res_t, verbose_eval=False,
                   keep_training_booster=True, device="cpu")
    jb = lgb.train(params, lgb.Dataset(X, label=y, init_score=init), 5,
                   valid_sets=[lgb.Dataset(Xv, label=yv, init_score=vinit)],
                   evals_result=res_j, verbose_eval=False,
                   keep_training_booster=True)
    _same_trees(jb.model_to_string(), tb.model_to_string())
    _scores(tb._gbdt, jb._gbdt)
    for name in res_j["valid_0"]:
        for a, b in zip(res_t["valid_0"][name], res_j["valid_0"][name]):
            _close(a, b)


def test_early_stopping_matches_jax():
    """The valid logloss turns up after a few iterations: training stops
    ``early_stopping_rounds`` after the best, with the JAX package's
    best iteration, best score and history, and a user callback called
    once an iteration."""
    X, y, Xv, yv = _lrb_sets(3000, 1500, noisy=True)
    params = _lrb_params()
    seen = []
    res_t, res_j = {}, {}
    tb = lgt.train(params, lgt.Dataset(X, label=y), 80,
                   valid_sets=[lgt.Dataset(Xv, label=yv)],
                   early_stopping_rounds=5, evals_result=res_t,
                   verbose_eval=False,
                   callbacks=[lambda env: seen.append(env.iteration)],
                   device="cpu")
    jb = lgb.train(params, lgb.Dataset(X, label=y), 80,
                   valid_sets=[lgb.Dataset(Xv, label=yv)],
                   early_stopping_rounds=5, evals_result=res_j,
                   verbose_eval=False)
    assert 1 < tb.best_iteration == jb.best_iteration < 40
    assert tb.num_trees() == jb.num_trees() == tb.best_iteration + 5
    assert seen == list(range(tb.num_trees()))
    assert list(tb.best_score) == list(jb.best_score)
    for name, v in jb.best_score["valid_0"].items():
        _close(tb.best_score["valid_0"][name], v)
    for name in res_j["valid_0"]:
        assert len(res_t["valid_0"][name]) == len(res_j["valid_0"][name])
        for a, b in zip(res_t["valid_0"][name], res_j["valid_0"][name]):
            _close(a, b)
    _same_trees(jb.model_to_string(), tb.model_to_string())


def test_feval_learning_rates_and_record_evaluation_match_jax():
    """A custom eval on the train set (named as a valid set) and the
    valid set, a learning rate per round through reset_parameter, and
    the recorded history, against the JAX package's."""
    X, y, Xv, yv = _lrb_sets(2000, 800)
    params = _lrb_params(metric="auc")

    def feval(preds, ds):
        lab = ds.get_label()
        return "mean_abs", float(np.mean(np.abs(preds - lab))), False

    rates = [0.1 * 0.9 ** i for i in range(6)]
    out = {}
    for name, mod, kw in (("torch", lgt, {"device": "cpu"}),
                          ("jax", lgb, {})):
        res = {}
        train = mod.Dataset(X, label=y)
        bst = mod.train(params, train, 6,
                        valid_sets=[train, mod.Dataset(Xv, label=yv)],
                        valid_names=["tr", "v"], feval=feval,
                        learning_rates=rates, verbose_eval=False,
                        callbacks=[mod.record_evaluation(res)], **kw)
        out[name] = (res, bst.model_to_string())
    (rt, tt), (rj, tj) = out["torch"], out["jax"]
    assert sorted(rt) == sorted(rj) == ["tr", "v"]
    for ds in rj:
        assert list(rt[ds]) == list(rj[ds]) == ["auc", "mean_abs"]
        for name in rj[ds]:
            for a, b in zip(rt[ds][name], rj[ds][name]):
                _close(a, b)
    _same_trees(tj, tt)
    shrink = [float(ln.split("=")[1]) for ln in tt.splitlines()
              if ln.startswith("shrinkage=")]
    np.testing.assert_allclose(shrink[1:], rates[1:])


def test_reset_parameter_rebuilds_the_grower_only_when_its_config_changes():
    """A learning-rate change (what ``learning_rates`` does every round)
    keeps the grower; a change to one of its fields builds a new one,
    and the trees after it are the JAX package's."""
    X, y, Xv, yv = _lrb_sets(1500, 600)
    params = _lrb_params()
    tb = lgt.Booster(params, lgt.Dataset(X, label=y), device="cpu")
    jb = lgb.Booster(params, lgb.Dataset(X, label=y))
    for b in (tb, jb):
        b.add_valid(b.train_set.create_valid(Xv, label=yv), "v")
        b.update()
    grower = tb._gbdt._grower
    for b in (tb, jb):
        b.reset_parameter({"learning_rate": 0.05})
        b.update()
    assert tb._gbdt._grower is grower
    assert tb._gbdt.shrinkage_rate == 0.05
    for b in (tb, jb):
        b.reset_parameter({"lambda_l2": 4.0})
        b.update()
    assert tb._gbdt._grower is not grower
    assert tb._gbdt._grower_cfg.hp.lambda_l2 == 4.0
    _same_trees(jb.model_to_string(), tb.model_to_string())
    _scores(tb._gbdt, jb._gbdt)


def test_cv_matches_jax():
    """cv with unstratified folds: every fold binned from the full set's
    bins on the device; the mean and deviation histories as the JAX
    package's."""
    X, y, _, _ = _lrb_sets(2400, 10)
    params = _lrb_params(metric="binary_logloss,auc")
    rt = lgt.cv(params, lgt.Dataset(X, label=y), 5, nfold=3,
                stratified=False, seed=4, device="cpu")
    rj = lgb.cv(params, lgb.Dataset(X, label=y, free_raw_data=False), 5,
                nfold=3, stratified=False, seed=4)
    assert sorted(rt) == sorted(rj)
    for key in rj:
        assert len(rt[key]) == len(rj[key]) == 5
        for a, b in zip(rt[key], rj[key]):
            if key.endswith("-stdv"):
                assert abs(a - b) <= 1e-6
            else:
                _close(a, b)
    es = lgt.cv(params, lgt.Dataset(X, label=y), 60, nfold=3,
                stratified=False, seed=4, early_stopping_rounds=3,
                device="cpu")
    ej = lgb.cv(params, lgb.Dataset(X, label=y, free_raw_data=False), 60,
                nfold=3, stratified=False, seed=4,
                early_stopping_rounds=3)
    assert len(es["auc-mean"]) == len(ej["auc-mean"]) < 60


def test_stratified_cv_needs_scikit_learn(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
    X, y, _, _ = _lrb_sets(600, 10)
    with pytest.raises(lgt.LightGBMError, match="scikit-learn"):
        lgt.cv(_lrb_params(), lgt.Dataset(X, label=y), 2, nfold=3,
               device="cpu")


def test_capi_valid_sequence_matches_jax():
    """DatasetCreateFromMat with a reference, AddValidData, GetEval(1)
    every iteration, the eval counts and names, GetNumPredict and
    GetPredict, RollbackOneIter, FeatureImportance and the dataset
    fields, against the JAX package's C API."""
    X, y, Xv, yv = _lrb_sets(2000, 700)
    params = " ".join(f"{k}={v}" for k, v in TRAIN_PARAMS.items()
                      if k != "num_iterations")
    out = {}
    for name, capi, kw in (("jax", jcapi, {}),
                           ("port", tcapi, {"device": "cpu"})):
        ds = capi.LGBM_DatasetCreateFromMat(X, parameters=params, **kw)
        capi.LGBM_DatasetSetField(ds, "label", y)
        bst = capi.LGBM_BoosterCreate(ds, params)
        vd = capi.LGBM_DatasetCreateFromMat(Xv, parameters=params,
                                            reference=ds, **kw)
        capi.LGBM_DatasetSetField(vd, "label", yv)
        capi.LGBM_BoosterAddValidData(bst, vd)
        evals = []
        for _ in range(8):
            capi.LGBM_BoosterUpdateOneIter(bst)
            evals.append(dict(capi.LGBM_BoosterGetEval(bst, 1)))
        before = capi.LGBM_BoosterSaveModelToString(bst)
        capi.LGBM_BoosterUpdateOneIter(bst)
        capi.LGBM_BoosterRollbackOneIter(bst)
        out[name] = dict(
            evals=evals, text=capi.LGBM_BoosterSaveModelToString(bst),
            before=before,
            counts=capi.LGBM_BoosterGetEvalCounts(bst),
            names=capi.LGBM_BoosterGetEvalNames(bst),
            num=[capi.LGBM_BoosterGetNumPredict(bst, i) for i in (0, 1)],
            pred=[capi.LGBM_BoosterGetPredict(bst, i) for i in (0, 1)],
            mat=np.asarray(capi.LGBM_BoosterPredictForMat(bst, Xv)),
            imp=[capi.LGBM_BoosterFeatureImportance(bst, 0, k)
                 for k in (0, 1)],
            it=capi.LGBM_BoosterGetCurrentIteration(bst),
            total=capi.LGBM_BoosterNumberOfTotalModel(bst),
            per=capi.LGBM_BoosterNumModelPerIteration(bst),
            nfeat=capi.LGBM_BoosterGetNumFeature(bst),
            fnames=capi.LGBM_BoosterGetFeatureNames(bst),
            vrows=capi.LGBM_DatasetGetNumData(vd),
            vcols=capi.LGBM_DatasetGetNumFeature(vd),
            vlabel=capi.LGBM_DatasetGetField(vd, "label"))
    p, j = out["port"], out["jax"]
    for ep, ej in zip(p["evals"], j["evals"]):
        assert list(ep) == list(ej) == ["binary_logloss", "auc"]
        for k in ej:
            _close(ep[k], ej[k])
    _same_trees(j["text"], p["text"])
    assert _body(p["text"]) == _body(p["before"])
    # the training metrics are on here, so the JAX package lists them too
    assert p["counts"] == j["counts"] == 2
    assert p["names"] == j["names"] == ["binary_logloss", "auc"]
    assert p["num"] == j["num"] == [2000, 700]
    for a, b in zip(p["pred"], j["pred"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p["pred"][1], p["mat"], atol=1e-5)
    np.testing.assert_array_equal(p["imp"][0], j["imp"][0])
    np.testing.assert_allclose(p["imp"][1], j["imp"][1], rtol=1e-6)
    for k in ("it", "total", "per", "nfeat", "fnames", "vrows", "vcols"):
        assert p[k] == j[k], k
    assert p["it"] == 8
    np.testing.assert_array_equal(p["vlabel"], j["vlabel"])


def test_eval_names_without_training_metric():
    """Without is_provide_training_metric the configured metrics are
    still counted and named (the reference's Booster keeps them either
    way)."""
    X, y, _, _ = _lrb_sets(600, 10)
    params = "objective=binary metric=auc,binary_error verbose=-1"
    ds = tcapi.LGBM_DatasetCreateFromMat(X, parameters=params, device="cpu")
    tcapi.LGBM_DatasetSetField(ds, "label", y)
    bst = tcapi.LGBM_BoosterCreate(ds, params)
    assert tcapi.LGBM_BoosterGetEvalCounts(bst) == 2
    assert tcapi.LGBM_BoosterGetEvalNames(bst) == ["auc", "binary_error"]
    assert tcapi.LGBM_BoosterGetEval(bst, 0) == []


def test_booster_eval_surface_matches_jax():
    """Booster.add_valid, eval_train (with feval), eval_valid, eval,
    feature_importance, and the introspection
    calls, against the JAX package's Booster."""
    X, y, Xv, yv = _lrb_sets(2000, 700)
    params = _lrb_params(metric="binary_logloss,auc,binary_error")

    def feval(preds, ds):
        return [("size", float(len(preds)), True)]

    got = {}
    for name, mod, kw in (("torch", lgt, {"device": "cpu"}),
                          ("jax", lgb, {})):
        train = mod.Dataset(X, label=y)
        bst = mod.Booster(params, train, **kw)
        valid = train.create_valid(Xv, label=yv)
        bst.add_valid(valid, "hold")
        bst.set_train_data_name("tr")
        for _ in range(5):
            bst.update()
        got[name] = dict(
            train=bst.eval_train(feval), valid=bst.eval_valid(feval),
            direct=bst.eval(valid, "hold"),
            split=bst.feature_importance("split"),
            gain=bst.feature_importance("gain", iteration=3),
            it=bst.current_iteration(), nf=bst.num_feature(),
            names=bst.feature_name(), per=bst.num_model_per_iteration())
    t, j = got["torch"], got["jax"]
    for key in ("train", "valid", "direct"):
        assert [r[:2] + r[3:] for r in t[key]] == \
            [r[:2] + r[3:] for r in j[key]], key
        for a, b in zip(t[key], j[key]):
            _close(a[2], b[2])
    assert [r[1] for r in t["train"]] == ["binary_logloss", "auc",
                                          "binary_error", "size"]
    np.testing.assert_array_equal(t["split"], j["split"])
    assert t["split"].dtype == np.int32
    np.testing.assert_allclose(t["gain"], j["gain"], rtol=1e-6)
    for k in ("it", "nf", "names", "per"):
        assert t[k] == j[k], k


def test_dataset_subset_fields_and_shape():
    """Dataset.subset of a binned set selects its bins' columns on the
    device with the same mappers; of one not binned yet, bins its rows
    with mappers of their own. Fields, shapes and names."""
    X, y, _, _ = _lrb_sets(900, 10)
    w = np.linspace(0.5, 1.5, len(y))
    init = np.linspace(-1, 1, len(y))
    full = lgt.Dataset(X, label=y, weight=w, init_score=init,
                       free_raw_data=False).construct("cpu")
    idx = np.random.default_rng(2).choice(len(y), 300, replace=False)
    sub = full.subset(idx).construct("cpu")
    s = np.sort(idx)
    assert sub._inner.mappers is full._inner.mappers
    assert torch.equal(sub._inner.bins_t, full._inner.bins_t[:, s])
    np.testing.assert_array_equal(sub.get_label(), y[s])
    np.testing.assert_array_equal(sub.get_weight(), w[s].astype(np.float32))
    np.testing.assert_array_equal(sub.get_field("init_score"), init[s])
    assert sub.num_data() == 300 and sub.num_feature() == X.shape[1]
    assert sub.get_feature_name() == full.get_feature_name()
    raw = lgt.Dataset(X, label=y).subset(idx)
    assert raw.num_data() == 300
    raw.construct("cpu")
    assert raw._inner.mappers is not full._inner.mappers
    fresh = lgt.Dataset(X[s], label=y[s]).construct("cpu")
    assert torch.equal(raw._inner.bins_t, fresh._inner.bins_t)
    full.set_field("label", 1.0 - y)
    np.testing.assert_array_equal(full.get_field("label"), 1.0 - y)
    with pytest.raises(lgt.LightGBMError, match="Unknown field"):
        full.get_field("group_id")
    v = full.create_valid(X[:50], label=y[:50]).construct()
    assert v._inner.device == full._inner.device
    assert torch.equal(v._inner.bins_t, full._inner.bins_t[:, :50])


def test_binary_error_metric_and_names_match_jax():
    X, y, _, _ = _lrb_sets(500, 10)
    r = np.random.default_rng(1)
    scores = r.normal(0, 1, (1, len(y))).astype(np.float32)
    scores[0, :5] = 0.0
    w = r.uniform(0.5, 2.0, len(y))
    for weight in (None, w):
        params = {"objective": "binary", "metric": "binary_error"}
        tcfg, jcfg = TConfig().set(params), JConfig().set(params)
        tobj = create_objective("binary", tcfg)
        jobj = j_create_objective("binary", jcfg)
        tm = create_metrics(["binary_error"], tcfg,
                            Metadata(label=y, weight=weight), len(y))[0]
        jmet = j_create_metrics(["binary_error"], jcfg,
                                JMeta(label=y, weight=weight), len(y))[0]
        tobj.init(Metadata(label=y, weight=weight), len(y))
        jobj.init(JMeta(label=y, weight=weight), len(y))
        got = tm.eval(torch.from_numpy(scores), tobj)
        want = float(jmet.device_eval_builder(jobj)(scores))
        _close(got, want)
    for params in ({"objective": "binary"}, {"objective": "binary",
                                             "metric": "none"},
                   {"objective": "binary", "metric": "auc,binary_error"}):
        from lightgbm_tpu.basic import _resolve_metric_names
        assert metric_names(TConfig().set(params)) == \
            _resolve_metric_names(JConfig().set(params))


def test_unported_options_raise(tmp_path):
    """What stays refused, and the options that once were: a missing
    init model raises as the JAX package's does; GOSS's legacy sampler
    (``tpu_goss_hash=0``, ROADMAP item 23) trains
    (tests/test_torch_boosting.py holds it against the JAX package); the
    run report,
    checkpoints and the profiler window (obs/recorder.py,
    utils/checkpoint.py, obs/profiler.py) now train and leave their
    artifacts, and ``callback.record_run`` gives the report's callback
    (tests/test_torch_checkpoint.py, test_torch_obs_run.py hold them
    against the JAX package)."""
    X, y, Xv, yv = _lrb_sets(400, 100)
    params = _lrb_params()
    ds = lgt.Dataset(X, label=y)
    # init_model is ported (tests/test_torch_boosting.py): a missing
    # model file raises as the JAX package's does
    with pytest.raises(FileNotFoundError):
        lgt.train(params, ds, 2, device="cpu", init_model="m.txt")
    legacy = lgt.train({**params, "boosting": "goss", "tpu_goss_hash": 0,
                        "bagging_fraction": 1.0, "bagging_freq": 0},
                       lgt.Dataset(X, label=y), 2, device="cpu")
    assert legacy.current_iteration() == 2
    for key, extra in (("tpu_run_report", {}),
                       ("tpu_checkpoint_dir", {"tpu_checkpoint_freq": 1}),
                       ("tpu_profile_dir", {})):
        out = str(tmp_path / key)
        lgt.train({**params, key: out, **extra}, lgt.Dataset(X, label=y),
                  2, device="cpu")
        assert os.path.exists(out), key
    assert callable(lgt.callback.record_run(None))


def test_valid_sets_default_to_the_card():
    """Without ``device``, train() and cv() bin on cuda:0 and raise
    without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda:0 does not raise")
    X, y, Xv, yv = _lrb_sets(400, 100)
    with pytest.raises(lgt.LightGBMError, match="no CUDA device"):
        lgt.train(_lrb_params(), lgt.Dataset(X, label=y), 2,
                  valid_sets=[lgt.Dataset(Xv, label=yv)])
    with pytest.raises(lgt.LightGBMError, match="no CUDA device"):
        lgt.cv(_lrb_params(), lgt.Dataset(X, label=y), 2, nfold=2,
               stratified=False)
