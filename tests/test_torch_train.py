"""Port parity, end to end: binary GBDT training through
``lightgbm_tpu_torch.train`` and through the C-API sequence the LRB loop
calls, against the JAX package on the CPU.

Bars: trees equal in structure and counts up to the first documented
tie, with leaf values within 1e-5; train AUC within 4e-4; each package
loads the other's model text and predicts within 1e-5 of the package
that wrote it. The port computes the two f32 operations whose rounding
XLA picks itself as XLA does on the CPU (ops/f32math.py): the exp of
the binary gradients (the Cephes polynomial with fused multiply-adds)
and the score update with its shrinkage fold (one fused multiply-add);
its split search adds the prefix sums in XLA's order at every width. So
the gradients are bit-equal and no documented case has a tie any more:
the golden2 ``binary`` set (600 rows, 25 iterations), the LRB-shaped
set with bagging and feature_fraction through ``train`` (4,000 rows, 50
iterations, and with row weights and ``tpu_wave_size`` 8, 20
iterations) and through the C API (3,000 rows, 50 iterations) give equal
trees, and on the first two the model text before the parameters is
byte-equal to the JAX package's. (Before the port followed XLA's
roundings, golden2 parted at tree 2 and the C-API case at tree 6, each
at two candidates of equal gain.)
"""
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from chip_smoke import TRAIN_PARAMS, auc_np, lrb_labels, make_lrb_rows, \
    tree_diff
from lightgbm_tpu import capi as jcapi
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.metrics import create_metrics as j_create_metrics
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.objectives import create_objective as j_create_objective
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.metrics import create_metrics
from lightgbm_tpu_torch.models.gbdt import GBDT as TorchGBDT
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small PyTorch ops; under parallel test
    workers (pytest-xdist) on a shared CPU, each op's thread pool only
    contends (a test of 10 s alone took 440 s so). One thread each,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
G2_PARAMS = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.1,
             "min_data_in_leaf": 10, "verbose": -1}   # g2_binary_model.txt
AUC_TOL = 4e-4


def _golden2():
    X = np.fromfile(os.path.join(DATA, "g2_binary_X.bin"),
                    np.float64).reshape(600, 8)
    y = np.fromfile(os.path.join(DATA, "g2_binary_y.bin"), np.float32)
    return X, y


def _lrb(n=4000):
    X = make_lrb_rows(n, seed=5)
    return X, lrb_labels(X, seed=6)


def _models(jtext, ttext):
    jm = JaxGBDT().load_model_from_string(jtext)
    tm = TorchGBDT(device="cpu").load_model_from_string(ttext)
    return jm, tm


def _check(jtext, ttext, X, y, first_tie):
    """Trees equal up to ``first_tie`` (tree index, or None for no tie),
    where the two packages split with equal gains; leaf values of the
    equal trees within 1e-5; AUC within 4e-4; each package reads the
    other's text."""
    jm, tm = _models(jtext, ttext)
    assert len(jm.models) == len(tm.models)
    diff = tree_diff(jm.models, tm.models)
    if first_tie is None:
        assert diff is None, diff
        equal = len(jm.models)
    else:
        t, node, gj, gt = diff
        assert t == first_tie and node >= 0, diff
        assert abs(gj - gt) <= 1e-3 * max(abs(gj), abs(gt)), diff
        equal = t
    for a, b in zip(jm.models[:equal], tm.models[:equal]):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, atol=1e-5)
        np.testing.assert_allclose(b.internal_value, a.internal_value,
                                   atol=1e-5)
    pj, pt = jm.predict(X), tm.predict(X)
    assert abs(auc_np(y, pj) - auc_np(y, pt)) <= AUC_TOL
    # each package reads the other's text
    for text, own in ((ttext, pt), (jtext, pj)):
        np.testing.assert_allclose(
            JaxGBDT().load_model_from_string(text).predict(X), own,
            atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(
            lgt.Booster(model_str=text, device="cpu").predict(X), own,
            atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("case", ["golden2", "lrb", "lrb_weighted"])
def test_train_matches_jax(case):
    w = None
    if case == "golden2":
        X, y = _golden2()
        params, rounds, tie = G2_PARAMS, 25, None
    else:
        X, y = _lrb()
        params, rounds, tie = TRAIN_PARAMS, 50, None
        if case == "lrb_weighted":
            w = np.random.default_rng(8).uniform(0.5, 2.0, len(y))
            params = {**{k: v for k, v in params.items()
                         if k != "num_iterations"}, "tpu_wave_size": 8}
            rounds = 20
    jb = lgb.train(params, lgb.Dataset(X, label=y, weight=w),
                   num_boost_round=rounds)
    tb = lgt.train(params, lgt.Dataset(X, label=y, weight=w),
                   num_boost_round=rounds, device="cpu")
    assert tb.current_iteration() == rounds
    _check(jb.model_to_string(), tb.model_to_string(), X, y, tie)
    # the trained booster predicts what its own text predicts
    np.testing.assert_array_equal(
        tb.predict(X),
        lgt.Booster(model_str=tb.model_to_string(), device="cpu").predict(X))


def _capi_run(capi, X, y, Xn, **kw):
    ds = capi.LGBM_DatasetCreateFromMat(X, parameters=TRAIN_PARAMS, **kw)
    capi.LGBM_DatasetSetField(ds, "label", y)
    bst = capi.LGBM_BoosterCreate(ds, TRAIN_PARAMS)
    for _ in range(int(TRAIN_PARAMS["num_iterations"])):
        if capi.LGBM_BoosterUpdateOneIter(bst):
            break
    evals = dict(capi.LGBM_BoosterGetEval(bst, 0))
    text = capi.LGBM_BoosterSaveModelToString(bst)
    return evals, text, np.asarray(capi.LGBM_BoosterPredictForMat(bst, Xn))


def test_capi_sequence_matches_jax():
    X, y = _lrb(3000)
    Xn = make_lrb_rows(1000, seed=7)
    je, jt, jp = _capi_run(jcapi, X, y, Xn)
    te, tt, tp = _capi_run(tcapi, X, y, Xn, device="cpu")
    assert set(te) == set(je) == {"binary_logloss", "auc"}
    assert abs(te["auc"] - je["auc"]) <= AUC_TOL
    assert abs(te["binary_logloss"] - je["binary_logloss"]) \
        <= 5e-3 * je["binary_logloss"]
    _check(jt, tt, X, y, None)


def test_capi_fields_and_defaults():
    X, y = _lrb(600)
    ds = tcapi.LGBM_DatasetCreateFromMat(X.ravel(), nrow=600, ncol=53,
                                         parameters="objective=binary",
                                         device="cpu")
    tcapi.LGBM_DatasetSetField(ds, "label", y)
    bst = tcapi.LGBM_BoosterCreate(ds, "objective=binary num_leaves=7")
    assert tcapi.LGBM_BoosterUpdateOneIter(bst) == 0
    # no is_provide_training_metric: no train-set metrics, as c_api.cpp
    assert tcapi.LGBM_BoosterGetEval(bst, 0) == []
    with pytest.raises(lgt.LightGBMError):
        tcapi.LGBM_DatasetSetField(ds, "label", y)
    with pytest.raises(lgt.LightGBMError):
        tcapi.LGBM_DatasetSetField(
            tcapi.LGBM_DatasetCreateFromMat(X, device="cpu"), "position", y)


@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match_jax(weighted):
    r = np.random.default_rng(int(weighted))
    n = 3000
    y = (r.random(n) < 0.4).astype(np.float32)
    w = r.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    s = (r.normal(size=(1, n)) * 2).astype(np.float32)
    s[0, ::50] = s[0, 1::50]                 # tied scores
    cfg = {"objective": "binary", "metric": "binary_logloss,auc"}
    jc = JConfig().set(cfg)
    jo = j_create_objective("binary", jc)
    jo.init(JMeta(label=y, weight=w), n)
    jm = j_create_metrics(["binary_logloss", "auc"], jc,
                          JMeta(label=y, weight=w), n)
    tc = TConfig().set(cfg)
    to = create_objective("binary", tc)
    to.init(Metadata(label=y, weight=w), n)
    tm = create_metrics(["binary_logloss", "auc"], tc,
                        Metadata(label=y, weight=w), n)
    for a, b in zip(jm, tm):
        assert a.name == b.name
        want = a.eval(s.astype(np.float64), jo)[0][1]
        assert abs(b.eval(torch.from_numpy(s), to) - want) <= 1e-6


def test_first_iteration_bias_and_stop():
    """An unsplittable set: the first tree is the boost-from-average
    constant, and training stops as in the JAX package."""
    X = np.zeros((200, 3))
    X[:, 0] = np.arange(200) % 2
    y = (np.arange(200) % 5 == 0).astype(np.float32)
    params = {"objective": "binary", "min_data_in_leaf": 150,
              "verbose": -1}
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=5)
    tb = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=5,
                   device="cpu")
    jt, tt = jb.model_to_string(), tb.model_to_string()
    jm, tm = _models(jt, tt)
    assert len(tm.models) == len(jm.models) == 1
    assert tm.models[0].leaf_value == pytest.approx(jm.models[0].leaf_value,
                                                    abs=1e-7)
    assert tm.models[0].shrinkage == jm.models[0].shrinkage == 1.0


def test_stops_at_first_splitless_tree():
    """min_gain_to_split ends training at tree 37: the port drops that
    tree and stops at once, as the reference does, and a further update
    adds nothing. The JAX package's text keeps the splitless trees grown
    after its deferred check stopped it; the port's trees equal its trees
    before the first splitless one."""
    r = np.random.default_rng(0)
    X = r.normal(size=(400, 3))
    y = (X[:, 0] > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 4, "min_data_in_leaf": 5,
              "min_gain_to_split": 5.0, "verbose": -1}
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=40)
    tb = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=40,
                   device="cpu")
    assert tb.current_iteration() == tb.num_trees() == 37
    assert tb.update() and tb.num_trees() == 37
    jm, tm = _models(jb.model_to_string(), tb.model_to_string())
    first = next(i for i, t in enumerate(jm.models) if t.num_leaves <= 1)
    assert first == len(tm.models)
    assert tree_diff(jm.models[:first], tm.models) is None
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), atol=1e-5)


def test_default_device_is_cuda():
    X, y = _lrb(100)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(lgt.LightGBMError):
        lgt.train({"objective": "binary"}, lgt.Dataset(X, label=y),
                  num_boost_round=1)
