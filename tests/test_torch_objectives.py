"""Port parity for every objective, metric and leaf renewal, query
groups and custom objectives (``fobj``), against the live JAX package
on the CPU.

Bars, each where it is checked:
- gradients: bit-equal to the JAX package's jitted ``get_gradients``
  for every objective, weighted and not, except where the JAX
  package's standalone function and its training step round apart:
  gamma follows the training step, which contracts 1 - y * exp(-s) into
  a fused multiply-add (the standalone function does not: g within
  ``GAMMA_G_ULPS``, h within ``GAMMA_H_ULPS`` ulps of it), and lambdarank,
  whose pair sums XLA's CPU compiler orders by the query width: bit-equal
  at the widths where that order was measured (below 12, 16-19 and
  24-31 in eight vector lanes, beyond 32 in windows of 32;
  ``f32math.xla_vec_sum``),
  within ``RANK_REL`` of the largest gradient of the set at the others;
  exp, log and log1p are XLA's CPU functions (ops/f32math.py), bit for
  bit;
- ``boost_from_score``: equal in float64;
- metrics: within 1e-10 relative of the JAX package's float64 host
  route on the same raw (or converted) scores;
- ``renew_leaf_outputs``: bit-equal, weighted and unweighted, with tied
  residuals, -0.0, bagging masks and the JAX package's padded width;
- lambdarank chunked and unchunked: bit-equal;
- training: trees equal to the JAX package's in structure and counts,
  leaves within 1e-5, each package reading the other's model text and
  predicting within 1e-5 of the package that wrote it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from chip_smoke import tree_diff
from lightgbm_tpu import capi as jcapi
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.metrics import create_metrics as j_create_metrics
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.objectives import create_objective as j_create_objective
from lightgbm_tpu.objectives.objective import \
    _lambdarank_grads as j_lambdarank_grads
from lightgbm_tpu.ops.renew import renew_leaf_outputs as j_renew
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.metrics import create_metrics
from lightgbm_tpu_torch.metrics.metric import _METRICS
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.objectives.objective import (_OBJECTIVES,
                                                     lambdarank_chunks,
                                                     lambdarank_grads)
from lightgbm_tpu_torch.ops.renew import renew_leaf_outputs
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port

GAMMA_G_ULPS = 1024
GAMMA_H_ULPS = 4
RANK_REL = 1e-6
LEAF_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small PyTorch ops: one thread each under parallel test
    workers (see tests/test_torch_train.py)."""
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


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in f32 ulps between two arrays."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max()) if np.size(a) else 0


# -- data ---------------------------------------------------------------------

N_ROWS = 2000
GROUPS = [100] * 12 + [1, 7, 33, 259, 500]        # 2000 rows, 17 queries


def _labels(objective: str, lin: np.ndarray, rng) -> np.ndarray:
    """A learnable label of ``objective``'s kind from the signal ``lin``."""
    n = len(lin)
    if objective in ("poisson", "gamma", "tweedie"):
        return np.exp(0.3 * lin) + 0.01
    if objective in ("cross_entropy", "xentropy", "cross_entropy_lambda",
                     "xentlambda"):
        return 1.0 / (1.0 + np.exp(-lin))
    if objective == "binary":
        return (lin + rng.normal(0, 0.5, n) > 0).astype(float)
    if objective in ("multiclass", "multiclassova"):
        return np.digitize(lin, [-1.0, 0.0, 1.0]).astype(float)
    if objective == "lambdarank":
        return np.clip(np.round(lin + 2.0), 0, 4)
    return lin + rng.normal(0, 0.3, n)


def _set(objective: str, n: int = N_ROWS, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 8))
    lin = X[:, 0] + 0.5 * X[:, 1] - X[:, 2] * X[:, 3]
    y = _labels(objective, lin, rng)
    group = GROUPS if objective == "lambdarank" else None
    return X, y, group


def _params(objective: str, **kw) -> dict:
    p = {"objective": objective, "num_leaves": 15, "learning_rate": 0.1,
         "min_data_in_leaf": 10, "max_bin": 63, "verbose": -1}
    if objective in ("multiclass", "multiclassova"):
        p["num_class"] = 4
    p.update(kw)
    return p


def _meta_pair(y, w, group):
    j = JMeta(label=y, weight=w, group=group)
    t = Metadata(label=y, weight=w, group=group)
    return j, t


# -- gradients and initial scores ---------------------------------------------

GRAD_OBJECTIVES = ["regression", "rmse", "regression_l1", "huber", "fair",
                   "poisson", "quantile", "mape", "gamma", "tweedie",
                   "binary", "multiclass", "multiclassova", "xentropy",
                   "xentlambda", "lambdarank"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", GRAD_OBJECTIVES)
def test_gradients_and_boost_from_score_match_jax(objective, weighted):
    """Each objective's gradients against the JAX package's jitted
    ``get_gradients`` on the same f32 scores (bars in the module
    docstring), and ``boost_from_score`` of every class equal in
    float64."""
    X, y, group = _set(objective, seed=3)
    n = len(y)
    rng = np.random.default_rng(4)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    params = _params(objective)
    jc, tc = JConfig().set(dict(params)), TConfig().set(dict(params))
    jo = j_create_objective(jc.objective, jc)
    to = create_objective(tc.objective, tc)
    jm, tm = _meta_pair(y, w, group)
    jo.init(jm, n)
    to.init(tm, n)
    K = to.num_model_per_iteration
    assert K == jo.num_model_per_iteration
    assert to.is_constant_hessian == jo.is_constant_hessian
    assert to.is_renew_tree_output() == jo.is_renew_tree_output()
    s = (rng.standard_normal((K, n)) * 2).astype(np.float32)
    s[:, ::97] = 0.0
    sj = s if K > 1 else s[0]
    gj, hj = (np.asarray(a) for a in jax.jit(jo.get_gradients)(
        jnp.asarray(sj)))
    gt, ht = (a.numpy() for a in to.get_gradients(torch.from_numpy(
        sj.copy())))
    assert gt.dtype == np.float32 and gt.shape == gj.shape
    if objective == "gamma":
        assert _ulps(gj, gt) <= GAMMA_G_ULPS
        assert _ulps(hj, ht) <= GAMMA_H_ULPS
    elif objective == "lambdarank":
        for a, b in ((gj, gt), (hj, ht)):
            assert np.abs(a - b).max() <= RANK_REL * np.abs(a).max()
    else:
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(ht, hj)
    for k in range(K):
        assert to.boost_from_score(k) == jo.boost_from_score(k)
    if to.is_renew_tree_output():
        assert (to.renew_tree_output_percentile()
                == jo.renew_tree_output_percentile())
    assert to.to_string() == jo.to_string()


def test_every_objective_alias_is_ported():
    from lightgbm_tpu.objectives.objective import _OBJECTIVES as J_OBJ
    assert set(_OBJECTIVES) == set(J_OBJ)
    for name, cls in J_OBJ.items():
        assert _OBJECTIVES[name].name == cls.name, name


@pytest.mark.parametrize("objective", ["regression", "rmse", "poisson",
                                       "gamma", "tweedie", "binary",
                                       "multiclass", "multiclassova",
                                       "xentropy", "xentlambda",
                                       "lambdarank"])
def test_convert_output_matches_jax(objective):
    """The output transforms, float64 here, against the JAX package's
    f32 ones: within the f32 rounding."""
    params = _params(objective)
    jc, tc = JConfig().set(dict(params)), TConfig().set(dict(params))
    jo = j_create_objective(jc.objective, jc)
    to = create_objective(tc.objective, tc)
    K = 4 if objective.startswith("multiclass") else 1
    raw = np.random.default_rng(5).normal(0, 2, (K, 300))
    want = np.asarray(jo.convert_output(jnp.asarray(raw, jnp.float32)))
    got = to.convert_output(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


# -- metrics ------------------------------------------------------------------

METRIC_CASES = [
    # (metric, objective whose labels it reads, objective passed to eval)
    ("l2", "regression", None), ("rmse", "regression", None),
    ("l1", "regression", None), ("quantile", "regression", None),
    ("huber", "regression", None), ("fair", "regression", None),
    ("poisson", "poisson", None), ("mape", "regression", None),
    ("gamma", "gamma", None), ("gamma_deviance", "gamma", None),
    ("tweedie", "tweedie", None),
    ("binary_logloss", "binary", "binary"),
    ("binary_logloss", "xentropy", None),
    ("binary_error", "binary", None), ("auc", "binary", None),
    ("multi_logloss", "multiclass", "multiclass"),
    ("multi_logloss", "multiclass", None),
    ("multi_error", "multiclass", None),
    ("cross_entropy", "xentropy", None),
    ("cross_entropy_lambda", "xentropy", None),
    ("kldiv", "xentropy", None),
    ("ndcg", "lambdarank", None), ("map", "lambdarank", None),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric,labels_of,objective", METRIC_CASES)
def test_metric_matches_jax(metric, labels_of, objective, weighted):
    """Each metric on the device route against the JAX package's float64
    host route (``Metric.eval``) on the same scores, within 1e-10
    relative. Metrics of converted scores get scores already converted
    in float64 and no objective, so both sides skip the f32 conversion
    of the JAX host route; the raw-score routes of binary_logloss and
    multi_logloss get their objective. NDCG and MAP at 1, 3, 5 and 10
    over queries of 1 to 500 rows with tied scores."""
    X, y, group = _set(labels_of, seed=6)
    n = len(y)
    rng = np.random.default_rng(7)
    w = rng.uniform(0.5, 2.0, n) if weighted else None
    K = 4 if labels_of.startswith("multiclass") else 1
    s = rng.normal(0, 1.5, (K, n)).astype(np.float32)
    s[:, ::13] = s[:, 1::13][:, :s[:, ::13].shape[1]]          # ties
    params = _params(labels_of, metric=metric, eval_at=[1, 3, 5, 10])
    jc, tc = JConfig().set(dict(params)), TConfig().set(dict(params))
    jm, tm = _meta_pair(y, w, group)
    jmet = j_create_metrics([metric], jc, jm, n)[0]
    tmet = create_metrics([metric], tc, tm, n)[0]
    scores = s.astype(np.float64)
    jo = to = None
    if objective is not None:
        jo = j_create_objective(objective, jc)
        to = create_objective(objective, tc)
        jo.init(jm, n)
        to.init(tm, n)
    elif metric in ("l2", "rmse", "l1", "quantile", "huber", "fair", "mape",
                    "auc", "kldiv", "cross_entropy_lambda"):
        pass                                  # raw scores as they are
    elif labels_of in ("poisson", "gamma", "tweedie"):
        scores = np.exp(scores)               # a positive mean
    elif K > 1:
        e = np.exp(scores - scores.max(0))
        scores = e / e.sum(0)
    else:
        scores = 1.0 / (1.0 + np.exp(-scores))
    want = jmet.eval(scores, jo)
    got = tmet.eval(torch.from_numpy(scores), to)
    got = got if isinstance(got, list) else [got]
    assert [name for name, _ in want] == tmet.names()
    for (_, v), g in zip(want, got):
        assert abs(g - v) <= 1e-10 * max(abs(v), 1e-12), (metric, g, v)


def test_every_metric_alias_is_ported():
    from lightgbm_tpu.metrics.metric import _METRICS as J_MET
    assert set(_METRICS) == set(J_MET)
    for name, cls in J_MET.items():
        assert _METRICS[name].name == cls.name, name


def test_default_metrics_match_jax():
    from lightgbm_tpu.basic import _resolve_metric_names
    from lightgbm_tpu.metrics.metric import \
        default_metric_for_objective as j_default
    from lightgbm_tpu_torch.metrics import (default_metric_for_objective,
                                            metric_names)
    for name in _OBJECTIVES:
        params = {"objective": name}
        if name.startswith(("multiclass", "softmax", "ova", "ovr")):
            params["num_class"] = 3
        assert metric_names(TConfig().set(dict(params))) == \
            _resolve_metric_names(JConfig().set(dict(params)))
        assert default_metric_for_objective(name) == j_default(name)


# -- leaf renewal -------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.5, 0.9, 0.3])
@pytest.mark.parametrize("weighted", [False, True])
def test_renew_matches_jax(weighted, alpha):
    """``renew_leaf_outputs`` bit-equal to the JAX package's: residuals
    rounded to 0.1 (ties, and -0.0), leaves with no rows, a bagging mask,
    and the JAX package's padded width (rows past the set, weight 0)
    against the port's ``sum_length``."""
    rng = np.random.default_rng(int(alpha * 10) + weighted)
    L = 31
    for n, pad in ((97, 0), (2000, 48), (5000, 3192)):
        lid = rng.integers(0, 20, n).astype(np.int32)
        res = np.round(rng.standard_normal(n) * 4, 1).astype(np.float32)
        w = rng.uniform(0.1, 3.0, n).astype(np.float32) if weighted else None
        mask = (rng.random(n) < 0.8).astype(np.float32)
        cur = rng.standard_normal(L).astype(np.float32)

        def padded(a, fill=0):
            return jnp.asarray(np.concatenate(
                [a, np.full(pad, fill, a.dtype)]))
        want = np.asarray(j_renew(
            padded(lid), padded(res), None if w is None else padded(w),
            L, alpha, jnp.asarray(cur), padded(mask)))
        got = renew_leaf_outputs(
            torch.from_numpy(lid), torch.from_numpy(res),
            None if w is None else torch.from_numpy(w), L, alpha,
            torch.from_numpy(cur), torch.from_numpy(mask),
            sum_length=n + pad).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


# -- lambdarank ---------------------------------------------------------------

def test_lambdarank_chunking_changes_no_bit():
    """The port's lambdarank gradients in chunks under a tiny byte cap
    (one to a few queries a chunk) equal those of one chunk holding
    every query at the longest query's width; both within ``RANK_REL``
    of the JAX package's padded computation."""
    rng = np.random.default_rng(8)
    counts = np.array([1, 2, 31, 32, 33, 64, 100, 7, 500, 64, 5])
    qb = np.concatenate([[0], np.cumsum(counts)])
    n = int(qb[-1])
    s = rng.standard_normal(n).astype(np.float32)
    y = rng.integers(0, 5, n)
    gain = np.array([2.0 ** i - 1 for i in range(31)], np.float32)
    imd = rng.uniform(0.01, 1.0, len(counts)).astype(np.float32)
    qmax = int(counts.max())
    args = (torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(qb),
            torch.from_numpy(imd), torch.from_numpy(gain), 1.0, qmax)
    one = [(np.arange(len(counts)), qmax)]
    small = lambdarank_chunks(counts, 200_000)
    assert len(small) >= 4
    lam1, hes1 = lambdarank_grads(*args, one)
    lam2, hes2 = lambdarank_grads(*args, small)
    assert torch.equal(lam1, lam2) and torch.equal(hes1, hes2)
    idx = np.zeros((len(counts), qmax), np.int32)
    valid = np.zeros((len(counts), qmax), bool)
    for q, c in enumerate(counts):
        idx[q, :c] = np.arange(qb[q], qb[q + 1])
        valid[q, :c] = True
    lj, hj = (np.asarray(a) for a in j_lambdarank_grads(
        s, y.astype(np.int32), idx, valid, imd, gain, 1.0))
    for a, b in ((lj, lam1.numpy()), (hj, hes1.numpy())):
        assert np.abs(a - b).max() <= RANK_REL * np.abs(a).max()


# -- training -----------------------------------------------------------------

def _check(jtext: str, ttext: str, X) -> None:
    """Trees equal in structure and counts, leaves within 1e-5; each
    package reads the other's text and predicts within 1e-5 of the one
    that wrote it."""
    jm = JaxGBDT().load_model_from_string(jtext)
    tm = lgt.Booster(model_str=ttext, device="cpu")._gbdt
    assert len(jm.models) == len(tm.models)
    assert tree_diff(jm.models, tm.models) is None, \
        tree_diff(jm.models, tm.models)
    for a, b in zip(jm.models, tm.models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, atol=LEAF_TOL)
        np.testing.assert_allclose(b.internal_value, a.internal_value,
                                   atol=LEAF_TOL)
    pj = JaxGBDT().load_model_from_string(jtext).predict(X)
    pt = lgt.Booster(model_str=ttext, device="cpu").predict(X)
    for text, own in ((ttext, pt), (jtext, pj)):
        np.testing.assert_allclose(
            JaxGBDT().load_model_from_string(text).predict(X), own,
            atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(
            lgt.Booster(model_str=text, device="cpu").predict(X), own,
            atol=1e-5, rtol=1e-6)


TRAIN_OBJECTIVES = ["multiclass", "multiclassova", "regression",
                    "regression_l1", "huber", "quantile", "poisson",
                    "tweedie", "xentropy", "lambdarank", "mape", "gamma",
                    "fair", "xentlambda"]


@pytest.mark.parametrize("objective", TRAIN_OBJECTIVES)
def test_train_matches_jax(objective):
    """``train`` for 8 iterations of 15 leaves against the JAX
    package's: trees equal (bars in ``_check``). Where the gradients
    are bit-equal, the model text before its parameters is byte-equal
    too (every objective here but lambdarank)."""
    X, y, group = _set(objective)
    params = _params(objective)
    jb = lgb.train(dict(params), lgb.Dataset(X, label=y, group=group), 8)
    tb = lgt.train(dict(params), lgt.Dataset(X, label=y, group=group), 8,
                   device="cpu")
    jt, tt = jb.model_to_string(), tb.model_to_string()
    _check(jt, tt, X)
    if objective != "lambdarank":
        assert tt.split("parameters:")[0] == jt.split("parameters:")[0]


def _rank_set(width: int, n_queries: int, seed: int):
    """Queries of one width, label ``clip(round(1.5 x0 + 1), 0, 3)``."""
    X = np.random.default_rng(seed).normal(size=(width * n_queries, 6))
    return X, np.clip(np.round(1.5 * X[:, 0] + 1), 0, 3), [width] * n_queries


@pytest.mark.parametrize("enable_bundle", ["false", "true"])
def test_lambdarank_second_input_matches_jax(enable_bundle):
    """200 queries of 30 rows (ROADMAP queue 3 N): the pair sums of a
    query at that width are XLA's vectorized loop (``f32math.
    xla_vec_sum``), so the gradients are bit-equal to the JAX package's
    training step and the model text before its parameters is byte-equal,
    with and without EFB bundles."""
    from test_torch_efb import one_hot_data
    X, _ = one_hot_data(6000, 5)
    y = np.clip(np.round(1.5 * X[:, 0] + 1), 0, 3)
    group = [30] * 200
    params = {"objective": "lambdarank", "num_leaves": 15, "verbose": -1,
              "enable_bundle": enable_bundle}
    jt = lgb.train(dict(params), lgb.Dataset(X, label=y, group=group),
                   4).model_to_string()
    tt = lgt.train(dict(params), lgt.Dataset(X, label=y, group=group), 4,
                   device="cpu").model_to_string()
    assert tt.split("parameters:")[0] == jt.split("parameters:")[0]


@pytest.mark.parametrize("width", [3, 9, 11, 16, 19, 24, 30, 31, 64, 100])
def test_lambdarank_grads_bit_equal_at_measured_widths(width):
    """The pair sums' order at the query widths where it was measured
    (``f32math.LANE_WIDTHS``, in sequence below 12, windows of 32 beyond
    32): lambdas and hessians bit-equal to the JAX package's jitted
    ``get_gradients`` on random scores."""
    X, y, group = _rank_set(width, max(2, 1500 // width), width)
    jm, tm = _meta_pair(y, None, group)
    jo = j_create_objective("lambdarank", JConfig().set(
        {"objective": "lambdarank"}))
    jo.init(jm, len(y))
    to = create_objective("lambdarank", TConfig().set(
        {"objective": "lambdarank"}))
    to.init(tm, len(y))
    s = np.random.default_rng(width + 1).normal(size=len(y)).astype(
        np.float32)
    gj, hj = jax.jit(jo.get_gradients)(jnp.asarray(s))
    g, h = to.get_gradients(torch.from_numpy(s))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


@pytest.mark.parametrize("objective", ["multiclass", "regression_l1",
                                       "quantile", "mape", "lambdarank"])
def test_train_weighted_bagged_matches_jax(objective):
    """Row weights, bagging and feature_fraction: the same rows and
    features drawn, weighted renewal and weighted softmax gradients."""
    X, y, group = _set(objective, seed=9)
    w = np.random.default_rng(10).uniform(0.5, 2.0, len(y))
    params = _params(objective, bagging_freq=1, bagging_fraction=0.7,
                     feature_fraction=0.8)
    jb = lgb.train(dict(params), lgb.Dataset(X, label=y, weight=w,
                                             group=group), 8)
    tb = lgt.train(dict(params), lgt.Dataset(X, label=y, weight=w,
                                             group=group), 8, device="cpu")
    _check(jb.model_to_string(), tb.model_to_string(), X)


@pytest.mark.parametrize("objective", ["regression", "multiclass"])
def test_int8_tier_matches_jax(objective):
    """The int8 tier (exact counts) on L2's constant hessians and on
    multiclass hessians: trees equal to the JAX package's."""
    X, y, group = _set(objective, seed=11)
    params = _params(objective, tpu_quantized_hist="true",
                     tpu_count_proxy=0)
    jb = lgb.train(dict(params), lgb.Dataset(X, label=y), 6)
    tb = lgt.train(dict(params), lgt.Dataset(X, label=y), 6, device="cpu")
    assert tb._gbdt._grower_cfg.precision == "int8"
    _check(jb.model_to_string(), tb.model_to_string(), X)


@pytest.mark.parametrize("objective,weighted,want", [
    ("regression", False, 40), ("regression_l1", False, 40),
    ("poisson", False, 40), ("regression", True, 32), ("binary", False, 32),
    ("multiclass", False, 32)])
def test_exact_tier_wave_cap_matches_jax(objective, weighted, want):
    """Off the TPU the JAX package takes the hilo3 wave cap (40) for a
    constant-hessian objective without weights under gbdt, else hilo4
    (32); so does the port."""
    X, y, _ = _set(objective, n=600)
    w = np.ones(len(y)) if weighted else None
    params = _params(objective, num_leaves=63)
    jb = lgb.Booster(dict(params), lgb.Dataset(X, label=y, weight=w))
    tb = lgt.Booster(dict(params), lgt.Dataset(X, label=y, weight=w),
                     device="cpu")
    assert tb._gbdt._grower_cfg.wave_size == want
    assert jb._gbdt._grower_cfg.wave_size == want


def test_multiclass_valid_set_early_stops_like_jax():
    """Multiclass with a valid set and ``early_stopping_rounds`` on
    multi_logloss: the same best iteration as the JAX package, the
    recorded values within 1e-5 relative (the JAX package evaluates in
    f32 on its device route), the valid scores bit-equal after every
    iteration (read by a callback: the JAX package's training loop may
    dispatch one iteration past the stop)."""
    X, y, _ = _set("multiclass", n=3000, seed=12)
    Xv, yv, X, y = X[2000:], y[2000:], X[:2000], y[:2000]
    params = _params("multiclass", metric="multi_logloss,multi_error",
                     learning_rate=0.3)
    runs = {}
    for name, pkg, kw in (("jax", lgb, {}), ("port", lgt,
                                             {"device": "cpu"})):
        ev, seen = {}, []

        def snapshot(env, seen=seen):
            seen.append(np.array(env.model._gbdt._valid_scores[0]))
        snapshot.order = 100
        ds = pkg.Dataset(X, label=y)
        b = pkg.train(dict(params), ds, 60,
                      valid_sets=[pkg.Dataset(Xv, label=yv, reference=ds)],
                      early_stopping_rounds=3, evals_result=ev,
                      verbose_eval=False, callbacks=[snapshot], **kw)
        runs[name] = (b, ev, seen)
    (jb, jev, jseen), (tb, tev, tseen) = runs["jax"], runs["port"]
    assert 5 < tb.best_iteration == jb.best_iteration < 60
    for key in ("multi_logloss", "multi_error"):
        a, b = np.asarray(jev["valid_0"][key]), np.asarray(tev["valid_0"][key])
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
    assert len(jseen) == len(tseen)
    for a, b in zip(jseen, tseen):
        np.testing.assert_array_equal(b, a)
    _check(jb.model_to_string(), tb.model_to_string(), X)


# -- custom objectives --------------------------------------------------------

def _l2_fobj(preds, data):
    """L2's gradients from the raw scores (float64, as fobj gets them)."""
    return preds - data.get_label(), np.ones_like(preds)


def _softmax_fobj(preds, data):
    """Multiclass softmax gradients, class-major."""
    k = 4
    s = preds.reshape(k, -1)
    p = np.exp(s - s.max(0))
    p /= p.sum(0)
    yi = data.get_label().astype(int)
    onehot = np.zeros_like(p)
    onehot[yi, np.arange(p.shape[1])] = 1.0
    return (p - onehot).reshape(-1), (2.0 * p * (1.0 - p)).reshape(-1)


def test_fobj_through_train_update_and_capi():
    """A custom objective with L2's gradients gives the model text of
    ``objective=regression`` (boost_from_average off, as custom
    gradients have no average to start from) through ``train(fobj=)``,
    ``Booster.update(fobj=)`` and ``LGBM_BoosterUpdateOneIterCustom``,
    and the JAX package's text through its ``train(fobj=)``."""
    X, y, _ = _set("regression", seed=14)
    params = _params("regression", boost_from_average=False)
    plain = lgt.train(dict(params), lgt.Dataset(X, label=y), 6,
                      device="cpu").model_to_string()
    by_train = lgt.train(dict(params), lgt.Dataset(X, label=y), 6,
                         fobj=_l2_fobj, device="cpu").model_to_string()
    assert by_train == plain
    bst = lgt.Booster(dict(params), lgt.Dataset(X, label=y), device="cpu")
    for _ in range(6):
        bst.update(fobj=_l2_fobj)
    assert bst.model_to_string() == plain
    ds = tcapi.LGBM_DatasetCreateFromMat(X, parameters=params, device="cpu")
    tcapi.LGBM_DatasetSetField(ds, "label", y)
    h = tcapi.LGBM_BoosterCreate(ds, params)
    lab = y.astype(np.float32)
    for _ in range(6):
        score = h.gbdt.train_scores()[0].numpy().astype(np.float64)
        g = (score - lab).astype(np.float32)
        assert tcapi.LGBM_BoosterUpdateOneIterCustom(
            h, g, np.ones_like(g)) == 0
    assert tcapi.LGBM_BoosterSaveModelToString(h) == plain
    with pytest.raises(lgt.LightGBMError, match="num_data"):
        tcapi.LGBM_BoosterUpdateOneIterCustom(h, g[:-1], g[:-1])
    jtext = lgb.train(dict(params), lgb.Dataset(X, label=y), 6,
                      fobj=_l2_fobj).model_to_string()
    assert jtext.split("parameters:")[0] == plain.split("parameters:")[0]


def test_multiclass_fobj_matches_jax():
    """Custom softmax gradients for four classes through ``train`` and
    the objective-less booster (``objective=none``): trees equal to the
    JAX package's with the same fobj."""
    X, y, _ = _set("multiclass", seed=15)
    params = _params("none", num_class=4)
    jb = lgb.train(dict(params), lgb.Dataset(X, label=y), 4,
                   fobj=_softmax_fobj)
    tb = lgt.train(dict(params), lgt.Dataset(X, label=y), 4,
                   fobj=_softmax_fobj, device="cpu")
    assert tb.num_model_per_iteration() == 4
    _check(jb.model_to_string(), tb.model_to_string(), X)
    with pytest.raises(ValueError, match="num_data"):
        lgt.Booster(dict(params), lgt.Dataset(X, label=y),
                    device="cpu").update(fobj=lambda p, d: (p[:5], p[:5]))


def test_cv_with_fobj_and_groups():
    """``cv`` with a custom objective, and a ranking cv whose folds keep
    each query whole (GroupKFold), against the JAX package's."""
    X, y, group = _set("lambdarank", seed=16)
    params = _params("lambdarank", metric="ndcg", eval_at=[3])
    jr = lgb.cv(dict(params), lgb.Dataset(X, label=y, group=group), 3,
                nfold=3)
    tr = lgt.cv(dict(params), lgt.Dataset(X, label=y, group=group), 3,
                nfold=3, device="cpu")
    assert set(tr) == set(jr) == {"ndcg@3-mean", "ndcg@3-stdv"}
    np.testing.assert_allclose(tr["ndcg@3-mean"], jr["ndcg@3-mean"],
                               rtol=1e-5)
    X, y, _ = _set("regression", seed=17)
    params = _params("regression", boost_from_average=False, metric="l2")
    a = lgt.cv(dict(params), lgt.Dataset(X, label=y), 3, nfold=3,
               stratified=False, device="cpu")
    b = lgt.cv(dict(params), lgt.Dataset(X, label=y), 3, nfold=3,
               stratified=False, fobj=_l2_fobj, device="cpu")
    assert a == b


# -- query groups -------------------------------------------------------------

def test_group_through_dataset_fields_and_capi():
    """``group`` through ``Dataset(group=)``, ``set_group``,
    ``set_field``/``get_field`` and the C API's SetField/GetField: the
    same query boundaries as the JAX package's, and lambdarank through
    the C API equal to ``train``."""
    X, y, group = _set("lambdarank", seed=18)
    want = np.asarray(GROUPS)
    ds = lgt.Dataset(X, label=y, group=group)
    np.testing.assert_array_equal(ds.get_group(), want)
    ds.construct("cpu")
    np.testing.assert_array_equal(ds.get_field("group"), want)
    np.testing.assert_array_equal(ds._inner.metadata.query_boundaries,
                                  JMeta(group=group).query_boundaries)
    other = lgt.Dataset(X, label=y).set_field("group", group)
    np.testing.assert_array_equal(other.get_group(), want)
    params = _params("lambdarank", metric="ndcg,map", eval_at="1,3")
    text = lgt.train(dict(params), lgt.Dataset(X, label=y, group=group), 4,
                     device="cpu").model_to_string()
    for capi, kw in ((tcapi, {"device": "cpu"}), (jcapi, {})):
        h = capi.LGBM_DatasetCreateFromMat(X, parameters=params, **kw)
        capi.LGBM_DatasetSetField(h, "label", y)
        capi.LGBM_DatasetSetField(h, "group", np.asarray(group, np.int32))
        bst = capi.LGBM_BoosterCreate(h, params)
        np.testing.assert_array_equal(
            capi.LGBM_DatasetGetField(h, "group"), want)
        for _ in range(4):
            capi.LGBM_BoosterUpdateOneIter(bst)
        got = capi.LGBM_BoosterSaveModelToString(bst)
        if capi is tcapi:
            assert got == text
            assert tcapi.LGBM_BoosterGetEvalNames(bst) == [
                "ndcg@1", "ndcg@3", "map@1", "map@3"]
        else:
            _check(got, text, X)
    with pytest.raises(lgt.LightGBMError, match="query"):
        lgt.train(_params("lambdarank"), lgt.Dataset(X, label=y), 1,
                  device="cpu")
