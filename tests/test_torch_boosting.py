"""Port parity for the boosting variants (GOSS, DART, RF), forced splits
and continued training: the port (lightgbm_tpu_torch, ``device="cpu"``)
against the JAX package on the CPU, on the same numpy inputs made from a
seed.

Bars: the model text before its parameters block byte-equal to the JAX
package's in every training case here but one: GOSS on the int8 tier
with exact counts parts from it by an ulp in some split gains and leaf
values from the fourth tree on (ROADMAP queue 3 E: the JAX package's
int8 sums are sometimes rounded twice where XLA fuses), and since the
scores then part by an ulp, rows at GOSS's threshold can be kept in one
package and not in the other, and later trees are other draws. There
the first three trees (two of warm-up, the first sampled, whose root
counts only the kept rows) are byte-equal. GOSS's hashed sampler (kept
mask,
amplified g and h) bit-equal to the JAX ``_hash_hook`` with and without
its padded ``rvalid``, and its legacy sampler (``tpu_goss_hash=0``) to
``_legacy_hook``, whose threefry2x32 uniforms (ops/threefry.py) are
bit-equal to ``jax.random.uniform``'s; DART's dropped iterations equal and its train
scores bit-equal after every iteration; RF's and DART's scores after a
rollback or with a valid set bit-equal; merged and continued models'
texts byte-equal and their raw scores equal. Valid metrics within 1e-6
relative (the port evaluates in float64, the JAX package's device route
in f32). The JAX package lowers its own log level under ``verbose=-1``,
so each test restores both packages' levels.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import capi as jcapi
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.models.boosting import (goss_sample,
                                                legacy_goss_sample)
from lightgbm_tpu_torch.ops import threefry
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden2")
REL = 1e-6


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


def _set(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 8))
    lin = X[:, 0] + 0.5 * X[:, 1] - X[:, 2] * X[:, 3]
    return X, lin, rng


def _labels(objective, lin, rng):
    if objective == "binary":
        return (lin + rng.normal(0, 0.5, len(lin)) > 0).astype(float)
    if objective == "multiclass":
        return np.digitize(lin, [-1.0, 0.0, 1.0]).astype(float)
    return lin + rng.normal(0, 0.3, len(lin))


def _params(objective="binary", **kw):
    p = {"objective": objective, "num_leaves": 15, "learning_rate": 0.1,
         "min_data_in_leaf": 10, "max_bin": 63, "verbose": -1}
    if objective == "multiclass":
        p["num_class"] = 4
    p.update(kw)
    return p


def _body(text: str) -> str:
    """Model text before its parameters block."""
    return text.split("parameters:")[0]




def _train_both(params, X, y, rounds, **kw):
    jb = lgb.train(dict(params), lgb.Dataset(X, label=y), rounds,
                   verbose_eval=False, **kw.pop("jax", {}), **kw)
    tb = lgt.train(dict(params), lgt.Dataset(X, label=y), rounds,
                   verbose_eval=False, device="cpu", **kw)
    return jb, tb


# -- GOSS ---------------------------------------------------------------------

def _jax_hook(X, y, **kw):
    gbm = lgb.train(_params(boosting="goss", **kw), lgb.Dataset(X, label=y),
                    num_boost_round=1, verbose_eval=False,
                    keep_training_booster=True)
    return gbm._gbdt._sample_hook


@pytest.mark.parametrize("K,width,tail", [(1, None, 0), (1, 2048, 0),
                                          (3, 2048, 0), (1, 1500, 300),
                                          (3, None, 300)])
def test_goss_hash_hook_bit_equal(K, width, tail):
    """The kept mask and the amplified g and h, bit for bit, against the
    JAX hook on the exact width (``rvalid`` None) and on a padded width
    with its ``rvalid`` mask; with valid-set passengers after the rows
    (their mask stays 0)."""
    X, lin, rng = _set()
    n = 1500
    hook = _jax_hook(X, _labels("binary", lin, rng), top_rate=0.15,
                     other_rate=0.2)
    g = rng.normal(size=(K, n)).astype(np.float32)
    h = rng.uniform(0.01, 0.25, (K, n)).astype(np.float32)
    g[:, :40] = g[:, 40:80]           # ties at and around the threshold
    h[:, :40] = h[:, 40:80]
    mask = np.concatenate([np.ones(n, np.float32),
                           np.zeros(tail, np.float32)])
    for key in (0, 17, 123456789, 2 ** 31 - 1):
        w = width or n
        gp = np.zeros((K, w), np.float32)
        hp = np.zeros((K, w), np.float32)
        gp[:, :n], hp[:, :n] = g, h
        rv = None
        mp = np.concatenate([np.ones(n, np.float32),
                             np.zeros(w - n + tail, np.float32)])
        if width:
            rv = jnp.asarray(np.arange(w) < n)
        jg, jh, jm = hook(jnp.asarray(gp), jnp.asarray(hp),
                          jnp.asarray(mp), jnp.asarray([0, key], jnp.uint32),
                          rv)
        tg, th, tm = goss_sample(torch.from_numpy(g), torch.from_numpy(h),
                                 torch.from_numpy(mask), key, 0.15, 0.2)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg)[:, :n])
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh)[:, :n])
        jm = np.asarray(jm)
        np.testing.assert_array_equal(tm.numpy()[:n], jm[:n])
        assert not tm.numpy()[n:].any()
        if key:
            kept = int(tm.numpy().sum())
            assert 0.3 * n <= kept < 0.5 * n, kept


def test_goss_warmup_does_not_advance_the_stream():
    """The key stream starts after int(1 / learning_rate) = 4
    iterations: after 7, three keys were drawn, in the port as in the
    JAX package, and the two models are equal."""
    X, lin, rng = _set()
    y = _labels("binary", lin, rng)
    params = _params(boosting="goss", learning_rate=0.25)
    boosters = [lgb.Booster(dict(params), lgb.Dataset(X, label=y)),
                lgt.Booster(dict(params), lgt.Dataset(X, label=y),
                            device="cpu")]
    for b in boosters:
        for _ in range(7):
            b.update()
    ref = np.random.default_rng(boosters[1]._gbdt.config.bagging_seed)
    ref.integers(1, 2 ** 31, 3)
    for b in boosters:
        assert b._gbdt._hook_rng.bit_generator.state == \
            ref.bit_generator.state
    assert _body(boosters[1].model_to_string()) == \
        _body(boosters[0].model_to_string())


@pytest.mark.parametrize("objective,extra", [
    ("binary", {}), ("multiclass", {}),
    ("binary", {"tpu_quantized_hist": "true", "tpu_count_proxy": 0}),
    ("regression", {"top_rate": 0.3, "other_rate": 0.3})])
def test_goss_text_matches_jax(objective, extra):
    """GOSS from iteration 3 (learning_rate 0.5): the model text equal to
    the JAX package's on the exact tier; on the int8 tier (whose
    quantization sees the amplified gradients) the bar of the module
    docstring."""
    X, lin, rng = _set(seed=3)
    y = _labels(objective, lin, rng)
    params = _params(objective, boosting="goss", learning_rate=0.5, **extra)
    jb, tb = _train_both(params, X, y, 10)
    assert tb._gbdt._grower_cfg.wave_size == jb._gbdt._grower_cfg.wave_size
    jt, tt = jb.model_to_string(), tb.model_to_string()
    if extra.get("tpu_quantized_hist"):
        def first3(text):
            head, trees = _body(text).split("\nTree=0\n")
            return head.split("tree_sizes=")[0], trees.split("\nTree=3\n")[0]
        assert first3(tt) == first3(jt)
        root = tb._gbdt.models[2].internal_count[0]
        assert 0.25 * len(y) < root < 0.4 * len(y), root
    else:
        assert _body(tt) == _body(jt)


def test_goss_refusals():
    """Bagging under GOSS is refused as in the JAX package; the legacy
    sampler (``tpu_goss_hash=0``) trains, without the step cache, as
    there."""
    X, lin, rng = _set(n=300)
    y = _labels("binary", lin, rng)
    bag = _params(boosting="goss", bagging_freq=1, bagging_fraction=0.5)
    for pkg, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        with pytest.raises(Exception, match="bagging"):
            pkg.train(dict(bag), pkg.Dataset(X, label=y), 2,
                      verbose_eval=False, **kw)
    b = lgt.train(_params(boosting="goss", tpu_goss_hash=0),
                  lgt.Dataset(X, label=y), 2, device="cpu")
    assert b._gbdt._step_pool() is None


def _partitionable():
    """The stream ops/threefry.py follows; another one is a failure to
    report, not a stream to switch to."""
    assert jax.config.jax_threefry_partitionable, (
        "jax_threefry_partitionable is off: jax.random draws another "
        "stream than ops/threefry.py's")


@pytest.mark.parametrize("n", [1, 7, 1000, 65_537])
@pytest.mark.parametrize("seed", [1, 987_654_321, 2 ** 31 - 1])
def test_threefry_uniform_bit_equal_jax(n, seed):
    """``PRNGKey(seed)``'s words and ``uniform(key, (n,))`` bit for bit."""
    _partitionable()
    key = jax.random.PRNGKey(seed)
    assert tuple(int(w) for w in np.asarray(key)) == threefry.prng_key(seed)
    want = np.asarray(jax.random.uniform(key, (n,)))
    got = threefry.uniform(threefry.prng_key(seed), n).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("K,tail", [(1, 0), (3, 0), (1, 300)])
def test_goss_legacy_hook_bit_equal(K, tail):
    """The legacy sampler's kept mask and amplified g and h, bit for
    bit, against the JAX ``_legacy_hook`` (ties at the threshold; a
    zero key passes everything; passengers' mask stays 0)."""
    _partitionable()
    X, lin, rng = _set()
    n = 1500
    gbm = lgb.train(_params(boosting="goss", tpu_goss_hash=0, top_rate=0.15,
                            other_rate=0.2),
                    lgb.Dataset(X, label=_labels("binary", lin, rng)),
                    num_boost_round=1, verbose_eval=False,
                    keep_training_booster=True)
    hook = gbm._gbdt._sample_hook
    g = rng.normal(size=(K, n)).astype(np.float32)
    h = rng.uniform(0.01, 0.25, (K, n)).astype(np.float32)
    g[:, :40] = g[:, 40:80]
    h[:, :40] = h[:, 40:80]
    mask = np.concatenate([np.ones(n, np.float32),
                           np.zeros(tail, np.float32)])
    for seed in (0, 17, 123456789, 2 ** 31 - 1):
        jg, jh, jm = hook(jnp.asarray(g), jnp.asarray(h), jnp.asarray(mask),
                          jax.random.PRNGKey(seed))
        tg, th, tm = legacy_goss_sample(
            torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(mask),
            seed, 0.15, 0.2)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        if seed:
            kept = int(tm.numpy().sum())
            assert 0.3 * n <= kept < 0.5 * n, kept


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_goss_legacy_text_matches_jax(objective):
    """``tpu_goss_hash=0`` from iteration 3 (two of warm-up at
    learning_rate 0.5): the model text byte-equal to the JAX package's."""
    _partitionable()
    X, lin, rng = _set(seed=5)
    y = _labels(objective, lin, rng)
    params = _params(objective, boosting="goss", learning_rate=0.5,
                     tpu_goss_hash=0)
    jb, tb = _train_both(params, X, y, 8)
    assert _body(tb.model_to_string()) == _body(jb.model_to_string())
    assert tb._gbdt._step_pool() is None


# -- DART ---------------------------------------------------------------------

DART_MODES = [{}, {"uniform_drop": True}, {"xgboost_dart_mode": True},
              {"uniform_drop": True, "xgboost_dart_mode": True}]


@pytest.mark.parametrize("mode", DART_MODES)
def test_dart_drops_scores_and_text_match_jax(mode):
    """Each iteration's dropped iterations as the JAX package's, the
    train scores bit-equal after every iteration, and the model text
    (each dropped tree rescaled) equal."""
    X, lin, rng = _set(seed=5)
    y = _labels("binary", lin, rng)
    params = _params(boosting="dart", drop_rate=0.3, skip_drop=0.2, **mode)
    jb = lgb.Booster(dict(params), lgb.Dataset(X, label=y))
    tb = lgt.Booster(dict(params), lgt.Dataset(X, label=y), device="cpu")
    n = len(y)
    dropped = 0
    for _ in range(12):
        jb.update()
        tb.update()
        assert tb._gbdt._drop_index == jb._gbdt._drop_index
        dropped += len(jb._gbdt._drop_index)
        np.testing.assert_array_equal(
            tb._gbdt.train_scores().numpy(),
            np.asarray(jb._gbdt.train_scores())[:, :n])
    assert dropped > 0
    assert _body(tb.model_to_string()) == _body(jb.model_to_string())


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_dart_with_valid_set_matches_jax(objective):
    """DART with a valid set: its scores patched at each normalisation
    as the JAX package's (bit-equal), the metrics within 1e-6, the text
    equal."""
    X, lin, rng = _set(seed=6)
    y = _labels(objective, lin, rng)
    Xv, linv, _ = _set(n=400, seed=7)
    yv = _labels(objective, linv, rng)
    params = _params(objective, boosting="dart", drop_rate=0.4,
                     skip_drop=0.1)
    res = {}
    for name, pkg, kw in (("jax", lgb, {}), ("port", lgt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        ev = {}
        b = pkg.train(dict(params), ds, 8, verbose_eval=False,
                      valid_sets=[ds.create_valid(Xv, label=yv)],
                      evals_result=ev, keep_training_booster=True, **kw)
        res[name] = (b, ev["valid_0"])
    (jb, jev), (tb, tev) = res["jax"], res["port"]
    np.testing.assert_array_equal(tb._gbdt.valid_scores(1).numpy(),
                                  np.asarray(jb._gbdt._valid_scores[0]))
    for metric, vals in jev.items():
        np.testing.assert_allclose(tev[metric], vals, rtol=REL)
    assert _body(tb.model_to_string()) == _body(jb.model_to_string())


# -- RF -----------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["binary", "multiclass",
                                       "regression_l1"])
def test_rf_text_matches_jax(objective):
    """RF on fixed targets under bagging: the model text (with
    ``average_output``) equal to the JAX package's; the L1 family renewed
    against zero scores; predictions averaged over the iterations."""
    X, lin, rng = _set(seed=8)
    y = _labels(objective, lin, rng)
    params = _params(objective, boosting="rf", bagging_freq=1,
                     bagging_fraction=0.632, feature_fraction=0.8)
    jb, tb = _train_both(params, X, y, 10)
    text = tb.model_to_string()
    assert "\naverage_output\n" in text
    assert _body(text) == _body(jb.model_to_string())
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), atol=1e-6)


def test_rf_rollback_matches_jax():
    """RF's rollback takes the last trees out of the running means: the
    train and valid scores bit-equal to the JAX package's after two
    rollbacks, and training goes on to the same text."""
    X, lin, rng = _set(seed=9)
    y = _labels("binary", lin, rng)
    Xv, linv, _ = _set(n=300, seed=10)
    yv = _labels("binary", linv, rng)
    params = _params(boosting="rf", bagging_freq=1, bagging_fraction=0.7)
    boosters = []
    for pkg, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        b = pkg.Booster(dict(params), ds, **kw)
        b.add_valid(ds.create_valid(Xv, label=yv), "v")
        for _ in range(6):
            b.update()
        b.rollback_one_iter()
        b.rollback_one_iter()
        boosters.append(b)
    jb, tb = boosters
    n = len(y)
    np.testing.assert_array_equal(tb._gbdt.train_scores().numpy(),
                                  np.asarray(jb._gbdt.train_scores())[:, :n])
    np.testing.assert_array_equal(tb._gbdt.valid_scores(1).numpy(),
                                  np.asarray(jb._gbdt._valid_scores[0]))
    for b in boosters:
        b.update()
    assert tb.current_iteration() == 5
    assert _body(tb.model_to_string()) == _body(jb.model_to_string())


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_rf_valid_added_late_is_the_running_mean(objective):
    """A valid set added to RF after two iterations starts from the
    running mean of the trees so far, not their sum: its scores
    bit-equal to those of a set there from the first iteration, after
    the late add and three iterations on. The JAX package sums (ROADMAP
    queue 3, where the reference is at fault); its late scores are the
    sum here, to show the difference is real."""
    X, lin, rng = _set(seed=11)
    y = _labels(objective, lin, rng)
    Xv, linv, _ = _set(n=300, seed=12)
    yv = _labels(objective, linv, rng)
    params = _params(objective, boosting="rf", bagging_freq=1,
                     bagging_fraction=0.7)

    def run(pkg, late, **kw):
        ds = pkg.Dataset(X, label=y)
        b = pkg.Booster(dict(params), ds, **kw)
        if not late:
            b.add_valid(ds.create_valid(Xv, label=yv), "v")
        for _ in range(2):
            b.update()
        if late:
            b.add_valid(ds.create_valid(Xv, label=yv), "v")
        return b

    early, late = run(lgt, False, device="cpu"), run(lgt, True, device="cpu")
    np.testing.assert_array_equal(late._gbdt.valid_scores(1).numpy(),
                                  early._gbdt.valid_scores(1).numpy())
    jlate = np.asarray(run(lgb, True)._gbdt._valid_scores[0])
    np.testing.assert_allclose(jlate, 2 * early._gbdt.valid_scores(1).numpy(),
                               rtol=1e-5, atol=1e-6)
    for b in (early, late):
        for _ in range(3):
            b.update()
    np.testing.assert_array_equal(late._gbdt.valid_scores(1).numpy(),
                                  early._gbdt.valid_scores(1).numpy())


# -- forced splits ------------------------------------------------------------

FORCED_3 = {"feature": 2, "threshold": 0.1,
            "left": {"feature": 0, "threshold": -0.3},
            "right": {"feature": 3, "threshold": 0.5}}
FORCED_7 = {"feature": 2, "threshold": 0.1,
            "left": {"feature": 0, "threshold": -0.3,
                     "left": {"feature": 1, "threshold": 0.0},
                     "right": {"feature": 4, "threshold": 0.2}},
            "right": {"feature": 3, "threshold": 0.5,
                      "left": {"feature": 5, "threshold": -0.1},
                      "right": {"feature": 6, "threshold": 0.7}}}


def _forced(tmp_path, spec) -> str:
    path = str(tmp_path / "forced.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    return path


@pytest.mark.parametrize("spec,objective,extra", [
    (FORCED_3, "binary", {}), (FORCED_7, "binary", {}),
    (FORCED_7, "regression", {}),
    (FORCED_3, "binary", {"bagging_freq": 1, "bagging_fraction": 0.7}),
    (FORCED_3, "binary", {"tpu_quantized_hist": "true",
                          "tpu_count_proxy": 0}),
    (FORCED_3, "binary", {"max_bin": 15})])
def test_forced_splits_match_jax(tmp_path, spec, objective, extra):
    """Every tree starts with the forced splits in BFS order, and the
    model text equals the JAX package's (the forced gains rounded as its
    jitted grower rounds them; on the int8 tier the right child's
    subtraction fuses the dequantization)."""
    X, lin, rng = _set(seed=11)
    y = _labels(objective, lin, rng)
    params = _params(objective, forcedsplits_filename=_forced(tmp_path,
                                                              spec), **extra)
    jb, tb = _train_both(params, X, y, 6)
    text = tb.model_to_string()
    forced = tb._gbdt._grower_cfg.forced
    assert len(forced) == (3 if spec is FORCED_3 else 7)
    for tree in tb._gbdt.models:
        assert tree.split_feature[:len(forced)] == [f for _, f, _ in forced]
    assert _body(text) == _body(jb.model_to_string())


def test_forced_splits_skip_unused_and_categorical(tmp_path):
    """A node on an unused (constant) feature and a node on a
    categorical one are skipped with their subtrees, as in the JAX
    package; the other nodes keep their BFS leaf numbers."""
    X, lin, rng = _set(seed=12)
    X[:, 5] = 1.0                               # unused
    X[:, 6] = rng.integers(0, 5, len(X))        # categorical
    y = _labels("binary", lin, rng)
    spec = {"feature": 2, "threshold": 0.1,
            "left": {"feature": 5, "threshold": 1.0,
                     "left": {"feature": 0, "threshold": 0.0}},
            "right": {"feature": 6, "threshold": 2,
                      "right": {"feature": 1, "threshold": 0.0}},
            }
    params = _params(forcedsplits_filename=_forced(tmp_path, spec))
    res = []
    for pkg, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        res.append(pkg.train(dict(params),
                             pkg.Dataset(X, label=y, categorical_feature=[6]),
                             4, verbose_eval=False, **kw))
    jb, tb = res
    assert tb._gbdt._grower_cfg.forced == ((0, 2, tb._gbdt._grower_cfg
                                            .forced[0][2]),)
    assert tb._gbdt._grower_cfg.forced == jb._gbdt._grower_cfg.forced
    assert _body(tb.model_to_string()) == _body(jb.model_to_string())


def test_forced_splits_exclude_count_proxy_and_packed4(tmp_path):
    """Forced splits turn off the count-proxy tier (int8 with exact
    counts instead) and 4-bit packed bins, as the JAX package does."""
    X, lin, rng = _set(n=600, seed=13)
    y = _labels("binary", lin, rng)
    path = _forced(tmp_path, FORCED_3)
    q = lgt.Booster(_params(tpu_quantized_hist="true", max_bin=15,
                            forcedsplits_filename=path),
                    lgt.Dataset(X, label=y), device="cpu")._gbdt._grower_cfg
    assert q.precision == "int8" and not q.count_proxy and not q.packed4
    e = lgt.Booster(_params(max_bin=15, forcedsplits_filename=path),
                    lgt.Dataset(X, label=y), device="cpu")._gbdt._grower_cfg
    assert e.precision == "f32" and not e.packed4 and len(e.forced) == 3
    plain = lgt.Booster(_params(max_bin=15), lgt.Dataset(X, label=y),
                        device="cpu")._gbdt._grower_cfg
    assert plain.packed4


# -- continued training -------------------------------------------------------

@pytest.mark.parametrize("as_booster", [False, True])
def test_init_model_matches_jax(tmp_path, as_booster):
    """``train(init_model=)`` from a model file or a Booster: the init
    model's raw scores start the scores, and the new trees' text equals
    the JAX package's; the callbacks count on from the init model's
    iterations."""
    X, lin, rng = _set(seed=14)
    y = _labels("binary", lin, rng)
    params = _params()
    jb0 = lgb.train(dict(params), lgb.Dataset(X, label=y), 5,
                    verbose_eval=False)
    path = str(tmp_path / "init.txt")
    jb0.save_model(path)
    tb0 = lgt.Booster(model_file=path, device="cpu")
    seen = []

    def spy(env):
        seen.append((env.iteration, env.begin_iteration, env.end_iteration))
    jinit = jb0 if as_booster else path
    tinit = tb0 if as_booster else path
    jb = lgb.train(dict(params), lgb.Dataset(X, label=y), 4,
                   init_model=jinit, verbose_eval=False)
    tb = lgt.train(dict(params), lgt.Dataset(X, label=y), 4,
                   init_model=tinit, verbose_eval=False, device="cpu",
                   callbacks=[spy])
    assert seen == [(i, 5, 9) for i in range(5, 9)]
    assert tb.num_trees() == 4
    assert _body(tb.model_to_string()) == _body(jb.model_to_string())
    np.testing.assert_allclose(
        tb.predict(X, raw_score=True) + tb0.predict(X, raw_score=True),
        jb.predict(X, raw_score=True) + jb0.predict(X, raw_score=True),
        atol=1e-6)


def test_init_model_valid_set_and_cv(tmp_path):
    """A valid set inherits the train set's init model, so its scores
    start from the init model's too (the JAX package's scores, bit for
    bit); ``cv`` with an init model gives the JAX package's history."""
    X, lin, rng = _set(seed=15)
    y = _labels("binary", lin, rng)
    Xv, linv, _ = _set(n=400, seed=16)
    yv = _labels("binary", linv, rng)
    params = _params(metric="binary_logloss")
    path = str(tmp_path / "init.txt")
    lgb.train(dict(params), lgb.Dataset(X, label=y), 5,
              verbose_eval=False).save_model(path)
    out = []
    for pkg, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        ev = {}
        b = pkg.train(dict(params), ds, 4, init_model=path,
                      valid_sets=[ds.create_valid(Xv, label=yv)],
                      evals_result=ev, verbose_eval=False,
                      keep_training_booster=True, **kw)
        hist = pkg.cv(dict(params), pkg.Dataset(X, label=y), 3, nfold=3,
                      stratified=False, init_model=path, **kw)
        out.append((b, ev["valid_0"]["binary_logloss"], hist))
    (jb, jev, jcv), (tb, tev, tcv) = out
    np.testing.assert_array_equal(tb._gbdt.valid_scores(1).numpy(),
                                  np.asarray(jb._gbdt._valid_scores[0]))
    np.testing.assert_allclose(tev, jev, rtol=REL)
    assert _body(tb.model_to_string()) == _body(jb.model_to_string())
    # the fold means within 1e-6 relative; their spreads, differences of
    # such means, within 1e-7
    assert list(tcv) == list(jcv)
    for key in jcv:
        np.testing.assert_allclose(tcv[key], jcv[key], rtol=REL,
                                   atol=1e-7 if key.endswith("stdv") else 0)


PARAMS_STR = ("objective=binary num_leaves=15 max_bin=63 "
              "min_data_in_leaf=10 verbose=-1")


def _capi_merge_reset(c, X, y, other_text, **kw):
    ds = c.LGBM_DatasetCreateFromMat(X, parameters=PARAMS_STR, **kw)
    c.LGBM_DatasetSetField(ds, "label", y)
    b = c.LGBM_BoosterCreate(ds, PARAMS_STR)
    for _ in range(4):
        c.LGBM_BoosterUpdateOneIter(b)
    ds2 = c.LGBM_DatasetCreateFromMat(X[::-1].copy(), parameters=PARAMS_STR,
                                      **kw)
    c.LGBM_DatasetSetField(ds2, "label", y[::-1].copy())
    c.LGBM_BoosterResetTrainingData(b, ds2)
    for _ in range(3):
        c.LGBM_BoosterUpdateOneIter(b)
    c.LGBM_BoosterMerge(b, c.LGBM_BoosterLoadModelFromString(other_text,
                                                             **kw))
    return (c.LGBM_BoosterSaveModelToString(b),
            np.asarray(c.LGBM_BoosterPredictForMat(b, X, predict_type=1)),
            c.LGBM_BoosterNumberOfTotalModel(b))


def test_capi_reset_training_data_and_merge():
    """``LGBM_BoosterResetTrainingData`` (the trees replayed into the new
    rows' scores, training going on) then ``LGBM_BoosterMerge``: the text
    and the raw scores equal to the JAX package's, the merged model's
    scores the sum of both models'."""
    X, lin, rng = _set(seed=17)
    y = _labels("binary", lin, rng)
    other = lgb.train(_params(), lgb.Dataset(X, label=y), 3,
                      verbose_eval=False).model_to_string()
    jt, jp, jn = _capi_merge_reset(jcapi, X, y, other)
    tt, tp, tn = _capi_merge_reset(tcapi, X, y, other, device="cpu")
    assert tn == jn == 10
    assert _body(tt) == _body(jt)
    np.testing.assert_array_equal(tp, jp)
    own = lgt.Booster(model_str=tt, device="cpu")
    first = lgt.Booster(model_str=tt, device="cpu").predict(
        X, raw_score=True, num_iteration=7)
    np.testing.assert_allclose(
        own.predict(X, raw_score=True),
        first + lgt.Booster(model_str=other, device="cpu").predict(
            X, raw_score=True), atol=1e-5)


def test_golden_contin_continued():
    """golden2's ``contin`` model (trained by the reference LightGBM)
    continued for 5 iterations on its rows through
    ``ResetTrainingData``: the mixed model's text equal to the JAX
    package's, the loaded trees' thresholds kept as read."""
    X = np.fromfile(os.path.join(GOLDEN, "g2_contin_X.bin"),
                    np.float64).reshape(600, 8)
    y = np.fromfile(os.path.join(GOLDEN, "g2_contin_y.bin"), np.float32)
    model = os.path.join(GOLDEN, "g2_contin_model.txt")
    texts = []
    for c, kw in ((jcapi, {}), (tcapi, {"device": "cpu"})):
        b = c.LGBM_BoosterCreateFromModelfile(model, **kw)
        ds = c.LGBM_DatasetCreateFromMat(X, parameters=PARAMS_STR, **kw)
        c.LGBM_DatasetSetField(ds, "label", y)
        c.LGBM_BoosterResetTrainingData(b, ds)
        assert c.LGBM_BoosterGetCurrentIteration(b) == 10
        for _ in range(5):
            c.LGBM_BoosterUpdateOneIter(b)
        texts.append(c.LGBM_BoosterSaveModelToString(b))
    assert _body(texts[1]) == _body(texts[0])

    def thresholds(text):
        return [[float(v) for v in ln.split("=")[1].split()]
                for ln in text.split("end of trees")[0].splitlines()
                if ln.startswith("threshold=")]
    with open(model) as fh:
        loaded = thresholds(fh.read())
    assert len(loaded) == 10 and thresholds(texts[1])[:10] == loaded


@pytest.mark.parametrize("params,cls", [
    ({"boosting_type": "random_forest", "bagging_freq": 1,
      "bagging_fraction": 0.5}, "RF"),
    ({"boost": "gbrt"}, "GBDT"), ({"boosting": "goss"}, "GOSS"),
    ({"boosting_type": "dart"}, "DART")])
def test_boosting_aliases(params, cls):
    """The boosting keys and names the JAX Config takes pick the same
    class in the Booster and in the C API."""
    X, lin, rng = _set(n=300)
    y = _labels("binary", lin, rng)
    b = lgt.Booster(_params(**params), lgt.Dataset(X, label=y),
                    device="cpu")
    assert type(b._gbdt).__name__ == cls
    ds = tcapi.LGBM_DatasetCreateFromMat(X, device="cpu")
    tcapi.LGBM_DatasetSetField(ds, "label", y)
    h = tcapi.LGBM_BoosterCreate(ds, _params(**params))
    assert type(h.gbdt).__name__ == cls
    jb = lgb.Booster(_params(**params), lgb.Dataset(X, label=y))
    assert type(jb._gbdt).__name__ == cls
