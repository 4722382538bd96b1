"""Port parity for the scikit-learn estimators: ``LGBMRegressor``,
``LGBMClassifier`` (binary with string labels, multiclass, DART),
``LGBMRanker`` and the sklearn-style custom objective and metric
adapters of lightgbm_tpu_torch (``device="cpu"``) against the JAX
package's estimators on the CPU, on the same numpy inputs made from a
seed. Bars: the fitted model's text before its parameters block
byte-equal, predictions (labels, probabilities, raw scores) equal, SHAP
contributions within 1e-12; the custom metric's values within 1e-6
relative. The estimators need
scikit-learn, which the package imports only where it is installed.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port

KW = dict(n_estimators=8, num_leaves=15, min_child_samples=10, verbose=-1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _set(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 8))
    return X, X[:, 0] + 0.5 * X[:, 1] - X[:, 2] * X[:, 3]


def _body(est) -> str:
    return est.booster_.model_to_string().split("parameters:")[0]


def _fit_both(name, y, extra=None, **fit):
    X, _ = _set()
    j = getattr(lgb, name)(**KW, **(extra or {})).fit(X, y, verbose=False,
                                                      **fit)
    t = getattr(lgt, name)(**KW, **(extra or {}), device="cpu").fit(
        X, y, verbose=False, **fit)
    return X, j, t


def test_regressor_matches_jax():
    _, lin = _set()
    X, j, t = _fit_both("LGBMRegressor", lin)
    assert _body(t) == _body(j)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    assert t.n_features_ == 8 and t.objective_ == "regression"
    np.testing.assert_array_equal(t.feature_importances_,
                                  j.feature_importances_)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "dart"])
def test_classifier_matches_jax(kind):
    """String labels (binary), four classes, and ``boosting_type="dart"``:
    the classes, the labels predicted, the probabilities and the text as
    the JAX estimator's."""
    _, lin = _set()
    y = {"binary": np.where(lin > 0, "yes", "no"),
         "multiclass": np.digitize(lin, [-1.0, 0.0, 1.0]),
         "dart": (lin > 0).astype(int)}[kind]
    extra = {"boosting_type": "dart"} if kind == "dart" else None
    X, j, t = _fit_both("LGBMClassifier", y, extra)
    assert _body(t) == _body(j)
    assert list(t.classes_) == list(j.classes_)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                               atol=1e-6)


def test_ranker_matches_jax():
    _, lin = _set()
    y = np.clip(np.round(lin + 2.0), 0, 4)
    X, j, t = _fit_both("LGBMRanker", y, group=[100] * 12)
    assert _body(t) == _body(j)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    with pytest.raises(ValueError, match="group"):
        lgt.LGBMRanker(**KW, device="cpu").fit(X, y)


def _l2_objective(y_true, y_pred):
    return y_pred - y_true, np.ones_like(y_pred)


def _mae_metric(y_true, y_pred):
    return "mae", float(np.mean(np.abs(y_true - y_pred))), False


def test_custom_objective_and_metric_adapters():
    """sklearn's argument order (y_true, y_pred) for a custom objective
    and a custom metric: the model equals the JAX estimator's, and the
    metric recorded on an eval set each round agrees."""
    X, lin = _set()
    Xv, linv = _set(n=300, seed=1)
    res = []
    for pkg, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        est = pkg.LGBMRegressor(objective=_l2_objective, **KW, **kw)
        est.fit(X, lin, eval_set=[(Xv, linv)], eval_metric=_mae_metric,
                verbose=False)
        res.append(est)
    j, t = res
    assert _body(t) == _body(j)
    np.testing.assert_allclose(t.evals_result_["valid_0"]["mae"],
                               j.evals_result_["valid_0"]["mae"], rtol=1e-6)


def test_pred_contrib_is_refused():
    """Refused until SHAP contributions were ported; now served: the
    estimator's ``pred_contrib`` within 1e-12 of the JAX estimator's,
    each row summing to its raw score."""
    X, lin = _set(n=300)
    got = []
    for pkg, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        est = pkg.LGBMRegressor(**KW, **kw).fit(X, lin, verbose=False)
        got.append((est.predict(X, pred_contrib=True),
                    est.predict(X, raw_score=True)))
    (jc, _), (tc, raw) = got
    assert tc.shape == (300, X.shape[1] + 1)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tc.sum(1), raw, rtol=0, atol=1e-5)


def test_package_imports_without_scikit_learn():
    """Where scikit-learn is missing (the card's machine), the package
    imports and leaves the estimators out."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['sklearn'] = None; "
            "import lightgbm_tpu_torch as p; "
            "assert not hasattr(p, 'LGBMRegressor'); "
            "assert 'LGBMModel' not in p.__all__; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
