"""scikit-learn estimators (the JAX package's ``sklearn.py``; reference
python-package/lightgbm/sklearn.py:128 LGBMModel, :588 LGBMRegressor,
:620 LGBMClassifier, :756 LGBMRanker). Custom objectives take the
(y_true, y_pred) -> (grad, hess) convention through
``_ObjectiveFunctionWrapper``, custom metrics the (y_true, y_pred) ->
(name, value, is_higher_better) convention. An estimator trains and
predicts on ``device`` (None: cuda:0; ``"cpu"`` the plain PyTorch path).
This module imports scikit-learn; the package imports it only where
scikit-learn is installed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
from sklearn.preprocessing import LabelEncoder

from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

__all__ = ["LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]


class _ObjectiveFunctionWrapper:
    """Adapt sklearn-style fobj(y_true, y_pred[, group]) to the engine's
    fobj(preds, dataset) (sklearn.py:33-94)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset: Dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_group())
        else:
            raise TypeError(
                "Self-defined objective should have 2 or 3 arguments, "
                f"got {argc}")
        return grad, hess


class _EvalFunctionWrapper:
    """Adapt sklearn-style feval (sklearn.py:96-126)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset: Dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError(
            "Self-defined eval function should have 2, 3 or 4 arguments, "
            f"got {argc}")


class LGBMModel(BaseEstimator):
    """Base sklearn estimator (sklearn.py:128-586)."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100,
                 subsample_for_bin=200000, objective=None, class_weight=None,
                 min_split_gain=0.0, min_child_weight=1e-3,
                 min_child_samples=20, subsample=1.0, subsample_freq=0,
                 colsample_bytree=1.0, reg_alpha=0.0, reg_lambda=0.0,
                 random_state=None, n_jobs=-1, silent=True,
                 importance_type="split", device=None, **kwargs):
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self.class_weight = class_weight
        self.device = device
        self._Booster: Optional[Booster] = None
        self._evals_result = None
        self._best_score = None
        self._best_iteration = None
        self._other_params: Dict[str, Any] = {}
        self._objective = objective
        self._n_features = None
        self._classes = None
        self._n_classes = None
        self.set_params(**kwargs)

    def get_params(self, deep=True):
        params = super().get_params(deep=deep)
        params.update(self._other_params)
        return params

    def set_params(self, **params):
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, f"_{key}"):
                setattr(self, f"_{key}", value)
            self._other_params[key] = value
        return self

    def _process_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("class_weight", None)
        params.pop("n_estimators", None)
        params.pop("device", None)
        params["objective"] = self._objective
        if callable(self._objective):
            params["objective"] = "None"
        elif self._objective is None:
            params["objective"] = "regression"
        alias = {
            "boosting_type": "boosting", "min_split_gain":
            "min_gain_to_split", "min_child_weight":
            "min_sum_hessian_in_leaf", "min_child_samples":
            "min_data_in_leaf", "subsample": "bagging_fraction",
            "subsample_freq": "bagging_freq", "colsample_bytree":
            "feature_fraction", "reg_alpha": "lambda_l1",
            "reg_lambda": "lambda_l2", "random_state": "seed",
            "subsample_for_bin": "bin_construct_sample_cnt",
            "n_jobs": "num_threads",
        }
        for k, v in alias.items():
            if k in params:
                val = params.pop(k)
                if val is not None:
                    params[v] = val
        if params.get("seed") is None:
            params.pop("seed", None)
        params.pop("num_threads", None)
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=True,
            feature_name="auto", categorical_feature="auto",
            callbacks=None):
        """Fit the model (sklearn.py:334-502)."""
        params = self._process_params()
        fobj = None
        if callable(self._objective):
            fobj = _ObjectiveFunctionWrapper(self._objective)
            params["objective"] = "None"
        feval = None
        if callable(eval_metric):
            feval = _EvalFunctionWrapper(eval_metric)
            eval_metric = None
        if isinstance(eval_metric, str):
            eval_metric = [eval_metric]
        if eval_metric:
            params["metric"] = eval_metric

        y_orig = y
        y = np.asarray(_ravel(y))
        if self.class_weight is not None and sample_weight is None:
            sample_weight = _class_weight_to_sample_weight(
                self.class_weight, y)
        train_set = Dataset(X, label=y, weight=sample_weight,
                            group=group, init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params, free_raw_data=False)
        valid_sets: List[Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and (vy is y or vy is y_orig):
                    valid_sets.append(train_set)
                else:
                    vw = _get_i(eval_sample_weight, i)
                    vg = _get_i(eval_group, i)
                    vi = _get_i(eval_init_score, i)
                    valid_sets.append(Dataset(
                        vx, label=_ravel(vy), weight=vw, group=vg,
                        init_score=vi, reference=train_set,
                        free_raw_data=False))
                valid_names.append(
                    eval_names[i] if eval_names and len(eval_names) > i
                    else f"valid_{i}")

        evals_result: Dict = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names or None,
            fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            callbacks=callbacks, device=self.device)
        self._n_features = (X.shape[1] if hasattr(X, "shape")
                            else len(X[0]))
        self._evals_result = evals_result or None
        self._best_iteration = (self._Booster.best_iteration
                                if self._Booster.best_iteration > 0
                                else None)
        self._best_score = self._Booster.best_score
        return self

    def predict(self, X, raw_score=False, num_iteration=-1,
                pred_leaf=False, pred_contrib=False, **kwargs):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit first")
        nf = X.shape[1] if hasattr(X, "shape") else len(X[0])
        if self._n_features is not None and nf != self._n_features:
            raise ValueError(
                "Number of features of the model must match the input. "
                f"Model n_features_ is {self._n_features} and input "
                f"n_features is {nf}")
        return self._Booster.predict(
            X, raw_score=raw_score, num_iteration=num_iteration,
            pred_leaf=pred_leaf, pred_contrib=pred_contrib, **kwargs)

    @property
    def n_features_(self) -> int:
        if self._n_features is None:
            raise LightGBMError("No n_features found. Need to call fit "
                                "beforehand.")
        return self._n_features

    @property
    def best_score_(self):
        return self._best_score

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def objective_(self):
        return self._objective if self._objective is not None \
            else "regression"

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit "
                                "beforehand.")
        return self._Booster

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        if self._Booster is None:
            raise LightGBMError("No feature_importances found. Need to "
                                "call fit beforehand.")
        return self._Booster.feature_importance(
            importance_type=self.importance_type)


class LGBMRegressor(LGBMModel, RegressorMixin):
    """LightGBM regressor (sklearn.py:588-618)."""

    def fit(self, X, y, sample_weight=None, init_score=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_metric=None,
            early_stopping_rounds=None, verbose=True,
            feature_name="auto", categorical_feature="auto",
            callbacks=None):
        if self._objective is None:
            self._objective = "regression"
        super().fit(X, y, sample_weight=sample_weight,
                    init_score=init_score, eval_set=eval_set,
                    eval_names=eval_names,
                    eval_sample_weight=eval_sample_weight,
                    eval_init_score=eval_init_score,
                    eval_metric=eval_metric,
                    early_stopping_rounds=early_stopping_rounds,
                    verbose=verbose, feature_name=feature_name,
                    categorical_feature=categorical_feature,
                    callbacks=callbacks)
        return self


class LGBMClassifier(LGBMModel, ClassifierMixin):
    """LightGBM classifier (sklearn.py:620-754)."""

    def fit(self, X, y, sample_weight=None, init_score=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None,
            eval_metric=None, early_stopping_rounds=None, verbose=True,
            feature_name="auto", categorical_feature="auto",
            callbacks=None):
        self._le = LabelEncoder().fit(_ravel(y))
        encoded = self._le.transform(_ravel(y))
        self._classes = self._le.classes_
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            if self._objective is None or self._objective in (
                    "binary",):
                self._objective = "multiclass"
            self._other_params["num_class"] = self._n_classes
        else:
            if self._objective is None:
                self._objective = "binary"
        eval_set_enc = None
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            eval_set_enc = [(vx, self._le.transform(_ravel(vy)))
                            for vx, vy in eval_set]
        super().fit(X, encoded, sample_weight=sample_weight,
                    init_score=init_score, eval_set=eval_set_enc,
                    eval_names=eval_names,
                    eval_sample_weight=eval_sample_weight,
                    eval_init_score=eval_init_score,
                    eval_metric=eval_metric,
                    early_stopping_rounds=early_stopping_rounds,
                    verbose=verbose, feature_name=feature_name,
                    categorical_feature=categorical_feature,
                    callbacks=callbacks)
        return self

    def predict(self, X, raw_score=False, num_iteration=-1,
                pred_leaf=False, pred_contrib=False, **kwargs):
        result = self.predict_proba(X, raw_score, num_iteration,
                                    pred_leaf, pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:           # binary probabilities
            idx = (result >= 0.5).astype(np.int64)
        else:
            idx = np.argmax(result, axis=1)
        return self._le.inverse_transform(idx)

    def predict_proba(self, X, raw_score=False, num_iteration=-1,
                      pred_leaf=False, pred_contrib=False, **kwargs):
        result = super().predict(X, raw_score, num_iteration, pred_leaf,
                                 pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            return np.vstack((1. - result, result)).transpose()
        return result

    @property
    def classes_(self):
        if self._classes is None:
            raise LightGBMError("No classes found. Need to call fit "
                                "beforehand.")
        return self._classes

    @property
    def n_classes_(self) -> int:
        if self._n_classes is None:
            raise LightGBMError("No classes found. Need to call fit "
                                "beforehand.")
        return self._n_classes


class LGBMRanker(LGBMModel):
    """LightGBM ranker (sklearn.py:756-821)."""

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            eval_at=(1, 2, 3, 4, 5), early_stopping_rounds=None,
            verbose=True, feature_name="auto",
            categorical_feature="auto", callbacks=None):
        if self._objective is None:
            self._objective = "lambdarank"
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set "
                             "is not None")
        self._other_params["eval_at"] = list(eval_at)
        super().fit(X, y, sample_weight=sample_weight,
                    init_score=init_score, group=group,
                    eval_set=eval_set, eval_names=eval_names,
                    eval_sample_weight=eval_sample_weight,
                    eval_init_score=eval_init_score,
                    eval_group=eval_group, eval_metric=eval_metric,
                    early_stopping_rounds=early_stopping_rounds,
                    verbose=verbose, feature_name=feature_name,
                    categorical_feature=categorical_feature,
                    callbacks=callbacks)
        return self


def _ravel(y):
    if hasattr(y, "to_numpy"):
        y = y.to_numpy()
    return np.asarray(y).ravel()


def _get_i(seq, i):
    if seq is None:
        return None
    return seq[i] if len(seq) > i else None


def _class_weight_to_sample_weight(class_weight, y: np.ndarray):
    if class_weight == "balanced":
        classes, counts = np.unique(y, return_counts=True)
        weight_map = {c: len(y) / (len(classes) * cnt)
                      for c, cnt in zip(classes, counts)}
    elif isinstance(class_weight, dict):
        weight_map = class_weight
    else:
        raise ValueError(f"Unsupported class_weight {class_weight!r}")
    return np.asarray([weight_map.get(v, 1.0) for v in y], np.float32)
