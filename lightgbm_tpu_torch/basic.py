"""Dataset and Booster (the JAX package's ``basic.py``, reference
python-package basic.py:626-2415): training on a Dataset, and scoring a
trained or loaded model."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config
from .io.dataset import BinnedDataset, Metadata
from .metrics import create_metrics, metric_names
from .models.gbdt import GBDT
from .objectives import create_objective
from .utils.log import LightGBMError


def _data_to_2d(data, feature_name="auto", categorical_feature="auto"):
    """(ndarray[N, F] float32 or float64, feature names or None, sorted
    categorical column indices) of an input matrix (the JAX package's
    basic.py:52). Pandas categorical/object columns become their
    category codes, with code -1 (missing) as NaN, like the reference's
    _data_from_pandas, and are the categorical columns under "auto"; a
    list names them by index or feature name."""
    try:
        import pandas as pd
    except ImportError:
        pd = None
    names = None
    cat_idx: List[int] = []
    if pd is not None and isinstance(data, pd.DataFrame):
        if feature_name == "auto":
            names = [str(c) for c in data.columns]
        X = np.empty((len(data), data.shape[1]), np.float64)
        for i, c in enumerate(data.columns):
            col = data[c]
            if isinstance(col.dtype, pd.CategoricalDtype):
                codes = col.cat.codes.to_numpy(np.float64)
            elif col.dtype == object:
                codes = pd.Categorical(col).codes.astype(np.float64)
            else:
                X[:, i] = col.to_numpy(np.float64)
                continue
            X[:, i] = np.where(codes < 0, np.nan, codes)
            if categorical_feature == "auto":
                cat_idx.append(i)
    elif hasattr(data, "tocsr"):
        raise LightGBMError("sparse input is not ported yet; pass a dense "
                            "array")
    else:
        X = np.asarray(data)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
    if isinstance(feature_name, (list, tuple)):
        names = [str(x) for x in feature_name]
    if isinstance(categorical_feature, (list, tuple)):
        cat_idx = []
        for c in categorical_feature:
            if isinstance(c, str):
                if names is None or c not in names:
                    raise LightGBMError(f"categorical_feature {c!r} not "
                                        "found in feature names")
                cat_idx.append(names.index(c))
            else:
                cat_idx.append(int(c))
    return X, names, sorted(set(cat_idx))



class Dataset:
    """Training data (basic.py:626-1448 surface), binned lazily: the
    rows are binned on the device of the Booster that first uses it."""

    def __init__(self, data, label=None, weight=None, feature_name="auto",
                 categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None):
        self.data = data
        self.label = label
        self.weight = weight
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._inner: Optional[BinnedDataset] = None

    def construct(self, device=None) -> "Dataset":
        """Bin the rows on ``device`` (None: cuda:0), once; the raw rows
        are dropped then."""
        if self._inner is not None:
            return self
        if self.data is None:
            raise LightGBMError("the Dataset's raw data was freed")
        cfg = Config()
        cfg.set(self.params)
        X, names, cat_idx = _data_to_2d(self.data, self.feature_name,
                                        self.categorical_feature)
        self._inner = BinnedDataset(cfg, device).construct_from_matrix(
            X, Metadata(label=self.label, weight=self.weight),
            feature_names=names, categorical=cat_idx)
        self.data = None
        return self


class Booster:
    """A model trained on ``train_set`` or loaded from LightGBM v2 model
    text. ``device`` is where it trains and predicts: None means
    ``cuda:0`` (raising when there is no card); ``"cpu"`` must be asked
    for."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self.params = dict(params) if params else {}
        self.train_set = train_set
        self.best_iteration = -1
        self._train_data_name = "training"
        if train_set is not None:
            self._init_from_train_set(train_set, device)
            return
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        elif model_str is None:
            raise TypeError("Need a training dataset or model file or model "
                            "string to create a Booster")
        self._gbdt = GBDT(device).load_model_from_string(
            model_str, source=model_file or "")

    def _init_from_train_set(self, train_set: Dataset, device) -> None:
        cfg = Config()
        cfg.set(self.params)
        train_set.params = {**self.params, **train_set.params}
        inner = train_set.construct(device)._inner
        objective = create_objective(cfg.objective, cfg)
        if objective is not None:
            objective.init(inner.metadata, inner.num_data)
        metrics = create_metrics(metric_names(cfg), cfg, inner.metadata,
                                 inner.num_data)
        self.config = cfg
        self._gbdt = GBDT(inner.device).init(cfg, inner, objective, metrics)

    def update(self) -> bool:
        """One boosting iteration; True when no further split was
        possible (basic.py:1693-1746)."""
        if self.train_set is None:
            raise LightGBMError("update needs a Booster with training data")
        return self._gbdt.train_one_iter()

    def current_iteration(self) -> int:
        return self._gbdt.iter_

    def eval_train(self) -> List[tuple]:
        """[(data name, metric name, value, bigger is better)] on the
        train set."""
        return [(self._train_data_name, name, val, bigger)
                for name, val, bigger in self._gbdt.get_eval_at(0)]

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                **kwargs) -> np.ndarray:
        """Predictions [N] or [N, K]; raw scores with ``raw_score``, leaf
        indices [N, T] with ``pred_leaf``. ``pred_early_stop*`` keywords
        go to the host walk as in the reference."""
        X = np.asarray(_data_to_2d(data)[0], np.float64)
        if num_iteration < 0 and self.best_iteration > 0:
            num_iteration = self.best_iteration
        pred_kw = {k: v for k, v in kwargs.items()
                   if k.startswith("pred_early_stop")}
        if pred_leaf:
            return self._gbdt.predict_leaf_index(X, num_iteration)
        if raw_score:
            return self._gbdt.predict_raw(X, num_iteration, **pred_kw)
        return self._gbdt.predict(X, num_iteration, **pred_kw)

    def num_trees(self) -> int:
        return len(self._gbdt.models)

    def save_model(self, filename: str, num_iteration: int = -1,
                   start_iteration: int = 0) -> "Booster":
        if num_iteration < 0 and self.best_iteration > 0:
            num_iteration = self.best_iteration
        self._gbdt.save_model_to_file(filename, start_iteration,
                                      num_iteration)
        return self

    def model_to_string(self, num_iteration: int = -1,
                        start_iteration: int = 0) -> str:
        if num_iteration < 0 and self.best_iteration > 0:
            num_iteration = self.best_iteration
        return self._gbdt.model_to_string(start_iteration, num_iteration)
