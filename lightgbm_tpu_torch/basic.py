"""Booster: the scoring surface of a loaded model (the JAX package's
``basic.py``, reference python-package basic.py:1450-2415)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .models.gbdt import GBDT
from .utils.log import LightGBMError


def _data_to_2d(data) -> np.ndarray:
    """Normalize prediction input to ndarray[N, F] float64. Pandas
    categorical/object columns become their category codes, with code -1
    (missing) as NaN, like the reference's _data_from_pandas."""
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(data, pd.DataFrame):
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
        return X
    if hasattr(data, "tocsr"):
        raise LightGBMError("sparse prediction input is not ported yet; "
                            "pass a dense array")
    X = np.asarray(data, np.float64)
    if X.ndim == 1:
        X = X.reshape(-1, 1)
    return X


class Booster:
    """A model loaded from LightGBM v2 model text. ``device`` is where it
    predicts: None means ``cuda:0`` (predict raises when there is no
    card); ``"cpu"`` must be asked for."""

    def __init__(self, model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self.best_iteration = -1
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        elif model_str is None:
            raise TypeError("Need a model file or model string to create "
                            "a Booster")
        self._gbdt = GBDT(device).load_model_from_string(
            model_str, source=model_file or "")

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                **kwargs) -> np.ndarray:
        """Predictions [N] or [N, K]; raw scores with ``raw_score``, leaf
        indices [N, T] with ``pred_leaf``. ``pred_early_stop*`` keywords
        go to the host walk as in the reference."""
        X = _data_to_2d(data)
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
