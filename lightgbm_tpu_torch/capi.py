"""C-API-shaped entry points (the JAX package's ``capi.py``, the calls
the fork's LRB loop makes; reference src/c_api.cpp,
include/LightGBM/c_api.h): a dataset from a matrix and its label, a
booster trained one iteration at a time, its train-set metrics, its
model text, and scoring.

Handles are opaque objects, out-parameters become return values, and
the dtype and predict tags match c_api.h, so C callers transliterate line
by line. Dataset and model handles take a ``device`` (None: ``cuda:0``);
a booster trains on its dataset's device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .config import Config
from .io.dataset import BinnedDataset, Metadata
from .metrics import create_metrics, metric_names
from .models.gbdt import GBDT
from .objectives import create_objective
from .utils.log import LightGBMError

# dtype tags (c_api.h:20-27)
C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_DTYPE_INT32 = 2
C_API_DTYPE_INT64 = 3

# predict tags (c_api.h:29-35)
C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2
C_API_PREDICT_CONTRIB = 3


def _mat_to_2d(data, nrow, ncol, is_row_major) -> np.ndarray:
    X = np.asarray(data, np.float64)
    if X.ndim == 1:
        # flat buffers honor is_row_major like the C API (c_api.cpp
        # RowFunctionFromDenseMatric); 2-D numpy inputs already carry
        # their own layout
        X = X.reshape(int(nrow), int(ncol)) if is_row_major \
            else X.reshape(int(ncol), int(nrow)).T
    return X


def _params_to_config(parameters) -> Config:
    cfg = Config()
    if isinstance(parameters, str):
        cfg.set(Config.str2map(parameters))
    elif isinstance(parameters, dict):
        cfg.set({k: str(v) for k, v in parameters.items()})
    elif parameters:
        raise LightGBMError("parameters must be a dict or 'k=v' string")
    return cfg


class _DatasetHandle:
    """Raw matrix and fields; binning waits for the first booster
    (c_api.cpp defers Dataset::Construct likewise)."""

    def __init__(self, X: np.ndarray, cfg: Config, device):
        self.X = X
        self.cfg = cfg
        self.device = device
        self.fields: Dict[str, np.ndarray] = {}
        self._inner = None

    def construct(self) -> BinnedDataset:
        if self._inner is None:
            meta = Metadata(label=self.fields.get("label"),
                            weight=self.fields.get("weight"))
            self._inner = BinnedDataset(self.cfg, self.device) \
                .construct_from_matrix(self.X, meta,
                                       categorical=_parse_cat_spec(self.cfg))
        return self._inner


def _parse_cat_spec(cfg: Config) -> List[int]:
    """The dataset parameters' ``categorical_feature`` ("0,2"): column
    indices."""
    spec = cfg.categorical_feature
    if not spec:
        return []
    return [int(x) for x in str(spec).split(",") if x.strip()]


def LGBM_DatasetCreateFromMat(data, data_type=C_API_DTYPE_FLOAT64,
                              nrow=None, ncol=None, is_row_major=1,
                              parameters="", device=None) -> _DatasetHandle:
    """c_api.cpp:345. f32 input stays f32 on its way to the device."""
    X = np.asarray(data)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    if X.ndim == 1:
        X = _mat_to_2d(X, nrow, ncol, is_row_major)
    return _DatasetHandle(X, _params_to_config(parameters), device)


def LGBM_DatasetSetField(handle: _DatasetHandle, field_name: str,
                         field_data, num_element=None,
                         dtype=C_API_DTYPE_FLOAT32):
    """c_api.cpp:436: label or weight."""
    if field_name not in ("label", "weight"):
        raise LightGBMError(f"field {field_name!r} is not ported")
    if handle._inner is not None:
        raise LightGBMError("set fields before the first booster uses the "
                            "dataset")
    handle.fields[field_name] = np.asarray(field_data)
    return 0


def LGBM_DatasetFree(handle: _DatasetHandle):
    handle._inner = None
    handle.X = None
    return 0


class _BoosterHandle:
    def __init__(self, gbdt: GBDT):
        self.gbdt = gbdt


def LGBM_BoosterCreate(train_data: _DatasetHandle,
                       parameters="") -> _BoosterHandle:
    """c_api.cpp:506: train-set metrics only with
    is_provide_training_metric, as the reference."""
    cfg = _params_to_config(parameters)
    inner = train_data.construct()
    objective = create_objective(cfg.objective, cfg)
    if objective is not None:
        objective.init(inner.metadata, inner.num_data)
    metrics = []
    if cfg.is_provide_training_metric:
        metrics = create_metrics(metric_names(cfg), cfg, inner.metadata,
                                 inner.num_data)
    return _BoosterHandle(GBDT(inner.device).init(cfg, inner, objective,
                                                  metrics))


def LGBM_BoosterUpdateOneIter(handle: _BoosterHandle) -> int:
    """c_api.cpp:605: returns is_finished (out-param -> return)."""
    return 1 if handle.gbdt.train_one_iter() else 0


def LGBM_BoosterGetEval(handle: _BoosterHandle, data_idx: int):
    """c_api.cpp:693: [(name, value)] for the train set (0)."""
    return [(name, val) for name, val, _ in
            handle.gbdt.get_eval_at(data_idx)]


def LGBM_BoosterCreateFromModelfile(filename: str,
                                    device=None) -> _BoosterHandle:
    """c_api.cpp:527."""
    with open(filename) as fh:
        g = GBDT(device).load_model_from_string(fh.read(), source=filename)
    return _BoosterHandle(g)


def LGBM_BoosterLoadModelFromString(model_str: str,
                                    device=None) -> _BoosterHandle:
    g = GBDT(device).load_model_from_string(model_str)
    return _BoosterHandle(g)


def LGBM_BoosterFree(handle: _BoosterHandle):
    handle.gbdt = None
    return 0


def LGBM_BoosterGetNumClasses(handle: _BoosterHandle) -> int:
    return handle.gbdt.num_class


def _predict(gbdt, X, predict_type, num_iteration):
    if predict_type == C_API_PREDICT_RAW_SCORE:
        return gbdt.predict_raw(X, num_iteration)
    if predict_type == C_API_PREDICT_LEAF_INDEX:
        return gbdt.predict_leaf_index(X, num_iteration)
    if predict_type == C_API_PREDICT_CONTRIB:
        raise LightGBMError("C_API_PREDICT_CONTRIB is not ported yet")
    return gbdt.predict(X, num_iteration)


def LGBM_BoosterPredictForMat(handle: _BoosterHandle, data,
                              data_type=C_API_DTYPE_FLOAT64, nrow=None,
                              ncol=None, is_row_major=1,
                              predict_type=C_API_PREDICT_NORMAL,
                              num_iteration=-1, parameter=""):
    """c_api.cpp:1014."""
    X = _mat_to_2d(data, nrow, ncol, is_row_major)
    return _predict(handle.gbdt, X, predict_type, num_iteration)


def LGBM_BoosterCalcNumPredict(handle: _BoosterHandle, num_row: int,
                               predict_type=C_API_PREDICT_NORMAL,
                               num_iteration=-1) -> int:
    """c_api.cpp:818."""
    g = handle.gbdt
    k = max(g.num_tree_per_iteration, 1)
    if predict_type == C_API_PREDICT_LEAF_INDEX:
        ntree = len(g.models)
        if num_iteration > 0:
            ntree = min(ntree, num_iteration * k)
        return num_row * ntree
    if predict_type == C_API_PREDICT_CONTRIB:
        return num_row * k * (g.max_feature_idx + 2)
    return num_row * k


def LGBM_BoosterSaveModelToString(handle: _BoosterHandle,
                                  num_iteration=-1,
                                  start_iteration=0) -> str:
    return handle.gbdt.model_to_string(start_iteration, num_iteration)
