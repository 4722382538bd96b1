"""C-API-shaped scoring entry points (the JAX package's ``capi.py``, the
part the fork's LRB loop scores with; reference src/c_api.cpp,
include/LightGBM/c_api.h).

Handles are opaque objects, out-parameters become return values, and
the dtype and predict tags match c_api.h, so C callers transliterate line
by line. Model handles take a ``device`` (None: ``cuda:0``).
"""
from __future__ import annotations

import numpy as np

from .models.gbdt import GBDT
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


class _BoosterHandle:
    def __init__(self, gbdt: GBDT):
        self.gbdt = gbdt


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
