"""C-API-shaped entry points (the JAX package's ``capi.py``, the calls
the fork's LRB loop makes; reference src/c_api.cpp,
include/LightGBM/c_api.h): a dataset from a matrix (or several), a text
or binary file, a sample of its columns filled by pushed rows, a subset
or a reference's mappers, with its fields (query groups among them),
feature names and binary file; a booster of any boosting type trained one
iteration at a time, on its objective's gradients or the caller's, with
valid sets, their metrics and scores, rollback, feature importance, its
model text and file and JSON dump, leaf values read and set, iterations
shuffled, refit on new data, merging two models, continuing on new
training data, and scoring a matrix or a file (SHAP contributions
among the predict types); the last error's text.

Handles are opaque objects, out-parameters become return values, and
the dtype and predict tags match c_api.h, so C callers transliterate line
by line. Dataset and model handles take a ``device`` (None: ``cuda:0``);
a booster trains on its dataset's device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .application import write_result
from .config import Config
from .io.dataset import BinnedDataset, Metadata, find_column_mappers
from .io.loader import DatasetLoader
from .metrics import create_metric, create_metrics, metric_names
from .models.boosting import create_boosting
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
    (c_api.cpp defers Dataset::Construct likewise). A handle with a
    ``reference`` is binned with the reference's mappers on its
    device."""

    def __init__(self, X: np.ndarray, cfg: Config, device, reference=None):
        self.X = X
        self.cfg = cfg
        self.device = device
        self.reference = reference
        self.fields: Dict[str, np.ndarray] = {}
        self.feature_names: List[str] = []
        # mappers found on a sample of the columns (CreateFromSampledColumn)
        self.premade_mappers = None
        self._inner = None

    def construct(self) -> BinnedDataset:
        if self._inner is None:
            meta = Metadata(label=self.fields.get("label"),
                            weight=self.fields.get("weight"),
                            init_score=self.fields.get("init_score"),
                            group=self.fields.get("group"))
            if self.reference is not None:
                self._inner = self.reference.construct().create_valid(
                    self.X, meta)
            else:
                self._inner = BinnedDataset(self.cfg, self.device) \
                    .construct_from_matrix(
                        self.X, meta, categorical=_parse_cat_spec(self.cfg),
                        mappers=self.premade_mappers)
            if self.feature_names:
                self._inner.feature_names = list(self.feature_names)
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
                              parameters="", reference=None,
                              device=None) -> _DatasetHandle:
    """c_api.cpp:345. f32 input stays f32 on its way to the device. With
    a ``reference`` (a training set's handle) the rows are binned with
    its mappers on its device."""
    X = np.asarray(data)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    if X.ndim == 1:
        X = _mat_to_2d(X, nrow, ncol, is_row_major)
    return _DatasetHandle(X, _params_to_config(parameters), device,
                          reference)


def LGBM_DatasetCreateFromMats(nmat, mats, data_type=C_API_DTYPE_FLOAT64,
                               nrows=None, ncol=None, is_row_major=1,
                               parameters="", reference=None,
                               device=None) -> _DatasetHandle:
    """c_api.cpp:330: several row blocks, stacked."""
    blocks = [_mat_to_2d(m, nr, ncol, is_row_major)
              for m, nr in zip(mats, nrows)]
    return _DatasetHandle(np.vstack(blocks), _params_to_config(parameters),
                          device, reference)


def LGBM_DatasetCreateFromFile(filename: str, parameters="",
                               reference=None, device=None
                               ) -> _DatasetHandle:
    """c_api.cpp:215: a text or binary file through the loader
    (io/loader.py), binned at once on ``device`` (a valid set on its
    reference's mappers and device). Its fields come from the file and
    its sidecar files."""
    cfg = _params_to_config(parameters)
    ref = reference.construct() if reference is not None else None
    h = _DatasetHandle(None, cfg, ref.device if ref is not None else device,
                       reference)
    h._inner = DatasetLoader(cfg, h.device).load_from_file(filename,
                                                           reference=ref)
    return h


def LGBM_DatasetCreateFromSampledColumn(sample_data, sample_indices, ncol,
                                        num_per_col, num_sample_row,
                                        num_total_row, parameters="",
                                        device=None) -> _DatasetHandle:
    """c_api.cpp:150: a dataset of ``num_total_row`` rows whose mappers
    come from per-column samples (the values of column j at rows
    ``sample_indices[j]``, zeros elsewhere: the implied background of
    ConstructFromSampleData); its rows arrive by LGBM_DatasetPushRows."""
    cfg = _params_to_config(parameters)
    ncol = int(ncol)
    h = _DatasetHandle(np.zeros((int(num_total_row), ncol), np.float64),
                       cfg, device)
    sm = np.zeros((int(num_sample_row), ncol), np.float64)
    for j in range(ncol):
        vals = np.asarray(sample_data[j][:num_per_col[j]], np.float64)
        idx = np.asarray(sample_indices[j][:num_per_col[j]], np.int64)
        sm[idx, j] = vals
    h.premade_mappers = find_column_mappers(
        sm, cfg, _parse_cat_spec(cfg), total_rows=int(num_total_row),
        presampled=True)
    return h


def LGBM_DatasetCreateByReference(reference: _DatasetHandle,
                                  num_total_row) -> _DatasetHandle:
    """c_api.cpp:215: an empty dataset of ``num_total_row`` rows, binned
    with ``reference``'s mappers on its device once its rows are pushed."""
    ncol = LGBM_DatasetGetNumFeature(reference)
    return _DatasetHandle(np.zeros((int(num_total_row), ncol), np.float64),
                          reference.cfg, reference.device, reference)


def LGBM_DatasetPushRows(handle: _DatasetHandle, data,
                         data_type=C_API_DTYPE_FLOAT64, nrow=None,
                         ncol=None, start_row=0):
    """c_api.cpp:230: a row block into a dataset made by
    CreateFromSampledColumn or CreateByReference, before it is binned."""
    if handle._inner is not None:
        raise LightGBMError("push rows before the first booster uses the "
                            "dataset")
    X = _mat_to_2d(data, nrow, ncol, 1)
    handle.X[int(start_row):int(start_row) + X.shape[0]] = X
    return 0


def LGBM_DatasetGetSubset(handle: _DatasetHandle, used_row_indices,
                          parameters="") -> _DatasetHandle:
    """c_api.cpp:430 (Dataset::CopySubset): the rows ``used_row_indices``
    of a matrix dataset and their fields, binned anew (with the handle's
    reference's mappers where it has one). Ranking data must keep whole
    queries."""
    if handle.X is None:
        raise LightGBMError("DatasetGetSubset needs a dataset made from a "
                            "matrix")
    idx = np.asarray(used_row_indices, np.int64)
    sub = _DatasetHandle(handle.X[idx],
                         _params_to_config(parameters) if parameters
                         else handle.cfg, handle.device, handle.reference)
    n_rows = handle.X.shape[0]
    for k, v in handle.fields.items():
        if v is None or k == "group":
            continue
        v = np.asarray(v)
        if k == "init_score" and v.size != n_rows:
            # multiclass init scores are flattened class-major [K * N]
            sub.fields[k] = v.reshape(-1, n_rows)[:, idx].reshape(-1)
        else:
            sub.fields[k] = v[idx]
    grp = handle.fields.get("group")
    if grp is not None:
        qb = np.concatenate([[0], np.cumsum(np.asarray(grp, np.int64))])
        qid = np.searchsorted(qb, idx, side="right") - 1
        take, counts = np.unique(qid, return_counts=True)
        full = qb[take + 1] - qb[take]
        if not np.array_equal(counts, full):
            raise LightGBMError("DatasetGetSubset on ranking data must "
                                "select whole queries")
        sub.fields["group"] = full
    return sub


def LGBM_DatasetSetFeatureNames(handle: _DatasetHandle, names):
    handle.feature_names = [str(x) for x in names]
    if handle._inner is not None:
        handle._inner.feature_names = list(handle.feature_names)
    return 0


def LGBM_DatasetGetFeatureNames(handle: _DatasetHandle) -> List[str]:
    if handle._inner is not None:
        return list(handle._inner.feature_names)
    return list(handle.feature_names) or [
        f"Column_{i}" for i in range(handle.X.shape[1])]


def LGBM_DatasetSaveBinary(handle: _DatasetHandle, filename: str):
    """c_api.cpp:476: the binned set (binned now if it is not yet) as a
    binary file, which loads in either package."""
    handle.construct().save_binary(filename)
    return 0


_FIELDS = ("label", "weight", "init_score", "group")


def LGBM_DatasetSetField(handle: _DatasetHandle, field_name: str,
                         field_data, num_element=None,
                         dtype=C_API_DTYPE_FLOAT32):
    """c_api.cpp:436: label, weight, init_score (class-major) or group
    (each query's row count, int32)."""
    if field_name not in _FIELDS:
        raise LightGBMError(f"field {field_name!r} is not ported")
    if handle._inner is not None:
        raise LightGBMError("set fields before the first booster uses the "
                            "dataset")
    handle.fields[field_name] = np.asarray(field_data)
    return 0


def LGBM_DatasetGetField(handle: _DatasetHandle, field_name: str):
    """c_api.cpp:459: the field's array (out-parameters -> return)."""
    if field_name not in _FIELDS:
        raise LightGBMError(f"field {field_name!r} is not ported")
    if handle._inner is not None:
        md = handle._inner.metadata
        if field_name == "group":
            qb = md.query_boundaries
            return None if qb is None else np.diff(qb).astype(np.int32)
        return {"label": md.label, "weight": md.weights,
                "init_score": md.init_score}[field_name]
    return handle.fields.get(field_name)


def LGBM_DatasetGetNumData(handle: _DatasetHandle) -> int:
    return (handle._inner.num_data if handle._inner is not None
            else handle.X.shape[0])


def LGBM_DatasetGetNumFeature(handle: _DatasetHandle) -> int:
    return (handle._inner.num_total_features
            if handle._inner is not None else handle.X.shape[1])


def LGBM_DatasetFree(handle: _DatasetHandle):
    handle._inner = None
    handle.X = None
    return 0


class _BoosterHandle:
    def __init__(self, gbdt: GBDT, cfg: Config = None, train=None):
        self.gbdt = gbdt
        self.cfg = cfg if cfg is not None else Config()
        self.train = train


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
    gbdt = create_boosting(cfg.boosting_type(), inner.device)
    return _BoosterHandle(gbdt.init(cfg, inner, objective, metrics), cfg,
                          train_data)


def LGBM_BoosterAddValidData(handle: _BoosterHandle,
                             valid_data: _DatasetHandle):
    """c_api.cpp:560: the set is binned with the booster's training
    set's mappers, on its device, and evaluated with the configured
    metrics."""
    if handle.train is None:
        raise LightGBMError("AddValidData needs a booster with training "
                            "data")
    valid_data.reference = handle.train
    inner = valid_data.construct()
    metrics = create_metrics(metric_names(handle.cfg), handle.cfg,
                             inner.metadata, inner.num_data)
    handle.gbdt.add_valid_data(inner, metrics, "valid")
    return 0


def LGBM_BoosterUpdateOneIter(handle: _BoosterHandle) -> int:
    """c_api.cpp:605: returns is_finished (out-param -> return)."""
    return 1 if handle.gbdt.train_one_iter() else 0


def LGBM_BoosterUpdateOneIterCustom(handle: _BoosterHandle, grad,
                                    hess) -> int:
    """c_api.cpp:621: one iteration on the caller's gradients and
    hessians (float32, K * N class-major); returns is_finished."""
    g = handle.gbdt
    grad = np.asarray(grad, np.float32).reshape(-1)
    hess = np.asarray(hess, np.float32).reshape(-1)
    size = g.num_tree_per_iteration * g._n
    if grad.size != size or hess.size != size:
        raise LightGBMError(f"gradients of {grad.size} and hessians of "
                            f"{hess.size} values; the booster needs "
                            f"num_data * num_class = {size}")
    return 1 if g.train_one_iter(grad, hess) else 0


def LGBM_BoosterMerge(handle: _BoosterHandle, other: _BoosterHandle):
    """c_api.cpp:570: ``other``'s trees appended to the booster's."""
    g, o = handle.gbdt, other.gbdt
    o._ensure_host_trees()
    g._ensure_host_trees()
    g.records.extend(o.records)
    g.models.extend(o.models)
    g._tree_shrinkage.extend(o._tree_shrinkage)
    g._invalidate_stacked()
    return 0


def LGBM_BoosterResetTrainingData(handle: _BoosterHandle,
                                  train_data: _DatasetHandle):
    """c_api.cpp:580, GBDT::ResetTrainingData: the booster goes on
    training on ``train_data`` (binned on its device), its trees mapped
    to the new mappers' bins and replayed into the new scores
    (``GBDT.init_from_loaded``)."""
    g = handle.gbdt
    inner = train_data.construct()
    objective = g.objective
    if objective is not None:
        objective.init(inner.metadata, inner.num_data)
    cfg = handle.cfg
    metrics = []
    if cfg.is_provide_training_metric:
        metrics = create_metrics(metric_names(cfg), cfg, inner.metadata,
                                 inner.num_data)
    if g.models:
        g.init_from_loaded(cfg, inner, objective, metrics)
    else:
        g.init(cfg, inner, objective, metrics)
    handle.train = train_data
    return 0


def LGBM_BoosterRollbackOneIter(handle: _BoosterHandle):
    """c_api.cpp:638."""
    handle.gbdt.rollback_one_iter()
    return 0


def LGBM_BoosterGetCurrentIteration(handle: _BoosterHandle) -> int:
    return handle.gbdt.current_iteration


def LGBM_BoosterGetEval(handle: _BoosterHandle, data_idx: int):
    """c_api.cpp:693: [(name, value)] for the train set (0) or a valid
    set (1, 2, ...)."""
    return [(name, val) for name, val, _ in
            handle.gbdt.get_eval_at(data_idx)]


def LGBM_BoosterGetEvalCounts(handle: _BoosterHandle) -> int:
    """c_api.cpp:680: the number of configured metrics (no evaluation,
    no readback)."""
    return len(LGBM_BoosterGetEvalNames(handle))


def LGBM_BoosterGetEvalNames(handle: _BoosterHandle) -> List[str]:
    """c_api.cpp:688: the configured metrics' names, in order, each
    once, whether or not the train set is evaluated (the reference's
    Booster keeps its train metrics either way; the JAX package lists
    the train set's, none without is_provide_training_metric)."""
    out, seen = [], set()
    for name in metric_names(handle.cfg):
        m = create_metric(name, handle.cfg)
        if m is not None and m.name not in seen:
            seen.add(m.name)
            out.extend(m.names())
    return out


def LGBM_BoosterGetNumPredict(handle: _BoosterHandle, data_idx: int) -> int:
    """c_api.cpp:830: the size of the scores of the train set (0) or a
    valid set."""
    g = handle.gbdt
    scores = g.train_scores() if data_idx == 0 else g.valid_scores(data_idx)
    return int(scores.numel())


def LGBM_BoosterGetPredict(handle: _BoosterHandle,
                           data_idx: int) -> np.ndarray:
    """c_api.cpp:840: the converted scores of the train set (0) or a
    valid set, float64, flattened class-major [K * N]; converted on the
    device before the one copy to the host."""
    g = handle.gbdt
    scores = g.train_scores() if data_idx == 0 else g.valid_scores(data_idx)
    if g.objective is not None:
        scores = g.objective.convert_output(scores)
    return scores.cpu().numpy().astype(np.float64).reshape(-1)


def LGBM_BoosterFeatureImportance(handle: _BoosterHandle, num_iteration=0,
                                  importance_type=0) -> np.ndarray:
    """c_api.cpp:1150: per feature, split counts (type 0) or total gains
    (type 1) of the first ``num_iteration`` iterations (0: all)."""
    kind = "split" if importance_type == 0 else "gain"
    return handle.gbdt.feature_importance(kind, num_iteration)


def LGBM_BoosterGetNumFeature(handle: _BoosterHandle) -> int:
    return handle.gbdt.max_feature_idx + 1


def LGBM_BoosterGetFeatureNames(handle: _BoosterHandle) -> List[str]:
    return list(handle.gbdt.feature_names)


def LGBM_BoosterNumModelPerIteration(handle: _BoosterHandle) -> int:
    return handle.gbdt.num_model_per_iteration()


def LGBM_BoosterNumberOfTotalModel(handle: _BoosterHandle) -> int:
    return len(handle.gbdt.models)


def LGBM_BoosterResetParameter(handle: _BoosterHandle, parameters):
    """c_api.cpp:590: training parameters, the learning rate among
    them; the grower is set up again."""
    cfg = handle.cfg
    if isinstance(parameters, str):
        cfg.set(Config.str2map(parameters))
    else:
        cfg.set({k: str(v) for k, v in parameters.items()})
    if handle.gbdt.config is cfg:
        handle.gbdt.reset_config()
    return 0


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
        return gbdt.predict_contrib(X, num_iteration)
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


def LGBM_BoosterPredictForFile(handle: _BoosterHandle, data_filename: str,
                               data_has_header=0,
                               predict_type=C_API_PREDICT_NORMAL,
                               num_iteration=-1, parameter="",
                               result_filename="LightGBM_predict_result.txt"):
    """c_api.cpp:836: a text file's rows scored, the result file written
    as the predict task writes it (``f"{v:g}"``, tab-separated rows)."""
    cfg = _params_to_config(parameter)
    cfg.header = bool(data_has_header)
    X, _ = DatasetLoader(cfg).load_predict_matrix(
        data_filename, handle.gbdt.max_feature_idx + 1)
    write_result(result_filename,
                 _predict(handle.gbdt, X, predict_type, num_iteration))
    return 0


def LGBM_BoosterSaveModel(handle: _BoosterHandle, num_iteration=-1,
                          filename="LightGBM_model.txt", start_iteration=0):
    """c_api.cpp:870."""
    handle.gbdt.save_model_to_file(filename, start_iteration, num_iteration)
    return 0


def LGBM_BoosterDumpModel(handle: _BoosterHandle, num_iteration=-1,
                          start_iteration=0) -> dict:
    """c_api.cpp:890: the model as JSON (a dict; out-param -> return)."""
    return handle.gbdt.dump_model(start_iteration, num_iteration)


def LGBM_BoosterGetLeafValue(handle: _BoosterHandle, tree_idx: int,
                             leaf_idx: int) -> float:
    g = handle.gbdt
    g._ensure_host_trees()
    return float(g.models[int(tree_idx)].leaf_value[int(leaf_idx)])


def LGBM_BoosterSetLeafValue(handle: _BoosterHandle, tree_idx: int,
                             leaf_idx: int, val: float):
    """c_api.cpp:900, Tree::SetLeafOutput: the host tree and its record
    change, and the forest kernel's tables are built again."""
    handle.gbdt.set_leaf_value(tree_idx, leaf_idx, val)
    return 0


def LGBM_BoosterShuffleModels(handle: _BoosterHandle, start_iter: int = 0,
                              end_iter: int = -1):
    """c_api.cpp:590: a random permutation of the iterations in
    [start_iter, end_iter), whole iteration groups; the forest kernel's
    tables are built again."""
    handle.gbdt.shuffle_models(start_iter, end_iter)
    return 0


def LGBM_BoosterRefit(handle: _BoosterHandle, leaf_preds=None):
    """c_api.cpp:600, GBDT::RefitTree on the booster's training data
    (LGBM_BoosterResetTrainingData gives a loaded model some): the leaf
    of each row comes from each tree's replay on the card, so the
    ``leaf_preds`` matrix of the C signature is accepted and ignored."""
    handle.gbdt.refit_existing()
    return 0


# the last error's text (c_api.h LGBM_GetLastError, c_api.cpp:40-45)
_last_error: List[str] = ["Everything is fine"]


def LGBM_SetLastError(msg: str):
    _last_error[0] = str(msg)
    return 0


def LGBM_GetLastError() -> str:
    return _last_error[0]
