"""Dataset and Booster (the JAX package's ``basic.py``, reference
python-package basic.py:626-2415): training on a Dataset (a matrix, or a
text or binary file through io/loader.py; with query groups for ranking)
with valid sets and their evaluation, on the objective's gradients or a
custom objective's (``Booster.update(fobj=)``), with every boosting type
(gbdt, goss, dart, rf), rollback, continued training (an init model's raw
scores folded into the Dataset's init scores, ``_InnerPredictor``),
``Dataset.save_binary``, refit on new data (``Booster.refit``), scoring a
trained or loaded model (SHAP contributions with ``pred_contrib``), its
JSON dump, and pickling (a pickled Booster unpickles onto the card).
scipy.sparse matrices are taken as CSR (io/sparse.py) by ``Dataset``,
``Booster.predict`` and ``Booster.refit``."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .config import Config
from .io.dataset import BinnedDataset, Metadata
from .io.loader import DatasetLoader
from .io.sparse import SparseMatrix
from .metrics import create_metrics, metric_names
from .models.boosting import create_boosting
from .models.gbdt import GBDT
from .objectives import create_objective
from .utils.log import LightGBMError


def _is_scipy_sparse(data) -> bool:
    try:
        import scipy.sparse as ssp
    except ImportError:
        return False
    return ssp.issparse(data)


def _data_to_2d(data, feature_name="auto", categorical_feature="auto"):
    """(ndarray[N, F] float32 or float64, or a ``SparseMatrix`` of a
    scipy.sparse input, feature names or None, sorted categorical column
    indices) of an input matrix (the JAX package's basic.py:52). Pandas categorical/object columns become their
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
    elif isinstance(data, SparseMatrix):
        X = data
    elif _is_scipy_sparse(data):
        # CSR on the host (io/sparse.py): the set decides the sparse or
        # the densified route; predictions densify in bounded chunks
        X = SparseMatrix.from_scipy(data)
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


def _label_to_1d(y) -> np.ndarray:
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(y, pd.DataFrame):
        if y.shape[1] != 1:
            raise LightGBMError("DataFrame for label should be 1-D")
        y = y.iloc[:, 0]
    if pd is not None and isinstance(y, pd.Series):
        y = y.to_numpy()
    return np.asarray(y, np.float32).reshape(-1)


class Dataset:
    """Training or validation data (basic.py:626-1448 surface), binned
    lazily: on the device of the Booster that first uses it, a valid
    set (``reference``) with its reference's mappers on the reference's
    device, and a ``subset`` of a binned set by selecting its bins on
    the device."""

    def __init__(self, data, label=None, reference: "Dataset" = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto",
                 categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self.free_raw_data = free_raw_data
        self.used_indices: Optional[np.ndarray] = None
        self._subset_of: Optional["Dataset"] = None
        self._inner: Optional[BinnedDataset] = None
        self._predictor: Optional["_InnerPredictor"] = None
        # the init scores the set was given, in the metadata's form,
        # before an init model's are added to them
        self._base_init_score: Optional[np.ndarray] = None

    def construct(self, device=None) -> "Dataset":
        """Bin the rows on ``device`` (None: cuda:0), once; a valid set
        bins on its reference's device, a subset of a binned set on its
        parent's. An init model's raw scores (``_set_predictor``) are
        folded into the init scores then. The raw rows are dropped then
        unless ``free_raw_data`` is False."""
        if self._inner is not None:
            return self
        parent = self._subset_of
        if parent is not None and parent._inner is not None:
            meta = self._build_metadata()
            self._base_init_score = meta.init_score
            self._inner = parent._inner.subset(self.used_indices, meta)
            return self
        if self.data is None:
            raise LightGBMError("the Dataset's raw data was freed")
        if isinstance(self.data, str):
            return self._construct_from_file(device)
        X, names, cat_idx = _data_to_2d(self.data, self.feature_name,
                                        self.categorical_feature)
        if self.used_indices is not None:
            X = X[self.used_indices]
        meta = self._build_metadata()
        self._base_init_score = meta.init_score
        ref = self.reference
        if ref is not None:
            ref.construct(device)
            self._inner = ref._inner.create_valid(X, meta)
        else:
            cfg = Config()
            cfg.set(self.params)
            self._inner = BinnedDataset(cfg, device).construct_from_matrix(
                X, meta, feature_names=names, categorical=cat_idx)
        if self._predictor is not None:
            self._apply_init_score_from_predictor(X)
        if self.free_raw_data:
            self.data = None
        return self

    def _construct_from_file(self, device) -> "Dataset":
        """A text or binary file through the loader (the JAX package's
        basic.py:161-170): a valid set with its reference's mappers on
        its device; a label given here replaces the file's."""
        ref = self.reference
        cfg = Config()
        cfg.set(self.params)
        self._inner = DatasetLoader(cfg, device).load_from_file(
            self.data, reference=(ref.construct(device)._inner
                                  if ref is not None else None))
        if self.label is not None:
            self._inner.metadata.label = _label_to_1d(self.label)
        self._base_init_score = self._inner.metadata.init_score
        if self._predictor is not None:
            self._apply_init_score_from_predictor(self._file_rows())
        return self

    def _file_rows(self) -> np.ndarray:
        """The raw rows of a file Dataset, parsed again."""
        return DatasetLoader(self._inner.config).load_predict_matrix(
            self.data, self._inner.num_total_features)[0]

    def save_binary(self, filename: str) -> "Dataset":
        """The binned set as a binary file (binned first, on cuda:0
        unless it is already); it loads in either package."""
        self.construct()
        self._inner.save_binary(filename)
        return self

    def _apply_init_score_from_predictor(self, raw_X: np.ndarray) -> None:
        """Continued training: the init model's raw scores of these rows,
        class-major, added to the init scores the set was given (the JAX
        package's basic.py:218). The given ones are kept apart, so that
        another predictor replaces the first one's scores rather than
        adding to them."""
        raw = self._predictor.init_score_for(raw_X)
        base = self._base_init_score
        self._inner.metadata.init_score = (
            raw if base is None else np.asarray(base, np.float64) + raw)

    def _set_predictor(self, predictor) -> None:
        """The init model whose raw scores start this set's scores
        (basic.py:230-251); a set binned already folds them at once from
        its raw rows, which it must have kept."""
        if predictor is self._predictor:
            return
        self._predictor = predictor
        if self._inner is not None and predictor is not None:
            if self.data is None:
                raise LightGBMError(
                    "Cannot set init model on a constructed Dataset whose "
                    "raw data was freed; use free_raw_data=False")
            if isinstance(self.data, str):
                raw_X = self._file_rows()
            else:
                raw_X = _data_to_2d(self.data, self.feature_name,
                                    self.categorical_feature)[0]
                if self.used_indices is not None:
                    raw_X = raw_X[self.used_indices]
            self._apply_init_score_from_predictor(raw_X)

    def _build_metadata(self) -> Metadata:
        sub = self.used_indices
        label = None if self.label is None else _label_to_1d(self.label)
        weight = (None if self.weight is None
                  else np.asarray(self.weight, np.float32).reshape(-1))
        init = (None if self.init_score is None
                else np.asarray(self.init_score, np.float64).reshape(-1))
        group = (None if self.group is None
                 else np.asarray(self.group, np.int64).reshape(-1))
        if sub is not None:
            label = None if label is None else label[sub]
            weight = None if weight is None else weight[sub]
            if init is not None:
                n = self._parent_rows()
                init = init.reshape(-1, n)[:, sub].reshape(-1)
            if group is not None:
                # each query's rows among the subset (metadata.cpp:97-115);
                # group-aware folds keep queries whole
                qb = np.concatenate([[0], np.cumsum(group)])
                qidx = np.searchsorted(qb, sub, side="right") - 1
                counts = np.bincount(qidx, minlength=len(group))
                group = counts[counts > 0]
        return Metadata(label=label, weight=weight, init_score=init,
                        group=group)

    def _parent_rows(self) -> int:
        """Rows of the data a subset's indices point into."""
        parent = self._subset_of
        if parent is not None:
            return parent.num_data()
        return _data_to_2d(self.data)[0].shape[0]

    # -- fields (basic.py set_field/get_field) ------------------------------

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._inner is not None and label is not None:
            self._inner.metadata.label = _label_to_1d(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._inner is not None and weight is not None:
            self._inner.metadata.weights = np.asarray(
                weight, np.float32).reshape(-1)
        return self

    def set_group(self, group) -> "Dataset":
        """Each query's row count, in row order."""
        self.group = group
        if self._inner is not None and group is not None:
            self._inner.metadata.set_group(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._inner is not None and init_score is not None:
            self._base_init_score = np.asarray(
                init_score, np.float64).reshape(-1)
            self._inner.metadata.init_score = self._base_init_score
        return self

    def get_label(self):
        if self._inner is not None:
            return self._inner.metadata.label
        return None if self.label is None else _label_to_1d(self.label)

    def get_weight(self):
        if self._inner is not None:
            return self._inner.metadata.weights
        return self.weight

    def get_init_score(self):
        if self._inner is not None:
            return self._inner.metadata.init_score
        return self.init_score

    def get_group(self):
        if self._inner is not None:
            qb = self._inner.metadata.query_boundaries
            return None if qb is None else np.diff(qb)
        return self.group

    _FIELDS = ("label", "weight", "init_score", "group")

    def get_field(self, field_name: str):
        if field_name not in self._FIELDS:
            raise LightGBMError(f"Unknown field {field_name!r}")
        return getattr(self, "get_" + field_name)()

    def set_field(self, field_name: str, data) -> "Dataset":
        if field_name not in self._FIELDS:
            raise LightGBMError(f"Unknown field {field_name!r}")
        return getattr(self, "set_" + field_name)(data)

    # -- shape --------------------------------------------------------------

    def num_data(self) -> int:
        """Rows; read from the raw data while the set is not binned."""
        if self._inner is not None:
            return self._inner.num_data
        if self.used_indices is not None:
            return len(self.used_indices)
        if isinstance(self.data, str):
            raise LightGBMError("construct a file Dataset first")
        return _data_to_2d(self.data)[0].shape[0]

    def num_feature(self) -> int:
        if self._inner is not None:
            return self._inner.num_total_features
        if self._subset_of is not None:
            return self._subset_of.num_feature()
        if isinstance(self.data, str):
            raise LightGBMError("construct a file Dataset first")
        return _data_to_2d(self.data)[0].shape[1]

    def get_feature_name(self) -> List[str]:
        if self._inner is None:
            raise LightGBMError("construct the Dataset first")
        return list(self._inner.feature_names)

    # -- derived datasets ---------------------------------------------------

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this Dataset's mappers
        (basic.py:866-900)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params,
                       free_raw_data=self.free_raw_data)

    def subset(self, used_indices: Sequence[int],
               params=None) -> "Dataset":
        """Rows ``used_indices`` (basic.py:902-926): of a binned set, its
        bins selected on its device with its mappers; of one not binned
        yet, its raw rows, binned with mappers of their own."""
        if self._inner is None and self.data is None:
            raise LightGBMError("Cannot subset a Dataset whose raw data "
                                "was freed")
        # a binned set's init scores carry an init model's, folded
        ret = Dataset(None if self._inner is not None else self.data,
                      label=self.label, weight=self.weight, group=self.group,
                      init_score=self.get_init_score(),
                      feature_name=self.feature_name,
                      categorical_feature=self.categorical_feature,
                      params=params or self.params,
                      free_raw_data=self.free_raw_data)
        ret.used_indices = np.sort(np.asarray(used_indices, np.int64))
        ret._subset_of = self
        ret._predictor = self._predictor
        return ret

    def set_reference(self, reference: "Dataset") -> "Dataset":
        if reference is self.reference:
            return self
        if self._inner is not None:
            raise LightGBMError("Cannot set reference after the dataset "
                                "was constructed")
        self.reference = reference
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        if categorical_feature == "auto":
            return self
        if self._inner is not None and list(categorical_feature) != list(
                self.categorical_feature or []):
            raise LightGBMError("Cannot change categorical_feature after "
                                "the dataset was constructed")
        self.categorical_feature = categorical_feature
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        if feature_name == "auto":
            # keep what the Dataset already has (reference basic.py)
            return self
        self.feature_name = feature_name
        if self._inner is not None and isinstance(feature_name,
                                                  (list, tuple)):
            if len(feature_name) != self._inner.num_total_features:
                raise LightGBMError("Length of feature names doesn't equal "
                                    "with num_feature")
            self._inner.feature_names = [str(x) for x in feature_name]
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
        self.valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_data_name = "training"
        self._metric_names: List[str] = []
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                f"met {type(train_set).__name__}")
            self._init_from_train_set(train_set, device)
            return
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        elif model_str is None:
            raise TypeError("Need a training dataset or model file or model "
                            "string to create a Booster")
        self._init_from_string(model_str, device, model_file or "")

    def _init_from_string(self, model_str: str, device=None,
                          source: str = "") -> None:
        self.config = None
        self._gbdt = GBDT(device).load_model_from_string(model_str,
                                                         source=source)
        self._metric_names = []

    def _init_from_train_set(self, train_set: Dataset, device) -> None:
        cfg = Config()
        cfg.set(self.params)
        train_set.params = {**self.params, **train_set.params}
        inner = train_set.construct(device)._inner
        objective = create_objective(cfg.objective, cfg)
        if objective is not None:
            objective.init(inner.metadata, inner.num_data)
        self._metric_names = metric_names(cfg)
        metrics = create_metrics(self._metric_names, cfg, inner.metadata,
                                 inner.num_data)
        self.config = cfg
        self._gbdt = create_boosting(cfg.boosting_type(), inner.device).init(
            cfg, inner, objective, metrics)

    # -- training -----------------------------------------------------------

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Add a validation set, binned with the train set's mappers on
        its device (basic.py:1540)."""
        if self.train_set is None:
            raise LightGBMError("Add valid data requires a Booster with "
                                "training data")
        data.set_reference(self.train_set)
        # a valid set's scores start from the init model's too
        data._set_predictor(self.train_set._predictor)
        inner = data.construct(self._gbdt.device)._inner
        metrics = create_metrics(self._metric_names, self.config,
                                 inner.metadata, inner.num_data)
        self._gbdt.add_valid_data(inner, metrics, name)
        self.valid_sets.append(data)
        self.name_valid_sets.append(name)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True when no further split was
        possible (basic.py:1693-1746). ``fobj(raw scores, train set)``
        gives custom (grad, hess), float64 raw scores flattened
        class-major as the reference gives them. A booster whose
        datasets were freed (``free_dataset``) trains on, as in the JAX
        package."""
        if getattr(self._gbdt, "train_data", None) is None:
            raise LightGBMError("update needs a Booster with training data")
        if train_set is not None and train_set is not self.train_set:
            raise LightGBMError("Replacing the train set mid-training is "
                                "not supported; create a new Booster")
        if fobj is None:
            return self._gbdt.train_one_iter()
        grad, hess = fobj(self.__inner_predict(0), self.train_set)
        return self.__boost(grad, hess)

    def __boost(self, grad, hess) -> bool:
        """One iteration on custom gradients: K * N values each,
        class-major (basic.py:1748-1780)."""
        grad = np.asarray(grad, np.float32)
        hess = np.asarray(hess, np.float32)
        k = self._gbdt.num_tree_per_iteration
        n = self._gbdt._n
        if grad.size != k * n or hess.size != k * n:
            raise ValueError(
                f"Lengths of gradient({grad.size}) and hessian({hess.size}) "
                f"don't equal to num_data*num_class({k * n})")
        return self._gbdt.train_one_iter(grad.reshape(k, n),
                                         hess.reshape(k, n))

    def rollback_one_iter(self) -> "Booster":
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Reset training parameters, the learning rate among them
        (gbdt.cpp ResetConfig): the grower is set up again."""
        if self.config is not None:
            self.config.set(params)
            self._gbdt.reset_config()
        self.params.update(params)
        return self

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    # -- evaluation ---------------------------------------------------------

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def eval_train(self, feval=None) -> List[tuple]:
        """[(data name, metric name, value, bigger is better)] on the
        train set, then ``feval``'s."""
        return self.__eval(0, self._train_data_name, feval)

    def eval_valid(self, feval=None) -> List[tuple]:
        out = []
        for i, name in enumerate(self.name_valid_sets):
            out.extend(self.__eval(i + 1, name, feval))
        return out

    def eval(self, data: Dataset, name: str, feval=None) -> List[tuple]:
        if data is self.train_set:
            return self.eval_train(feval)
        for i, vs in enumerate(self.valid_sets):
            if data is vs:
                return self.__eval(i + 1, name, feval)
        raise LightGBMError("Data should be added with add_valid first")

    def __eval(self, data_idx: int, name: str, feval=None) -> List[tuple]:
        out = [(name, mname, val, bigger)
               for mname, val, bigger in self._gbdt.get_eval_at(data_idx)]
        if feval is not None:
            ds = self.train_set if data_idx == 0 \
                else self.valid_sets[data_idx - 1]
            ret = feval(self.__inner_predict(data_idx), ds)
            for fname, val, bigger in (ret if isinstance(ret, list)
                                       else [] if ret is None else [ret]):
                out.append((name, fname, val, bigger))
        return out

    def __inner_predict(self, data_idx: int) -> np.ndarray:
        """Raw scores of the train set (0) or a valid set (1, ...), as
        float64, flattened class-major when K > 1."""
        scores = (self._gbdt.train_scores() if data_idx == 0
                  else self._gbdt.valid_scores(data_idx))
        raw = scores.cpu().numpy().astype(np.float64)
        return raw[0] if raw.shape[0] == 1 else raw.reshape(-1)

    # -- prediction ---------------------------------------------------------

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, data_has_header: bool = False,
                **kwargs) -> np.ndarray:
        """Predictions [N] or [N, K]; raw scores with ``raw_score``, leaf
        indices [N, T] with ``pred_leaf``, SHAP contributions [N, K *
        (F + 1)] with ``pred_contrib`` (float64 on the host). ``data`` may
        be a text file's path (``data_has_header``). ``pred_early_stop*``
        keywords go to the host walk as in the reference."""
        if isinstance(data, str):
            cfg = Config()
            cfg.header = data_has_header
            X, _ = DatasetLoader(cfg).load_predict_matrix(
                data, self._gbdt.max_feature_idx + 1)
        else:
            X = _data_to_2d(data)[0]
            if not isinstance(X, SparseMatrix):
                X = np.asarray(X, np.float64)
        if num_iteration < 0 and self.best_iteration > 0:
            num_iteration = self.best_iteration
        pred_kw = {k: v for k, v in kwargs.items()
                   if k.startswith("pred_early_stop")}
        if pred_leaf:
            return self._gbdt.predict_leaf_index(X, num_iteration)
        if pred_contrib:
            return self._gbdt.predict_contrib(X, num_iteration)
        if raw_score:
            return self._gbdt.predict_raw(X, num_iteration, **pred_kw)
        return self._gbdt.predict(X, num_iteration, **pred_kw)

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A new Booster: this model's trees with their leaf values
        re-learned on ``data`` and ``label`` (basic.py Booster.refit ->
        GBDT::RefitTree), binned and refit on this model's device. The
        categorical columns are read from the model's feature_infos
        (categories joined by ':', a numerical range in brackets)."""
        X = _data_to_2d(data)[0]
        y = _label_to_1d(label)
        cfg = Config()
        params = dict(self.params)
        params.pop("refit_decay_rate", None)
        cfg.set(params)
        cfg.refit_decay_rate = decay_rate
        if not params.get("objective") and self._gbdt.objective is not None:
            cfg.objective = self._gbdt.objective.name
        model_str = self.model_to_string()
        new = create_boosting(cfg.boosting_type(), self._gbdt.device)
        new.load_model_from_string(model_str)
        cats = [i for i, info in enumerate(new.feature_infos)
                if info and info != "none" and not info.startswith("[")]
        inner = BinnedDataset(cfg, self._gbdt.device).construct_from_matrix(
            X, Metadata(label=y), categorical=cats)
        objective = create_objective(cfg.objective, cfg)
        if objective is not None:
            objective.init(inner.metadata, inner.num_data)
        new.init_from_loaded(cfg, inner, objective, [])
        new.refit_existing(decay_rate)
        out = Booster(model_str=model_str, device=self._gbdt.device)
        out._gbdt = new
        out.params = params
        out.config = cfg
        return out

    # -- introspection ------------------------------------------------------

    def num_trees(self) -> int:
        return len(self._gbdt.models)

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_model_per_iteration()

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = 0) -> np.ndarray:
        imp = self._gbdt.feature_importance(importance_type, iteration)
        return imp.astype(np.int32) if importance_type == "split" else imp

    def save_checkpoint(self, directory: str) -> Optional[str]:
        """Write a resumable checkpoint bundle (utils/checkpoint.py):
        the model text plus the training state a restart needs to
        continue bit-identically. Returns the path, or None on a failure
        (which warns and never raises: ``engine.train``'s periodic
        checkpoints call this mid-run)."""
        return self._gbdt.write_checkpoint(directory)

    def free_dataset(self) -> "Booster":
        self.train_set = None
        self.valid_sets = []
        return self

    def _to_predictor(self) -> "_InnerPredictor":
        return _InnerPredictor(booster=self)

    # -- serialization ------------------------------------------------------

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

    def dump_model(self, num_iteration: int = -1,
                   start_iteration: int = 0) -> dict:
        if num_iteration < 0 and self.best_iteration > 0:
            num_iteration = self.best_iteration
        return self._gbdt.dump_model(start_iteration, num_iteration)

    def model_from_string(self, model_str: str,
                          verbose: bool = True) -> "Booster":
        """Replace this booster's model with one parsed from a string
        (basic.py:2049-2068), on the same device."""
        self._init_from_string(model_str, self._gbdt.device)
        return self

    # -- pickling (the reference pickles the model string, basic.py:1476) ---

    def __getstate__(self):
        return {"params": self.params,
                "best_iteration": self.best_iteration,
                "best_score": self.best_score,
                "model_str": self.model_to_string()}

    def __setstate__(self, state):
        """Onto cuda:0, as every entry point (the device is not part of
        the state)."""
        self.params = state["params"]
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
        self.train_set = None
        self.valid_sets = []
        self.name_valid_sets = []
        self._train_data_name = "training"
        self._init_from_string(state["model_str"])


class _InnerPredictor:
    """An init model for continued training (basic.py:356-624
    _InnerPredictor; the JAX package's basic.py:820-855): its raw
    scores, folded into a Dataset's init scores. A model file or text is
    loaded on ``device`` (None: cuda:0); a Booster's model predicts on
    its own device."""

    def __init__(self, model_file: Optional[str] = None,
                 booster: Optional[Booster] = None,
                 model_str: Optional[str] = None, device=None):
        if booster is not None:
            self._gbdt = booster._gbdt
        elif model_file is not None:
            with open(model_file) as fh:
                self._gbdt = GBDT(device).load_model_from_string(
                    fh.read(), source=model_file)
        elif model_str is not None:
            self._gbdt = GBDT(device).load_model_from_string(model_str)
        else:
            raise TypeError("Need model_file, model_str or booster")

    @property
    def num_total_iteration(self) -> int:
        return self._gbdt.current_iteration

    def init_score_for(self, X) -> np.ndarray:
        """Raw scores of the rows of ``X`` (an array or a
        ``SparseMatrix``), float64, flattened class-major (the init score
        layout, metadata.cpp)."""
        if not isinstance(X, SparseMatrix):
            X = np.asarray(X, np.float64)
        raw = self._gbdt.predict_raw(X)
        if raw.ndim == 2:
            return raw.T.reshape(-1).astype(np.float64)
        return raw.astype(np.float64)
