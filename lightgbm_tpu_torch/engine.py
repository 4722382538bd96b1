"""``train`` and ``cv`` (the JAX package's ``engine.py``, reference
python-package engine.py:19-498): training with valid sets, callbacks,
custom objectives (``fobj``) and evaluation functions and early
stopping, continued training from an init model (``init_model``, a
model file or a Booster: its raw scores start the scores), and k-fold
cross-validation (query-aware for ranking). ``train`` also writes the
run report (``tpu_run_report``, obs/recorder.py), the profiler window
(``tpu_profile_dir``/``tpu_profile_iters``, obs/profiler.py) and
resumable checkpoints (``tpu_checkpoint_dir``/``tpu_checkpoint_freq``,
utils/checkpoint.py), and resumes from one (``tpu_resume_from``)."""
from __future__ import annotations

import collections
import copy
from operator import attrgetter
from typing import Dict, List

import numpy as np

from . import callback
from .basic import Booster, Dataset, _InnerPredictor
from .utils.log import LightGBMError

__all__ = ["train", "cv", "CVBooster"]

_NUM_BOOST_ROUND_ALIASES = [
    "num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
    "num_round", "num_rounds", "num_boost_round", "n_estimators"]
_EARLY_STOP_ALIASES = [
    "early_stopping_round", "early_stopping_rounds", "early_stopping"]


def _pop_rounds(params: Dict, num_boost_round: int,
                early_stopping_rounds):
    """(num_boost_round, early_stopping_rounds), each overridden by its
    first alias in ``params``, which is taken out."""
    for alias in _NUM_BOOST_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            break
    for alias in _EARLY_STOP_ALIASES:
        if alias in params and params[alias] is not None:
            early_stopping_rounds = int(params.pop(alias))
            break
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    return num_boost_round, early_stopping_rounds


def _predictor(init_model, device):
    """The init model of continued training: a model file, loaded on
    ``device``, or a Booster (engine.py:50-56)."""
    if isinstance(init_model, str):
        return _InnerPredictor(model_file=init_model, device=device)
    if isinstance(init_model, Booster):
        return init_model._to_predictor()
    return None


def _ordered(callbacks) -> tuple:
    """(before-iteration, after-iteration) callbacks, each by order;
    user callbacks without one run first, in the order given."""
    cbs = set(callbacks)
    return (sorted((cb for cb in cbs
                    if getattr(cb, "before_iteration", False)),
                   key=attrgetter("order")),
            sorted((cb for cb in cbs
                    if not getattr(cb, "before_iteration", False)),
                   key=attrgetter("order")))


def _user_callbacks(callbacks) -> set:
    if callbacks is None:
        return set()
    for i, cb in enumerate(callbacks):
        cb.__dict__.setdefault("order", i - len(callbacks))
    return set(callbacks)


def train(params: Dict, train_set: Dataset, num_boost_round: int = 100,
          valid_sets=None, valid_names=None, fobj=None, feval=None,
          init_model=None, feature_name="auto", categorical_feature="auto",
          early_stopping_rounds=None, evals_result=None, verbose_eval=True,
          learning_rates=None, keep_training_booster=False, callbacks=None,
          device=None) -> Booster:
    """Train ``num_boost_round`` iterations on ``device`` (None: cuda:0),
    evaluating ``valid_sets`` (the JAX package's engine.py:19-194).
    Aliases in ``params`` override the round count and the early-stopping
    rounds, as in the reference. With ``init_model`` the init model's raw
    scores start the train and valid scores, the callbacks count
    iterations on from its iterations, and the returned model holds only
    the new trees. Training stops at the first iteration
    that could not split (``Booster.update`` returns True), or when the
    early-stopping callback ends it: then ``best_iteration`` is set, and
    the model text and predictions use it.

    Telemetry and fault tolerance, from ``params``:

    - ``tpu_run_report``: a RunRecorder (obs/recorder.py) spans the
      iterations through ``callback.record_run`` and writes the
      versioned run report at the end, as the JAX package's
      engine.py:107-185 does, its meta with the ``step_cache`` and
      ``predict_cache`` registries' ``stats()``;
    - ``tpu_profile_dir``/``tpu_profile_iters``: a torch.profiler window
      over the iterations (obs/profiler.py), the update and evaluation
      of each inside ``train/iteration`` and ``train/eval`` phase ranges;
    - ``tpu_checkpoint_dir``/``tpu_checkpoint_freq``: a checkpoint
      bundle every that many iterations, after the iteration's
      evaluation and callbacks (``Booster.save_checkpoint``);
    - ``tpu_resume_from`` (a bundle, or a directory's newest valid one):
      the booster is restored from it (utils/checkpoint.py restore) and
      the loop goes on at the next iteration, so a killed run resumed
      with the same call writes the uninterrupted run's model. The
      bundle holds the booster's state, not the callbacks': an
      early-stopping or ``evals_result`` callback starts afresh at the
      resumed iteration (the CLI driver, ``GBDT.train``, keeps its
      early-stopping bookkeeping in the bundle);
    - ``tpu_faults``: the ``train.iter`` fault point sits at the top of
      each iteration (the kill-and-resume drills)."""
    params = copy.deepcopy(params) if params else {}
    num_boost_round, early_stopping_rounds = _pop_rounds(
        params, num_boost_round, early_stopping_rounds)
    predictor = _predictor(init_model, device)
    init_iteration = predictor.num_total_iteration if predictor else 0
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    train_set.params.update(params)
    train_set._set_predictor(predictor)
    train_set.set_feature_name(feature_name)
    train_set.set_categorical_feature(categorical_feature)

    is_valid_contain_train = False
    train_data_name = "training"
    reduced_valid_sets: List[Dataset] = []
    name_valid_sets: List[str] = []
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        if isinstance(valid_names, str):
            valid_names = [valid_names]
        for i, valid_data in enumerate(valid_sets):
            if valid_data is train_set:
                is_valid_contain_train = True
                if valid_names is not None:
                    train_data_name = valid_names[i]
                continue
            if not isinstance(valid_data, Dataset):
                raise TypeError("Training only accepts Dataset object")
            valid_data.set_reference(train_set)
            reduced_valid_sets.append(valid_data)
            name_valid_sets.append(
                valid_names[i] if valid_names is not None
                and len(valid_names) > i else f"valid_{i}")

    callbacks = _user_callbacks(callbacks)
    if verbose_eval is True:
        callbacks.add(callback.print_evaluation())
    elif isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool):
        callbacks.add(callback.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None:
        callbacks.add(callback.early_stopping(early_stopping_rounds,
                                              verbose=bool(verbose_eval)))
    if learning_rates is not None:
        callbacks.add(callback.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        callbacks.add(callback.record_evaluation(evals_result))
    recorder = None
    run_report = str(params.get("tpu_run_report", "") or "")
    if run_report:
        from .obs.recorder import RunRecorder
        recorder = RunRecorder(
            path=run_report,
            watchdog_factor=float(
                params.get("tpu_watchdog_factor", 8.0) or 0.0),
            meta={"driver": "engine.train",
                  "num_boost_round": num_boost_round,
                  "init_iteration": init_iteration})
        callbacks.add(callback.record_run(recorder))
    before, after = _ordered(callbacks)

    booster = Booster(params=params, train_set=train_set, device=device)
    dev = booster._gbdt.device
    if recorder is not None:
        recorder.device = dev
        recorder.meta["mesh_devices"] = booster._gbdt.num_devices
        recorder.meta["tree_learner"] = booster._gbdt.learner_mode
    if is_valid_contain_train:
        booster.set_train_data_name(train_data_name)
    for valid_set, name in zip(reduced_valid_sets, name_valid_sets):
        booster.add_valid(valid_set, name)
    booster.best_iteration = 0
    resumed = 0
    resume_from = str(params.get("tpu_resume_from", "") or "")
    if resume_from:
        from .utils import checkpoint as ckpt
        resumed = ckpt.restore(booster._gbdt,
                               ckpt.resolve_resume(resume_from))
        if recorder is not None:
            recorder.meta["resumed_from_iteration"] = resumed
    from .obs.profiler import ProfileWindow
    profile = ProfileWindow(str(params.get("tpu_profile_dir", "") or ""),
                            int(params.get("tpu_profile_iters", 0) or 0),
                            device=dev)
    if recorder is not None:
        # started here, not at construction, so an exception in the
        # booster's or the valid sets' setup cannot leak the log prefix
        recorder.start()
    try:
        results = _train_loop(
            booster, params, init_iteration, num_boost_round, before,
            after, fobj, feval, valid_sets is not None,
            is_valid_contain_train, profile, resumed,
            ckpt_dir=str(params.get("tpu_checkpoint_dir", "") or ""),
            ckpt_freq=int(params.get("tpu_checkpoint_freq", 0) or 0))
    finally:
        booster._gbdt._drain_checkpoints()
        profile.close()
        if recorder is not None:
            leaves = waves = None
            if init_iteration == 0 and not resumed:
                # the recorder's iteration keys start at 1 only then
                leaves, waves = booster._gbdt.leaves_and_waves()
            from .ops import predict_cache, step_cache
            recorder.meta["step_cache"] = step_cache.stats()
            recorder.meta["predict_cache"] = predict_cache.stats()
            recorder.finish(
                leaves_per_iteration=leaves or None,
                waves_per_iteration=waves or None,
                extra={"best_iteration": booster.best_iteration})
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for dataset_name, eval_name, score, _ in results:
        booster.best_score[dataset_name][eval_name] = score
    if not keep_training_booster:
        booster.free_dataset()
    return booster


def _train_loop(booster: Booster, params: Dict, init_iteration: int,
                num_boost_round: int, before: list, after: list, fobj, feval,
                has_valid: bool, is_valid_contain_train: bool, profile,
                resumed: int = 0, ckpt_dir: str = "",
                ckpt_freq: int = 0) -> list:
    """The boosting loop (the JAX package's engine.py:197-293, its
    synchronous route): each iteration is evaluated, with one readback
    a set, before the next starts; the callbacks see iterations from
    ``init_iteration`` on, and a resumed run starts ``resumed``
    iterations in. A checkpoint is written after an iteration's
    callbacks, so a bundle never holds a tree an early stop is about to
    drop. Returns the last evaluation result list, or the best one on an
    early stop."""
    from .utils import faults, timing
    results = []
    end_iteration = init_iteration + num_boost_round
    for i in range(init_iteration + resumed, end_iteration):
        if faults.active():
            faults.check("train.iter", context=i + 1)
        for cb in before:
            cb(callback.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=init_iteration, end_iteration=end_iteration,
                evaluation_result_list=None))
        profile.iter_begin(i - init_iteration + 1)
        with timing.phase("train/iteration"):
            finished = booster.update(fobj=fobj)
        profile.iter_end(i - init_iteration + 1)
        if finished:
            break
        results = []
        if has_valid or feval is not None:
            with timing.phase("train/eval"):
                if is_valid_contain_train:
                    results.extend(booster.eval_train(feval))
                results.extend(booster.eval_valid(feval))
        try:
            for cb in after:
                cb(callback.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=init_iteration,
                    end_iteration=end_iteration,
                    evaluation_result_list=results))
        except callback.EarlyStopException as early_stop:
            booster.best_iteration = early_stop.best_iteration + 1
            return early_stop.best_score
        if ckpt_freq > 0 and ckpt_dir \
                and (i + 1 - init_iteration) % ckpt_freq == 0:
            booster.save_checkpoint(ckpt_dir)
    return results


class CVBooster:
    """The fold boosters of a ``cv`` run (engine.py:240-268): a method
    call on it calls each booster's and returns their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs)
                    for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, params: Dict,
                  seed: int, fpreproc=None, stratified: bool = False,
                  shuffle: bool = True, device=None) -> CVBooster:
    """The folds' boosters (engine.py:271-324): ``full_data`` is binned
    once on ``device``, and each fold's train and valid rows are subsets
    of its bins. Stratified folds, and a ranking set's folds (each query
    whole in one), need scikit-learn."""
    full_data.construct(device)
    num_data = full_data.num_data()
    group = full_data.get_group()
    if folds is not None:
        if not hasattr(folds, "__iter__"):
            folds = folds.split(X=np.zeros(num_data),
                                y=full_data.get_label())
        else:
            # (train_idx, test_idx) pairs, or bare test-index arrays
            # whose train side is the complement (lgb.cv.R)
            all_idx = np.arange(num_data)
            norm = []
            for fd in folds:
                if (isinstance(fd, (tuple, list)) and len(fd) == 2
                        and all(hasattr(x, "__len__") for x in fd)):
                    norm.append((np.asarray(fd[0], np.int64),
                                 np.asarray(fd[1], np.int64)))
                else:
                    te = np.asarray(list(fd), np.int64)
                    norm.append((np.setdiff1d(all_idx, te), te))
            folds = norm
    elif group is not None:
        # ranking: each query stays whole in one fold (GroupKFold)
        group = np.asarray(group, np.int64)
        flatted_group = np.repeat(np.arange(len(group)), group)
        try:
            from sklearn.model_selection import GroupKFold
        except ImportError:
            raise LightGBMError(
                "scikit-learn is required for group-aware cv")
        folds = GroupKFold(n_splits=nfold).split(
            X=np.zeros(num_data), groups=flatted_group)
    elif stratified:
        try:
            from sklearn.model_selection import StratifiedKFold
        except ImportError:
            raise LightGBMError(
                "scikit-learn is required for stratified cv")
        skf = StratifiedKFold(n_splits=nfold, shuffle=shuffle,
                              random_state=seed if shuffle else None)
        folds = skf.split(X=np.zeros(num_data), y=full_data.get_label())
    else:
        rng = np.random.default_rng(seed)
        randidx = (rng.permutation(num_data) if shuffle
                   else np.arange(num_data))
        kstep = int(num_data / nfold)
        test_id = [randidx[i * kstep:
                           (i + 1) * kstep if i + 1 < nfold else num_data]
                   for i in range(nfold)]
        folds = ((np.setdiff1d(randidx, tid, assume_unique=True), tid)
                 for tid in test_id)

    ret = CVBooster()
    for train_idx, test_idx in folds:
        train_sub = full_data.subset(np.sort(train_idx))
        valid_sub = full_data.subset(np.sort(test_idx))
        if fpreproc is not None:
            train_sub, valid_sub, tparam = fpreproc(
                train_sub, valid_sub, params.copy())
        else:
            tparam = params
        cvbooster = Booster(params=tparam, train_set=train_sub,
                            device=device)
        cvbooster.add_valid(valid_sub, "valid")
        ret.append(cvbooster)
    return ret


def _agg_cv_result(raw_results):
    """Each metric's mean and standard deviation over the folds
    (engine.py:327-338)."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = one_line[1]
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, [])
            cvmap[key].append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict, train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       device=None) -> Dict:
    """K-fold cross-validation on ``device`` (None: cuda:0; the JAX
    package's engine.py:341-498): the eval history {metric-mean: [...],
    metric-stdv: [...]}, cut at the best iteration on an early stop."""
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    params = copy.deepcopy(params) if params else {}
    num_boost_round, early_stopping_rounds = _pop_rounds(
        params, num_boost_round, early_stopping_rounds)
    if metrics is not None:
        params["metric"] = metrics
    if train_set.get_label() is None:
        raise LightGBMError("Labels should not be None")
    train_set.params.update(params)
    train_set._set_predictor(_predictor(init_model, device))
    train_set.set_feature_name(feature_name)
    train_set.set_categorical_feature(categorical_feature)
    if stratified and params.get("objective") not in (
            "binary", "multiclass", "multiclassova", None) \
            and train_set.get_group() is None:
        stratified = False

    results = collections.defaultdict(list)
    cvfolds = _make_n_folds(train_set, folds, nfold, params, seed,
                            fpreproc=fpreproc, stratified=stratified,
                            shuffle=shuffle, device=device)
    callbacks = _user_callbacks(callbacks)
    if early_stopping_rounds is not None:
        callbacks.add(callback.early_stopping(early_stopping_rounds,
                                              verbose=False))
    if verbose_eval is True:
        callbacks.add(callback.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool):
        callbacks.add(callback.print_evaluation(verbose_eval, show_stdv))
    before, after = _ordered(callbacks)

    for i in range(num_boost_round):
        for cb in before:
            cb(callback.CallbackEnv(
                model=cvfolds, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        cvfolds.update(fobj=fobj)
        res = _agg_cv_result(cvfolds.eval_valid(feval))
        for _, key, mean, _, std in res:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in after:
                cb(callback.CallbackEnv(
                    model=cvfolds, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=res))
        except callback.EarlyStopException as early_stop:
            cvfolds.best_iteration = early_stop.best_iteration + 1
            for k in list(results):
                results[k] = results[k][:cvfolds.best_iteration]
            break
    return dict(results)
