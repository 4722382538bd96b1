"""Training callbacks (the JAX package's ``callback.py``; reference
python-package/lightgbm/callback.py:1-222). Callbacks are callables
invoked once per boosting iteration with a ``CallbackEnv``; ones with
``before_iteration = True`` run before the boosting update.
"""
from __future__ import annotations

import collections
from operator import gt, lt

from .utils.log import LightGBMError


class EarlyStopException(Exception):
    """Raised by callbacks to end training early (callback.py:11-22)."""

    def __init__(self, best_iteration, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


# env passed to every callback (callback.py:26-33)
CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv=True):
    """(callback.py:36-46)."""
    if len(value) == 4:
        return "%s's %s: %g" % (value[0], value[1], value[2])
    if len(value) == 5:
        if show_stdv:
            return "%s's %s: %g + %g" % (value[0], value[1], value[2],
                                         value[4])
        return "%s's %s: %g" % (value[0], value[1], value[2])
    raise ValueError("Wrong metric value")


def print_evaluation(period=1, show_stdv=True):
    """Print evaluation results every ``period`` iterations
    (callback.py:49-77)."""
    def _callback(env):
        if (period > 0 and env.evaluation_result_list
                and (env.iteration + 1) % period == 0):
            result = "\t".join(
                _format_eval_result(x, show_stdv)
                for x in env.evaluation_result_list)
            print("[%d]\t%s" % (env.iteration + 1, result))
    _callback.order = 10
    return _callback


def record_evaluation(eval_result):
    """Record evaluation history into ``eval_result`` dict
    (callback.py:80-110)."""
    if not isinstance(eval_result, dict):
        raise TypeError("Eval_result should be a dictionary")
    eval_result.clear()

    def _init(env):
        for data_name, eval_name, _, _ in map(
                lambda x: x[:4], env.evaluation_result_list):
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env):
        if not eval_result:
            _init(env)
        for data_name, eval_name, result, _ in map(
                lambda x: x[:4], env.evaluation_result_list):
            eval_result[data_name][eval_name].append(result)
    _callback.order = 20
    return _callback


def record_run(recorder):
    """Feed per-iteration spans and eval results into a RunRecorder
    (obs/recorder.py): the ``engine.train`` telemetry seam, installed
    when ``tpu_run_report`` is set. Each span is the time since the
    previous iteration's callback (or the recorder's start); the port's
    loop evaluates every iteration before the next starts, so a span is
    one update and its evaluation. On several ranks each iteration's
    record also carries ``comm_bytes``, the bytes the rank sent through
    the collectives (models/gbdt.py)."""
    def _callback(env):
        recorder.tick(env.iteration + 1,
                      [x[:4] for x in (env.evaluation_result_list or [])])
        comm = getattr(getattr(env.model, "_gbdt", None), "_comm", None)
        if comm:
            recorder.set_field(env.iteration + 1, "comm_bytes",
                               comm[-1]["bytes"])
    _callback.order = 25
    return _callback


def reset_parameter(**kwargs):
    """Reset parameters after the first iteration (callback.py:113-155).

    kwargs values are either a list of length num_boost_round or a
    callable(iteration) -> value. Only ``learning_rate`` and other
    booster-resettable parameters are supported.
    """
    def _callback(env):
        new_parameters = {}
        for key, value in kwargs.items():
            if key in ("num_class", "num_classes", "boosting", "boost",
                       "boosting_type", "metric", "metrics", "metric_types"):
                raise LightGBMError(f"Cannot reset {key} during training")
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to "
                        "'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a mapping from boosting round "
                                 "index to new parameter value.")
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds, verbose=True):
    """Early stopping on validation metrics (callback.py:158-222).

    Checks every metric on every validation set; stops when none has
    improved in ``stopping_rounds`` iterations. The training data's
    own metrics are ignored.
    """
    best_score = []
    best_iter = []
    best_score_list = []
    cmp_op = []

    def _init(env):
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            print("Training until validation scores don't improve for "
                  f"{stopping_rounds} rounds.")
        for eval_ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:          # bigger is better
                best_score.append(float("-inf"))
                cmp_op.append(gt)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lt)

    def _callback(env):
        if not cmp_op:
            _init(env)
        for i, eval_ret in enumerate(env.evaluation_result_list):
            score = eval_ret[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            # train-set metrics never trigger the stop (callback.py:206);
            # the train data name is user-settable (set_train_data_name)
            train_name = getattr(env.model, "_train_data_name", "training")
            if eval_ret[0] == train_name:
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    print("Early stopping, best iteration is:\n[%d]\t%s" % (
                        best_iter[i] + 1, "\t".join(
                            _format_eval_result(x)
                            for x in best_score_list[i])))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    print("Did not meet early stopping. Best iteration is:"
                          "\n[%d]\t%s" % (best_iter[i] + 1, "\t".join(
                              _format_eval_result(x)
                              for x in best_score_list[i])))
                raise EarlyStopException(best_iter[i], best_score_list[i])
    _callback.order = 30
    return _callback
