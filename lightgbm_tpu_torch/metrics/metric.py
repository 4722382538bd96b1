"""Evaluation metrics of the binary objective.

Counterparts of the JAX package's ``metrics/metric.py``
``BinaryLoglossMetric`` (:241), ``BinaryErrorMetric`` (:294),
``AUCMetric`` (:317) and ``create_metrics`` (:620), with the metric-name
resolution of its ``basic.py`` (:422 ``_resolve_metric_names``;
reference binary_metric.hpp, config.cpp GetMetricType). Each metric
evaluates on the device that holds the scores: ``eval_tensor`` gives a
float64 scalar tensor there with no readback (the scores never travel to
the host), ``eval`` its value. Sums run in float64, so a value agrees
with the JAX package's f32 device reduction to its f32 rounding.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class Metric:
    name = "base"
    bigger_is_better = False

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.label = (np.asarray(metadata.label, np.float64)
                      if metadata.label is not None else np.zeros(num_data))
        self.weights = (np.asarray(metadata.weights, np.float64)
                        if metadata.weights is not None else None)
        self.num_data = num_data
        self.sum_weights = (float(num_data) if self.weights is None
                            else float(np.sum(self.weights)))
        self._dev = {}

    def _arrays(self, dev):
        """(label > 0 as f64, weights f64 or None) on ``dev``, cached."""
        if dev not in self._dev:
            w = self.weights
            self._dev[dev] = (
                torch.from_numpy((self.label > 0).astype(np.float64)).to(dev),
                None if w is None else torch.from_numpy(w).to(dev))
        return self._dev[dev]

    def eval_tensor(self, scores: torch.Tensor,
                    objective) -> torch.Tensor:
        """The value, a float64 scalar on the scores' device, of
        ``scores`` [K, N] raw scores."""
        raise NotImplementedError

    def eval(self, scores: torch.Tensor, objective) -> float:
        """``scores`` [K, N] raw scores on any device."""
        return float(self.eval_tensor(scores, objective))

    def _average(self, loss: torch.Tensor, w) -> torch.Tensor:
        """The (weighted) mean of float64 per-row losses."""
        if w is None:
            return loss.mean()
        return (loss * w).sum() / self.sum_weights


class BinaryLoglossMetric(Metric):
    """binary_metric.hpp: mean logloss of the binary objective, from the
    raw scores through softplus (no probability clipping), as the JAX
    device path does."""
    name = "binary_logloss"

    def eval_tensor(self, scores, objective):
        y, w = self._arrays(scores.device)
        sa = float(objective.sigmoid) * scores[0].to(torch.float64)
        zero = torch.zeros((), dtype=torch.float64, device=sa.device)
        loss = (y * torch.logaddexp(zero, -sa)
                + (1.0 - y) * torch.logaddexp(zero, sa))
        return self._average(loss, w)


class BinaryErrorMetric(Metric):
    """binary_metric.hpp BinaryErrorMetric: the share of rows whose
    converted score (f32, as the JAX device path converts it) is on the
    wrong side of 0.5."""
    name = "binary_error"

    def eval_tensor(self, scores, objective):
        y, w = self._arrays(scores.device)
        p = scores[0]
        if objective is not None:
            p = objective.convert_output(p)
        return self._average(((p > 0.5) != (y > 0)).to(torch.float64), w)


class AUCMetric(Metric):
    """AUC (binary_metric.hpp:266-400): the weighted rank statistic,
    with tied scores sharing their average rank."""
    name = "auc"
    bigger_is_better = True

    def eval_tensor(self, scores, objective):
        y, w = self._arrays(scores.device)
        s = scores[0]
        n = s.shape[0]
        order = torch.argsort(s, stable=True)
        s_s = s[order]
        y_s = y[order]
        w_s = torch.ones_like(y_s) if w is None else w[order]
        pos_w = y_s * w_s
        neg_w = w_s - pos_w
        first = torch.ones_like(s_s, dtype=torch.bool)
        first[1:] = s_s[1:] != s_s[:-1]
        gid = torch.cumsum(first.to(torch.int64), 0) - 1
        # one slot a row: the groups past the last stay empty, so the
        # group count need not be read back
        grp_pos = torch.zeros(n, dtype=torch.float64,
                              device=s.device).index_add_(0, gid, pos_w)
        grp_neg = torch.zeros(n, dtype=torch.float64,
                              device=s.device).index_add_(0, gid, neg_w)
        before = torch.cumsum(grp_neg, 0) - grp_neg
        auc_sum = torch.sum(grp_pos * (before + 0.5 * grp_neg))
        tp, tn = pos_w.sum(), neg_w.sum()
        one = torch.ones((), dtype=torch.float64, device=s.device)
        return torch.where((tp == 0.0) | (tn == 0.0), one,
                           auc_sum / (tp * tn))


_METRICS = {
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric, "auc": AUCMetric,
}

# an objective's metric when none is configured (config.cpp
# GetMetricType; the JAX package's basic.py _DEFAULT_METRIC), for the
# objectives the port has
_DEFAULT_METRIC = {"binary": "binary_logloss"}


def metric_names(config) -> List[str]:
    """The configured metric names, or the objective's default
    (Config::GetMetricType, basic.py _resolve_metric_names)."""
    names = [n for n in config.metric if n]
    if not names:
        default = _DEFAULT_METRIC.get(config.objective)
        return [default] if default else []
    if all(n.lower() in ("none", "null", "na", "custom") for n in names):
        return []
    return names


def create_metric(name: str, config) -> Optional[Metric]:
    n = name.strip().lower()
    if n in ("", "none", "null", "na", "custom"):
        return None
    if n not in _METRICS:
        raise NotImplementedError(
            f"metric {name!r} is not ported to lightgbm_tpu_torch yet")
    return _METRICS[n](config)


def create_metrics(names: Sequence[str], config, metadata,
                   num_data: int) -> List[Metric]:
    """Metrics for ``names`` in order, each once."""
    out, seen = [], set()
    for name in names:
        m = create_metric(name, config)
        if m is not None and m.name not in seen:
            m.init(metadata, num_data)
            seen.add(m.name)
            out.append(m)
    return out
