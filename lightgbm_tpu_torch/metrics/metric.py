"""Evaluation metrics of the binary objective.

Counterparts of the JAX package's ``metrics/metric.py``
``BinaryLoglossMetric`` (:241), ``AUCMetric`` (:317) and
``create_metrics`` (:620) (reference binary_metric.hpp). Each evaluates
on the device that holds the scores and returns one float: the scores
never travel to the host. Sums run in float64, so a value agrees with
the JAX package's f32 device reduction to its f32 rounding.
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

    def eval(self, scores: torch.Tensor, objective) -> float:
        """``scores`` [K, N] raw scores on any device."""
        raise NotImplementedError


class BinaryLoglossMetric(Metric):
    """binary_metric.hpp: mean logloss of the binary objective, from the
    raw scores through softplus (no probability clipping), as the JAX
    device path does."""
    name = "binary_logloss"

    def eval(self, scores, objective):
        y, w = self._arrays(scores.device)
        sa = float(objective.sigmoid) * scores[0].to(torch.float64)
        zero = torch.zeros((), dtype=torch.float64, device=sa.device)
        loss = (y * torch.logaddexp(zero, -sa)
                + (1.0 - y) * torch.logaddexp(zero, sa))
        if w is None:
            return float(loss.mean())
        return float((loss * w).sum() / self.sum_weights)


class AUCMetric(Metric):
    """AUC (binary_metric.hpp:266-400): the weighted rank statistic,
    with tied scores sharing their average rank."""
    name = "auc"
    bigger_is_better = True

    def eval(self, scores, objective):
        y, w = self._arrays(scores.device)
        s = scores[0]
        order = torch.argsort(s, stable=True)
        s_s = s[order]
        y_s = y[order]
        w_s = torch.ones_like(y_s) if w is None else w[order]
        pos_w = y_s * w_s
        neg_w = w_s - pos_w
        first = torch.ones_like(s_s, dtype=torch.bool)
        first[1:] = s_s[1:] != s_s[:-1]
        gid = torch.cumsum(first.to(torch.int64), 0) - 1
        ng = int(gid[-1]) + 1 if len(gid) else 0
        grp_pos = torch.zeros(ng, dtype=torch.float64,
                              device=s.device).index_add_(0, gid, pos_w)
        grp_neg = torch.zeros(ng, dtype=torch.float64,
                              device=s.device).index_add_(0, gid, neg_w)
        before = torch.cumsum(grp_neg, 0) - grp_neg
        auc_sum = torch.sum(grp_pos * (before + 0.5 * grp_neg))
        tp, tn = float(pos_w.sum()), float(neg_w.sum())
        if tp == 0.0 or tn == 0.0:
            return 1.0
        return float(auc_sum) / (tp * tn)


_METRICS = {
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "auc": AUCMetric,
}

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
