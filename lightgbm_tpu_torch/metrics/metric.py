"""Evaluation metrics.

Counterparts of every metric of the JAX package's ``metrics/metric.py``
``_METRICS`` table (reference src/metric/*.hpp: regression, binary,
multiclass, cross-entropy, NDCG and MAP at ``eval_at``), of its
``create_metrics`` and ``default_metric_for_objective``, and of the
metric-name resolution of its ``basic.py`` (``_resolve_metric_names``;
config.cpp GetMetricType). Each metric evaluates on the device that
holds the scores: ``eval_tensor`` gives its values, a float64 tensor
there, with no readback (the scores never travel to the host); ``eval``
reads them. The arithmetic is float64, as the reference's, and so is
the output transform of the objective (``convert_output``); the JAX
package's host route converts in f32, so a value agrees with it to the
f32 rounding of the converted scores, and exactly where no conversion
applies. Ranking metrics (NDCG, MAP) pad the queries to the longest and
rank each by a stable sort of its scores, on the device.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import log

_EPS = 1e-15


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
        self.query_boundaries = getattr(metadata, "query_boundaries", None)
        self.num_data = num_data
        self.sum_weights = (float(num_data) if self.weights is None
                            else float(np.sum(self.weights)))
        self._dev = {}

    def names(self) -> List[str]:
        """The names of the values ``eval_tensor`` gives, in order."""
        return [self.name]

    def _on(self, dev, key, make):
        """A float64 tensor on ``dev`` made once from the host arrays."""
        if (dev, key) not in self._dev:
            arr = make()
            self._dev[(dev, key)] = (None if arr is None else
                                     torch.from_numpy(np.ascontiguousarray(
                                         arr)).to(dev))
        return self._dev[(dev, key)]

    def _y(self, dev):
        return self._on(dev, "y", lambda: self.label)

    def _w(self, dev):
        return self._on(dev, "w", lambda: self.weights)

    def eval_tensor(self, scores: torch.Tensor,
                    objective) -> torch.Tensor:
        """The value(s), float64 on the scores' device, of ``scores``
        [K, N] raw scores: a scalar, or one value a name for metrics of
        several names."""
        raise NotImplementedError

    def eval(self, scores: torch.Tensor, objective):
        """``scores`` [K, N] raw scores on any device: the value, or the
        list of values of a metric of several names."""
        v = self.eval_tensor(scores, objective)
        return float(v) if v.dim() == 0 else v.tolist()

    def _average(self, loss: torch.Tensor, w) -> torch.Tensor:
        """The (weighted) mean of float64 per-row losses."""
        if w is None:
            return loss.mean()
        return (loss * w).sum() / self.sum_weights

    @staticmethod
    def _convert(s: torch.Tensor, objective) -> torch.Tensor:
        """float64 converted scores (the objective's transform), as the
        reference's Metric::Eval receives them."""
        s = s.to(torch.float64)
        return s if objective is None else objective.convert_output(s)


# -- regression family (regression_metric.hpp) --------------------------------

class _PointwiseMetric(Metric):
    """The (weighted) mean of a per-row loss of the label and the
    converted score of class 0."""

    def loss(self, y, s):
        raise NotImplementedError

    def eval_tensor(self, scores, objective):
        dev = scores.device
        s = self._convert(scores[0], objective)
        return self._average(self.loss(self._y(dev), s), self._w(dev))


class L2Metric(_PointwiseMetric):
    name = "l2"

    def loss(self, y, s):
        return (y - s) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval_tensor(self, scores, objective):
        return torch.sqrt(super().eval_tensor(scores, objective))


class L1Metric(_PointwiseMetric):
    name = "l1"

    def loss(self, y, s):
        return (y - s).abs()


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def loss(self, y, s):
        a = self.config.alpha
        d = y - s
        return torch.where(d >= 0, a * d, (a - 1.0) * d)


class HuberLossMetric(_PointwiseMetric):
    name = "huber"

    def loss(self, y, s):
        a = self.config.alpha
        d = (s - y).abs()
        return torch.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairLossMetric(_PointwiseMetric):
    name = "fair"

    def loss(self, y, s):
        c = self.config.fair_c
        x = (s - y).abs()
        return c * x - c * c * torch.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def loss(self, y, s):
        s = s.clamp(min=1e-10)
        return s - y * torch.log(s)


class MAPEMetric(_PointwiseMetric):
    name = "mape"

    def loss(self, y, s):
        return ((y - s) / y.abs().clamp(min=1.0)).abs()


class GammaMetric(_PointwiseMetric):
    name = "gamma"

    def loss(self, y, s):
        psi = 1.0
        theta = -1.0 / s.clamp(min=1e-10)
        b = -torch.log(-theta)
        c = (1.0 / psi * torch.log(y / psi) - torch.log(y)
             - math.lgamma(1.0 / psi))
        return -((y * theta - b) / psi + c)


class GammaDevianceMetric(Metric):
    """Twice the summed deviance (not a mean, as the reference)."""
    name = "gamma_deviance"

    def eval_tensor(self, scores, objective):
        s = self._convert(scores[0], objective)
        frac = self._y(scores.device) / s.clamp(min=1e-10)
        loss = -torch.log(frac.clamp(min=1e-10)) + frac - 1.0
        return 2.0 * loss.sum()


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def loss(self, y, s):
        rho = self.config.tweedie_variance_power
        s = s.clamp(min=1e-10)
        a = y * torch.pow(s, 1.0 - rho) / (1.0 - rho)
        b = torch.pow(s, 2.0 - rho) / (2.0 - rho)
        return -a + b


# -- binary (binary_metric.hpp) -----------------------------------------------

def _is(objective, *names) -> bool:
    return objective is not None and getattr(objective, "name", "") in names


class BinaryLoglossMetric(Metric):
    """binary_metric.hpp: mean logloss. For the binary objective from the
    raw scores through softplus (no probability clipping), as the JAX
    package evaluates it; else from the converted scores, clipped to
    [1e-15, 1 - 1e-15]."""
    name = "binary_logloss"

    def eval_tensor(self, scores, objective):
        dev = scores.device
        y = (self._y(dev) > 0).to(torch.float64)
        w = self._w(dev)
        if _is(objective, "binary"):
            sa = float(objective.sigmoid) * scores[0].to(torch.float64)
            zero = torch.zeros((), dtype=torch.float64, device=dev)
            loss = (y * torch.logaddexp(zero, -sa)
                    + (1.0 - y) * torch.logaddexp(zero, sa))
            return self._average(loss, w)
        p = self._convert(scores[0], objective).clamp(_EPS, 1.0 - _EPS)
        loss = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
        return self._average(loss, w)


class BinaryErrorMetric(Metric):
    """binary_metric.hpp BinaryErrorMetric: the share of rows whose
    converted score (f32, as the JAX device path converts it) is on the
    wrong side of 0.5."""
    name = "binary_error"

    def eval_tensor(self, scores, objective):
        dev = scores.device
        p = scores[0]
        if objective is not None:
            p = objective.convert_output(p)
        wrong = (p > 0.5) != (self._y(dev) > 0)
        return self._average(wrong.to(torch.float64), self._w(dev))


class AUCMetric(Metric):
    """AUC (binary_metric.hpp:266-400): the weighted rank statistic,
    with tied scores sharing their average rank."""
    name = "auc"
    bigger_is_better = True

    def eval_tensor(self, scores, objective):
        dev = scores.device
        y = (self._y(dev) > 0).to(torch.float64)
        w = self._w(dev)
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
                              device=dev).index_add_(0, gid, pos_w)
        grp_neg = torch.zeros(n, dtype=torch.float64,
                              device=dev).index_add_(0, gid, neg_w)
        before = torch.cumsum(grp_neg, 0) - grp_neg
        auc_sum = torch.sum(grp_pos * (before + 0.5 * grp_neg))
        tp, tn = pos_w.sum(), neg_w.sum()
        one = torch.ones((), dtype=torch.float64, device=dev)
        return torch.where((tp == 0.0) | (tn == 0.0), one,
                           auc_sum / (tp * tn))


# -- multiclass (multiclass_metric.hpp) ---------------------------------------

class MultiLoglossMetric(Metric):
    """Mean of -log p(label). For the softmax objective from the raw
    scores (logsumexp(s) - s_y, no clipping), as the JAX package; else
    from the converted scores, clipped below at 1e-15."""
    name = "multi_logloss"

    def eval_tensor(self, scores, objective):
        dev = scores.device
        yi = self._on(dev, "yi", lambda: self.label.astype(np.int64))
        w = self._w(dev)
        cols = torch.arange(scores.shape[1], device=dev)
        if _is(objective, "multiclass"):
            s = scores.to(torch.float64)
            mx = s.max(dim=0).values
            lse = mx + torch.log(torch.exp(s - mx).sum(dim=0))
            return self._average(lse - s[yi, cols], w)
        p = self._convert(scores, objective)
        return self._average(-torch.log(p[yi, cols].clamp(min=_EPS)), w)


class MultiErrorMetric(Metric):
    """The share of rows whose largest converted score is not their
    label's."""
    name = "multi_error"

    def eval_tensor(self, scores, objective):
        dev = scores.device
        yi = self._on(dev, "yi", lambda: self.label.astype(np.int64))
        pred = torch.argmax(self._convert(scores, objective), dim=0)
        return self._average((pred != yi).to(torch.float64), self._w(dev))


# -- cross entropy (xentropy_metric.hpp) --------------------------------------

class CrossEntropyMetric(Metric):
    name = "cross_entropy"

    def eval_tensor(self, scores, objective):
        dev = scores.device
        p = self._convert(scores[0], objective).clamp(_EPS, 1.0 - _EPS)
        y = self._y(dev)
        loss = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
        return self._average(loss, self._w(dev))


class CrossEntropyLambdaMetric(Metric):
    """The intensity-weighted cross entropy of the raw scores; an
    unweighted mean, as the reference."""
    name = "cross_entropy_lambda"

    def eval_tensor(self, scores, objective):
        dev = scores.device
        s = scores[0].to(torch.float64)
        hhat = torch.log1p(torch.exp(s))
        w = self._w(dev)
        p = 1.0 - torch.exp(-(1.0 if w is None else w) * hhat)
        p = p.clamp(_EPS, 1.0 - _EPS)
        y = self._y(dev)
        return (-(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))).mean()


class KLDivergenceMetric(Metric):
    name = "kldiv"

    def eval_tensor(self, scores, objective):
        dev = scores.device
        s = scores[0].to(torch.float64)
        p = (1.0 / (1.0 + torch.exp(-s))).clamp(_EPS, 1.0 - _EPS)
        y = self._y(dev).clamp(_EPS, 1.0 - _EPS)
        kl = (y * torch.log(y / p)
              + (1.0 - y) * torch.log((1.0 - y) / (1.0 - p)))
        return self._average(kl, self._w(dev))


# -- ranking (rank_metric.hpp, map_metric.hpp) --------------------------------

class _QueryMetric(Metric):
    """A per-query metric at each cut of ``eval_at``, averaged over the
    queries. The rows of each query are gathered into a [Q, qmax] table
    (padding past a query's end), ordered by score, descending and
    stable, as the reference's sort."""
    bigger_is_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            log.fatal(f"{self.name.upper()} metric requires query "
                      f"information")
        self.eval_at = list(self.config.eval_at) or [1, 2, 3, 4, 5]
        qb = np.asarray(self.query_boundaries, np.int64)
        counts = np.diff(qb)
        self._qmax = int(counts.max()) if len(counts) else 1
        col = np.arange(self._qmax)
        self._valid = col[None, :] < counts[:, None]
        self._idx = np.where(self._valid, qb[:-1, None] + col[None, :], 0)
        self._counts = counts

    def names(self):
        return [f"{self.name}@{k}" for k in (list(self.config.eval_at)
                                             or [1, 2, 3, 4, 5])]

    def _ranked(self, scores):
        """(labels [Q, qmax] f64 in rank order, valid [Q, qmax] in rank
        order, counts [Q] int64) on the scores' device."""
        dev = scores.device
        idx = self._on(dev, "idx", lambda: self._idx)
        valid = self._on(dev, "valid", lambda: self._valid)
        s = scores[0].to(torch.float64)[idx]
        key = torch.where(valid, -s, float("inf"))
        order = torch.sort(key, dim=1, stable=True).indices
        lab = torch.gather(self._y(dev)[idx], 1, order)
        return lab, torch.gather(valid, 1, order), self._on(
            dev, "counts", lambda: self._counts)

    def eval_tensor(self, scores, objective):
        lab, valid, counts = self._ranked(scores)
        per_query = self.per_query(lab, valid, counts)          # [Q, k]
        return per_query.mean(dim=0)


class NDCGMetric(_QueryMetric):
    name = "ndcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        label_gain = self.config.label_gain
        if not label_gain:
            label_gain = [float(2 ** i - 1) for i in range(31)]
        self.label_gain = np.asarray(label_gain, np.float64)

    def per_query(self, lab, valid, counts):
        dev = lab.device
        gain_t = self._on(dev, "gain", lambda: self.label_gain)
        gains = torch.where(valid, gain_t[lab.clamp(min=0).to(torch.int64)],
                            0.0)
        ideal = torch.sort(gains, dim=1, descending=True).values
        m = lab.shape[1]
        disc = 1.0 / torch.log2(torch.arange(m, dtype=torch.float64,
                                             device=dev) + 2.0)
        dcg = torch.cumsum(gains * disc, dim=1)
        maxdcg = torch.cumsum(ideal * disc, dim=1)
        out = []
        for k in self.eval_at:
            kk = (torch.clamp(counts, max=k) - 1).clamp(min=0)[:, None]
            d = torch.gather(dcg, 1, kk)[:, 0]
            md = torch.gather(maxdcg, 1, kk)[:, 0]
            out.append(torch.where(md <= 0, 1.0, d / torch.where(
                md <= 0, 1.0, md)))
        return torch.stack(out, dim=1)


class MapMetric(_QueryMetric):
    name = "map"

    def per_query(self, lab, valid, counts):
        dev = lab.device
        rel = ((lab > 0) & valid).to(torch.float64)
        hits = torch.cumsum(rel, dim=1)
        ranks = torch.arange(1, lab.shape[1] + 1, dtype=torch.float64,
                             device=dev)
        ap_sum = torch.cumsum(hits / ranks * rel, dim=1)
        out = []
        for k in self.eval_at:
            kk = (torch.clamp(counts, max=k) - 1).clamp(min=0)[:, None]
            num_rel = torch.gather(hits, 1, kk)[:, 0]
            s = torch.gather(ap_sum, 1, kk)[:, 0]
            out.append(torch.where(num_rel > 0, s / num_rel.clamp(min=1.0),
                                   0.0))
        return torch.stack(out, dim=1)


# -- factory (metric.cpp:11-55) -----------------------------------------------

_METRICS = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "l2_root": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "rmse": RMSEMetric,
    "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
    "regression_l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberLossMetric,
    "fair": FairLossMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multiclass_ova": MultiLoglossMetric, "ova": MultiLoglossMetric,
    "ovr": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "xentlambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivergenceMetric, "kldiv": KLDivergenceMetric,
}

# an objective's metric when none is configured (config.cpp
# GetMetricType; the JAX package's basic.py _DEFAULT_METRIC)
_DEFAULT_METRIC = {
    "regression": "l2", "regression_l2": "l2", "mean_squared_error": "l2",
    "l2_root": "rmse", "rmse": "rmse",
    "regression_l1": "l1", "mean_absolute_error": "l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape", "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "softmax": "multi_logloss",
    "multiclassova": "multi_logloss", "ova": "multi_logloss",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "ndcg",
}


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


def default_metric_for_objective(objective_name: str) -> str:
    """Config::GetMetricType's fallback: the metric named as the
    objective (metric.py:633)."""
    return objective_name


def create_metric(name: str, config) -> Optional[Metric]:
    """The metric of ``name`` (``ndcg@1,3`` and ``map@5`` set
    ``config.eval_at``); None for none/custom, and for an unknown name,
    with a warning, as the JAX package."""
    n = name.strip().lower()
    if n in ("", "none", "null", "na", "custom"):
        return None
    if n.startswith("ndcg@") or n.startswith("map@"):
        base, at = n.split("@", 1)
        config.eval_at = [int(x) for x in at.split(",")]
        n = base
    if n not in _METRICS:
        log.warning("Unknown metric %s", name)
        return None
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
