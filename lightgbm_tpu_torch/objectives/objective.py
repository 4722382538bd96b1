"""Objective functions: gradients, initial scores, output transforms.

Counterparts of the JAX package's ``objectives/objective.py`` (reference
src/objective/*.hpp): every objective of its ``_OBJECTIVES`` table, with
``init`` on the metadata, ``get_gradients`` as f32 tensor code on the
scores' device, ``boost_from_score``, ``is_renew_tree_output`` and
``renew_tree_output_percentile`` (leaf renewal, ops/renew.py),
``is_constant_hessian``, ``num_model_per_iteration``, ``convert_output``
(raw score -> prediction on class-major [K, N] tensors, in the dtype it
is given: the port gives it float64, as the reference does) and
``to_string`` (the model file's ``objective=`` line).

Gradients take the scores as the JAX package's training step gives them:
[N] for one model an iteration, [K, N] for the multiclass objectives.
They follow the roundings of its jitted step on the CPU: exp is XLA's
(ops/f32math.py), ``a * b + c`` is contracted into one fused
multiply-add where XLA contracts it, and softmax is written out
elementwise (max, exp of the differences, their sum class by class), so
a column's probabilities do not depend on where it sits in the batch.
Lambdarank's pairs are computed query by query in chunks of queries of
similar length under a byte cap (``LAMBDARANK_CHUNK_BYTES``); queries
are independent and every per-query sum adds in one fixed order, so the
chunking changes no bit.
"""
from __future__ import annotations

import copy
import math
from typing import List, Optional

import numpy as np
import torch

from ..ops import f32math
from ..ops.f32math import fma
from ..utils import log

# the pair tensors of one lambdarank chunk (ten f32 or bool [q, m, m]
# planes) stay under this many bytes
LAMBDARANK_CHUNK_BYTES = 1 << 30
_PAIR_PLANE_BYTES = 10 * 4
_LOG2E_F32 = float(np.float32(1.0 / math.log(2.0)))


def _f32(x: float) -> float:
    """A Python scalar rounded to f32, as XLA takes a weak-typed scalar
    in f32 arithmetic."""
    return float(np.float32(x))


class ObjectiveFunction:
    """Base interface (include/LightGBM/objective_function.h:20-80)."""

    name = "base"
    is_constant_hessian = False
    need_query = False

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        """Read the training labels and weights."""
        self.label = np.asarray(metadata.label, np.float32)
        self.weights = (None if metadata.weights is None
                        else np.asarray(metadata.weights, np.float32))
        self.num_data = num_data
        self._dev = {}

    def rows(self, lo: int, hi: int) -> "ObjectiveFunction":
        """This objective on rows [lo, hi) of its training set (a rank's
        block under the data and voting learners): a copy whose per-row
        arrays, [N] or [K, N], are sliced on their row axis; what
        ``init`` drew from every row (class weights, averages) stays
        global. An objective with query groups needs every row."""
        if self.need_query:
            raise ValueError(f"{self.name} reads whole queries; it takes "
                             "no row block")
        N = self.num_data
        view = copy.copy(self)
        for name, v in vars(self).items():
            if isinstance(v, np.ndarray) and v.ndim and v.shape[-1] == N:
                setattr(view, name, v[..., lo:hi])
        view._dev = {}
        view.num_data = hi - lo
        return view

    def _on(self, dev: torch.device, **arrays) -> List[torch.Tensor]:
        """The named host arrays as tensors on ``dev`` (None stays None),
        copied once per device."""
        out = []
        for name, arr in arrays.items():
            key = (dev, name)
            if key not in self._dev:
                self._dev[key] = (None if arr is None
                                  else torch.from_numpy(
                                      np.ascontiguousarray(arr)).to(dev))
            out.append(self._dev[key])
        return out

    def get_gradients(self, score: torch.Tensor):
        """(g, h) f32 on score's device, shaped as ``score``."""
        raise NotImplementedError

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def is_renew_tree_output(self) -> bool:
        return False

    def renew_tree_output_percentile(self) -> float:
        raise NotImplementedError

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw score -> output transform (identity by default)."""
        return raw

    def to_string(self) -> str:
        return self.name


def _wmul(x, w):
    return x if w is None else x * w


# -- regression family (regression_objective.hpp) -----------------------------

class RegressionL2Loss(ObjectiveFunction):
    """L2 (regression_objective.hpp:96-108): g = s - y, h = 1.

    ``is_constant_hessian`` is True for every objective of the family
    trained without weights, as the JAX package sets it in this ``init``
    (its subclasses inherit it): it selects the exact tier's widest wave,
    40 splits (``hilo3``). The port's histogram passes keep the hessian
    and count channels apart, so the flag only sets the wave width."""
    name = "regression"
    is_constant_hessian = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.config.reg_sqrt:
            self.trans_label = (np.sign(self.label)
                                * np.sqrt(np.abs(self.label)))
        else:
            self.trans_label = self.label
        self.is_constant_hessian = self.weights is None

    def _yw(self, dev):
        return self._on(dev, y=self.trans_label, w=self.weights)

    def get_gradients(self, score):
        y, w = self._yw(score.device)
        g = _wmul(score - y, w)
        return g, (torch.ones_like(score) if w is None else w)

    def boost_from_score(self, class_id):
        # the weighted mean label (regression_objective.hpp:142-160)
        if self.weights is None:
            return float(np.mean(self.trans_label))
        return float(np.sum(self.trans_label * self.weights)
                     / np.sum(self.weights))

    def convert_output(self, raw):
        if self.config.reg_sqrt:
            return torch.sign(raw) * raw * raw
        return raw


class RegressionL1Loss(RegressionL2Loss):
    """L1 (regression_objective.hpp:185-199): g = sign(s - y), h = 1;
    leaf outputs renewed to the residual median (hpp:219-258)."""
    name = "regression_l1"

    def get_gradients(self, score):
        y, w = self._yw(score.device)
        g = _wmul(torch.sign(score - y), w)
        return g, (torch.ones_like(score) if w is None else w)

    def boost_from_score(self, class_id):
        return _weighted_percentile(self.trans_label, self.weights, 0.5)

    def is_renew_tree_output(self):
        return True

    def renew_tree_output_percentile(self):
        return 0.5


class RegressionHuberLoss(RegressionL2Loss):
    """Huber (regression_objective.hpp:281-303)."""
    name = "huber"

    def get_gradients(self, score):
        y, w = self._yw(score.device)
        a = _f32(self.config.alpha)
        diff = score - y
        g = torch.where(diff.abs() <= a, diff, torch.sign(diff) * a)
        return _wmul(g, w), (torch.ones_like(score) if w is None else w)


class RegressionFairLoss(RegressionL2Loss):
    """Fair (regression_objective.hpp:335-349)."""
    name = "fair"

    def get_gradients(self, score):
        y, w = self._yw(score.device)
        c = float(self.config.fair_c)
        x = score - y
        d = x.abs() + _f32(c)
        g = (_f32(c) * x) / d
        # c * c is a Python product, rounded to f32 once
        h = _f32(c * c) / (d * d)
        return _wmul(g, w), _wmul(h, w)


class RegressionPoissonLoss(RegressionL2Loss):
    """Poisson (regression_objective.hpp:414-426): the score is the log
    of the mean."""
    name = "poisson"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if np.any(self.label < 0):
            log.fatal("[poisson]: at least one target label is negative")

    def _yw(self, dev):
        return self._on(dev, y_raw=self.label, w=self.weights)

    def get_gradients(self, score):
        y, w = self._yw(score.device)
        mds = _f32(self.config.poisson_max_delta_step)
        g = f32math.exp(score) - y
        h = f32math.exp(score + mds)
        return _wmul(g, w), _wmul(h, w)

    def boost_from_score(self, class_id):
        return math.log(max(RegressionL2Loss.boost_from_score(self, class_id),
                            1e-20))

    def convert_output(self, raw):
        return torch.exp(raw)


class RegressionQuantileLoss(RegressionL2Loss):
    """Quantile (regression_objective.hpp:465-487)."""
    name = "quantile"

    def _yw(self, dev):
        return self._on(dev, y_raw=self.label, w=self.weights)

    def get_gradients(self, score):
        y, w = self._yw(score.device)
        a = float(self.config.alpha)
        g = torch.where(score > y, _f32(1.0 - a), _f32(-a))
        return _wmul(g, w), (torch.ones_like(score) if w is None else w)

    def boost_from_score(self, class_id):
        return _weighted_percentile(self.label, self.weights,
                                    self.config.alpha)

    def is_renew_tree_output(self):
        return True

    def renew_tree_output_percentile(self):
        return self.config.alpha


class RegressionMAPELoss(RegressionL2Loss):
    """MAPE (regression_objective.hpp:560-620)."""
    name = "mape"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.label_weight = 1.0 / np.maximum(1.0, np.abs(self.label))
        if self.weights is not None:
            self.label_weight = self.label_weight * self.weights

    def get_gradients(self, score):
        y, lw, w = self._on(score.device, y_raw=self.label,
                            lw=self.label_weight, w=self.weights)
        g = torch.sign(score - y) * lw
        return g, (torch.ones_like(score) if w is None else w)

    def boost_from_score(self, class_id):
        return _weighted_percentile(self.label, self.label_weight, 0.5)

    def is_renew_tree_output(self):
        return True

    def renew_tree_output_percentile(self):
        return 0.5


class RegressionGammaLoss(RegressionPoissonLoss):
    """Gamma (regression_objective.hpp:663-675)."""
    name = "gamma"

    def get_gradients(self, score):
        y, w = self._yw(score.device)
        # XLA rewrites y / exp(s) as y * exp(-s), and in the training
        # step contracts 1 - that into one fused multiply-add
        e = f32math.exp(-score)
        return _wmul(fma(-y, e, 1.0), w), _wmul(y * e, w)


class RegressionTweedieLoss(RegressionPoissonLoss):
    """Tweedie (regression_objective.hpp:701-722)."""
    name = "tweedie"

    def get_gradients(self, score):
        y, w = self._yw(score.device)
        rho = float(self.config.tweedie_variance_power)
        a, b = _f32(1.0 - rho), _f32(2.0 - rho)
        e1 = f32math.exp(a * score)
        e2 = f32math.exp(b * score)
        # XLA contracts -y * e1 + e2 into one fused multiply-add, and of
        # -y * a * e1 + b * e2 the first product
        g = fma(-y, e1, e2)
        h = fma((-y) * a, e1, b * e2)
        return _wmul(g, w), _wmul(h, w)


# -- binary (binary_objective.hpp) --------------------------------------------

class BinaryLogloss(ObjectiveFunction):
    """binary_objective.hpp:17-160."""
    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid

    def init(self, metadata, num_data):
        """Labels to +-1 and class weights (binary_objective.hpp:40-90)."""
        super().init(metadata, num_data)
        is_pos = self.label > 0
        cnt_pos = int(is_pos.sum())
        cnt_neg = int(num_data - cnt_pos)
        w_pos, w_neg = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.config.scale_pos_weight
        self.label_val = np.where(is_pos, 1.0, -1.0).astype(np.float32)
        self.label_weight = np.where(is_pos, w_pos, w_neg).astype(np.float32)
        if self.weights is not None:
            self.label_weight = self.label_weight * self.weights
        self.sigmoid = self.config.sigmoid
        if cnt_pos == 0 or cnt_neg == 0:
            log.warning("Contains only one class")

    def get_gradients(self, score):
        """(g, h) f32 on score's device (binary_objective.hpp:92-120)."""
        lv, lw = self._on(score.device, lv=self.label_val,
                          lw=self.label_weight)
        return _logistic_grads(score, lv, lw, float(np.float32(self.sigmoid)))

    def boost_from_score(self, class_id):
        """binary_objective.hpp:124-142: log-odds of the label mean."""
        if self.weights is not None:
            suml = float(np.sum((self.label > 0) * self.weights))
            sumw = float(np.sum(self.weights))
        else:
            suml = float(np.sum(self.label > 0))
            sumw = float(self.num_data)
        pavg = min(max(suml / max(sumw, 1e-15), 1e-15), 1.0 - 1e-15)
        return math.log(pavg / (1.0 - pavg)) / self.sigmoid

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def to_string(self):
        return f"binary sigmoid:{self.sigmoid:g}"


def _logistic_grads(score, lv, lw, sig: float):
    """The logistic loss's (g, h) on labels +-1 ``lv`` with weights
    ``lw`` (binary_objective.hpp:92-120), exp as XLA's."""
    response = -lv * sig / (1.0 + f32math.exp(lv * sig * score))
    ar = torch.abs(response)
    return response * lw, ar * (sig - ar) * lw


# -- multiclass (multiclass_objective.hpp) ------------------------------------

def _softmax_columns(raw: torch.Tensor, exp) -> torch.Tensor:
    """Softmax over the classes (dim 0) of each column: the max, ``exp``
    of the differences, their sum class by class, the quotients
    (Common::Softmax, jax.nn.softmax). Elementwise, so a column's values
    do not depend on its place in the batch (``torch.softmax`` over dim
    0 on the CPU rounds a column by its position, its vector body and
    tail differing in the last bit)."""
    e = exp(raw - raw.max(dim=0).values)
    total = e[0].clone()
    for k in range(1, e.shape[0]):
        total += e[k]
    return e / total


class MulticlassSoftmax(ObjectiveFunction):
    """multiclass_objective.hpp:16-160."""
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.num_class = self.config.num_class
        self.label_int = self.label.astype(np.int32)
        if np.any((self.label_int < 0) | (self.label_int >= self.num_class)):
            log.fatal("Label must be in [0, num_class)")

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def get_gradients(self, score):
        """[K, N] scores -> (g, h) [K, N] (multiclass_objective.hpp:68)."""
        yi, w = self._on(score.device, yi=self.label_int.astype(np.int64),
                         w=self.weights)
        K = score.shape[0]
        onehot = (torch.arange(K, device=score.device)[:, None]
                  == yi[None, :]).to(torch.float32)
        p = _softmax_columns(score, f32math.exp)
        g = p - onehot
        h = 2.0 * p * (1.0 - p)
        if w is not None:
            g, h = g * w[None, :], h * w[None, :]
        return g, h

    def convert_output(self, raw):
        return _softmax_columns(raw, torch.exp)

    def to_string(self):
        return f"multiclass num_class:{self.num_class}"


class _LabelsOnly:
    """The metadata of one class's binary problem."""

    def __init__(self, label, weights):
        self.label = label
        self.weights = weights


class MulticlassOVA(ObjectiveFunction):
    """One-vs-all (multiclass_objective.hpp:167-220): K independent
    binary objectives."""
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.num_class = self.config.num_class
        self.binary = []
        for k in range(self.num_class):
            b = BinaryLogloss(self.config)
            b.init(_LabelsOnly((self.label == k).astype(np.float32),
                               self.weights), num_data)
            self.binary.append(b)
        self.label_val = np.stack([b.label_val for b in self.binary])
        self.label_weight = np.stack([b.label_weight for b in self.binary])

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def get_gradients(self, score):
        """[K, N] scores: the K binary objectives, elementwise."""
        lv, lw = self._on(score.device, lv=self.label_val,
                          lw=self.label_weight)
        return _logistic_grads(score, lv, lw,
                               float(np.float32(self.config.sigmoid)))

    def boost_from_score(self, class_id):
        return self.binary[class_id].boost_from_score(0)

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid * raw))

    def to_string(self):
        return (f"multiclassova num_class:{self.num_class} "
                f"sigmoid:{self.config.sigmoid:g}")


# -- cross entropy (xentropy_objective.hpp) -----------------------------------

def _logistic(score):
    return 1.0 / (1.0 + f32math.exp(-score))


class CrossEntropy(ObjectiveFunction):
    """xentropy (hpp:77-86): labels in [0, 1]; z = sigmoid(s)."""
    name = "cross_entropy"

    def get_gradients(self, score):
        y, w = self._on(score.device, y=self.label, w=self.weights)
        z = _logistic(score)
        return _wmul(z - y, w), _wmul(z * (1.0 - z), w)

    def boost_from_score(self, class_id):
        # xentropy_objective.hpp:107-118: log(pavg / (1 - pavg))
        if self.weights is not None:
            pavg = float(np.sum(self.label * self.weights)
                         / np.sum(self.weights))
        else:
            pavg = float(np.mean(self.label))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        return math.log(pavg / (1.0 - pavg))

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-raw))


class CrossEntropyLambda(ObjectiveFunction):
    """xentlambda (hpp:150-240): intensity-weighted cross entropy; with
    unit weights its gradients are cross entropy's (hpp:184-189)."""
    name = "cross_entropy_lambda"

    def get_gradients(self, score):
        y, w = self._on(score.device, y=self.label, w=self.weights)
        if w is None:
            z = _logistic(score)
            return z - y, z * (1.0 - z)
        # xentropy_objective.hpp:192-206, in the form XLA compiles it: 1 /
        # exp(s) is exp(-s), c / (d * d) with c = 1 / (1 - z) is
        # 1 / ((1 - z) * (c - 1)^2), and 1 + y * b a fused multiply-add
        epf = f32math.exp(score)
        z = 1.0 - f32math.exp(-w * f32math.log1p(epf))
        g = ((1.0 - y / z) * w) / (1.0 + f32math.exp(-score))
        d = epf + 1.0
        a = (w * epf) / (d * d)
        c = 1.0 / (1.0 - z)
        b = (1.0 / ((1.0 - z) * ((c - 1.0) * (c - 1.0)))) * (w * epf + 1.0
                                                            - c)
        return g, a * fma(y, b, 1.0)

    def boost_from_score(self, class_id):
        pavg = float(np.mean(self.label))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        return math.log(pavg / (1.0 - pavg))

    def convert_output(self, raw):
        return torch.log1p(torch.exp(raw))


# -- lambdarank (rank_objective.hpp) ------------------------------------------

class LambdarankNDCG(ObjectiveFunction):
    """LambdaRank NDCG (rank_objective.hpp:19-240): pairwise lambdas
    inside each query, the reference's sigmoid computed exactly (its
    lookup table is a CPU speed device)."""
    name = "lambdarank"
    need_query = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("Lambdarank tasks require query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries,
                                           np.int64)
        self.sigmoid = self.config.sigmoid
        self.optimize_pos_at = self.config.max_position
        label_gain = self.config.label_gain
        if not label_gain:
            label_gain = [float(2 ** i - 1) for i in range(31)]
        self.label_gain = np.asarray(label_gain, np.float64)
        lab = self.label.astype(np.int32)
        if lab.max() >= len(self.label_gain):
            log.fatal("Label exceeds label_gain size")
        qb = self.query_boundaries
        counts = np.diff(qb)
        self.qmax = int(counts.max())
        # inverse max DCG at max_position per query (rank_objective.hpp:
        # 55-68), in float64 on the host as the JAX package computes it
        nq = len(counts)
        imd = np.zeros(nq, np.float64)
        for q in range(nq):
            top = np.sort(lab[qb[q]:qb[q + 1]])[::-1][:self.optimize_pos_at]
            dcg = np.sum(self.label_gain[top]
                         / np.log2(np.arange(len(top)) + 2.0))
            imd[q] = 1.0 / dcg if dcg > 0 else 0.0
        self.inv_max_dcg = imd.astype(np.float32)
        self.chunks = lambdarank_chunks(counts, LAMBDARANK_CHUNK_BYTES)

    def get_gradients(self, score):
        dev = score.device
        y, w, gain, imd, qb = self._on(
            dev, y=self.label.astype(np.int64), w=self.weights,
            gain=self.label_gain.astype(np.float32), imd=self.inv_max_dcg,
            qb=self.query_boundaries)
        lam, hes = lambdarank_grads(score, y, qb, imd, gain,
                                    float(self.sigmoid), self.qmax,
                                    self.chunks)
        if w is not None:
            lam, hes = lam * w, hes * w
        return lam, hes


def lambdarank_chunks(counts: np.ndarray, max_bytes: int) -> list:
    """Chunks of queries for ``lambdarank_grads``: (query indices, padded
    width) with the queries sorted by length, each chunk's width its
    longest query rounded up to a multiple of 32 (at most the longest
    query of all), and as many queries as keep
    ``_PAIR_PLANE_BYTES * q * width**2`` under ``max_bytes`` (at least
    one)."""
    counts = np.asarray(counts, np.int64)
    qmax = int(counts.max())
    order = np.argsort(counts, kind="stable")
    out = []
    i = 0
    while i < len(order):
        j = i
        width = 1
        while j < len(order):
            wj = min(-(-int(counts[order[j]]) // 32) * 32, qmax)
            if j > i and _PAIR_PLANE_BYTES * (j - i + 1) * wj * wj > max_bytes:
                break
            width = max(width, wj)
            j += 1
        out.append((order[i:j], width))
        i = j
    return out


def lambdarank_grads(score, labels, qb, inv_max_dcg, label_gain,
                     sigmoid: float, qmax: int, chunks: list):
    """(lambdas, hessians) [N] f32 of the padded pairwise computation
    (rank_objective.hpp:81-166; the JAX package's ``_lambdarank_grads``)
    chunk by chunk. Per query: rank positions by score (descending,
    stable), the discounts 1 / log2(rank + 2), the pairs (i, j) with
    label i > label j, and each document's sum over its pairs. The sums
    over a query's pairs add in XLA's CPU order over the JAX package's
    padded width ``qmax`` (f32math.xla_sum), whatever the chunk's width."""
    dev = score.device
    n = score.shape[0]
    lam = torch.zeros(n, dtype=torch.float32, device=dev)
    hes = torch.zeros(n, dtype=torch.float32, device=dev)
    for queries, m in chunks:
        qs = torch.from_numpy(np.asarray(queries, np.int64)).to(dev)
        start = qb[qs]
        cnt = qb[qs + 1] - start
        col = torch.arange(m, device=dev)
        valid = col[None, :] < cnt[:, None]
        idx = torch.where(valid, start[:, None] + col[None, :], 0)
        li, hi = _one_chunk(score, labels, idx, valid, inv_max_dcg[qs],
                            label_gain, sigmoid, qmax)
        lam[idx[valid]] = li[valid]
        hes[idx[valid]] = hi[valid]
    return lam, hes


def _one_chunk(score, labels, idx, valid, imd, label_gain, sigmoid, qmax):
    """[q, m] lambdas and hessians of one chunk of padded queries. The
    pair terms are computed for the pairs (label i > label j) only, then
    placed in [q, m, m] planes of zeros for the sums over each row and
    each column."""
    f32 = torch.float32
    s = torch.where(valid, score[idx], float("-inf"))
    lab = torch.where(valid, labels[idx], -1)
    q, m = s.shape
    order = torch.argsort(-s, dim=1, stable=True)
    rank_of = torch.empty_like(order)
    rank_of.scatter_(1, order, torch.arange(m, device=s.device)
                     .expand(q, m).contiguous())
    # XLA's log2 is its log times f32(1 / ln 2)
    discount = 1.0 / (f32math.log(rank_of.to(f32) + 2.0) * _LOG2E_F32)
    best = torch.where(valid, s, float("-inf")).max(dim=1).values
    worst = torch.where(valid, s, float("inf")).min(dim=1).values
    gain = label_gain[lab.clamp(min=0)]
    pair_ok = ((lab[:, :, None] > lab[:, None, :])
               & valid[:, :, None] & valid[:, None, :])
    qi, i, j = pair_ok.nonzero(as_tuple=True)
    ds = s[qi, i] - s[qi, j]
    delta = ((gain[qi, i] - gain[qi, j])
             * (discount[qi, i] - discount[qi, j]).abs() * imd[qi])
    delta = torch.where(best[qi] != worst[qi], delta / (0.01 + ds.abs()),
                        delta)
    p_lambda = 2.0 / (1.0 + f32math.exp(2.0 * ds * _f32(sigmoid)))
    p_hess = p_lambda * (2.0 - p_lambda)
    planes = []
    for v in (-p_lambda * delta, 2.0 * p_hess * delta):
        plane = torch.zeros((q, m, m), dtype=f32, device=s.device)
        plane[qi, i, j] = v
        planes.append(plane)
    pl, ph = planes
    lam = (f32math.xla_vec_sum(pl, qmax)
           - f32math.xla_vec_sum(pl.transpose(1, 2), qmax))
    hes = (f32math.xla_vec_sum(ph, qmax)
           + f32math.xla_vec_sum(ph.transpose(1, 2), qmax))
    return lam, hes


# -- factory (objective_function.cpp:10-46) -----------------------------------

_OBJECTIVES = {
    "regression": RegressionL2Loss,
    "regression_l2": RegressionL2Loss,
    "l2": RegressionL2Loss,
    "mean_squared_error": RegressionL2Loss,
    "mse": RegressionL2Loss,
    "l2_root": RegressionL2Loss,
    "root_mean_squared_error": RegressionL2Loss,
    "rmse": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "l1": RegressionL1Loss,
    "mean_absolute_error": RegressionL1Loss,
    "mae": RegressionL1Loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "quantile": RegressionQuantileLoss,
    "mape": RegressionMAPELoss,
    "mean_absolute_percentage_error": RegressionMAPELoss,
    "gamma": RegressionGammaLoss,
    "tweedie": RegressionTweedieLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "softmax": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "multiclass_ova": MulticlassOVA,
    "ova": MulticlassOVA,
    "ovr": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "xentropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "xentlambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}


def create_objective(name: str, config) -> Optional[ObjectiveFunction]:
    """objective_function.cpp:10-46; None for a custom objective."""
    name = name.strip().lower()
    if name in ("none", "null", "custom", "na", ""):
        return None
    # l2_root/rmse use sqrt transform
    if name in ("l2_root", "root_mean_squared_error", "rmse"):
        config.reg_sqrt = True
    if name not in _OBJECTIVES:
        log.fatal(f"Unknown objective type name: {name}")
    return _OBJECTIVES[name](config)


def parse_objective_from_model_string(s: str, config):
    """Recreate an objective from its model-file string, e.g.
    'binary sigmoid:1' or 'multiclass num_class:3'
    (objective_function.cpp:49-84)."""
    parts = s.strip().split()
    if not parts:
        return None
    name = parts[0]
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            if k == "num_class":
                config.num_class = int(v)
            elif k == "sigmoid":
                config.sigmoid = float(v)
    return create_objective(name, config)


def _weighted_percentile(values, weights, alpha):
    """PercentileFun / WeightedPercentileFun (regression_objective.hpp:
    23-60), in float64 on the host: the JAX package's
    ``_weighted_percentile``."""
    values = np.asarray(values, np.float64)
    if len(values) == 0:
        return 0.0
    if weights is None:
        sorted_v = np.sort(values)
        pos = alpha * len(values)
        k = int(np.ceil(pos)) - 1
        k = min(max(k, 0), len(values) - 1)
        if np.ceil(pos) == pos and k + 1 < len(values):
            return float((sorted_v[k] + sorted_v[k + 1]) / 2.0)
        return float(sorted_v[k])
    order = np.argsort(values)
    sv, sw = values[order], np.asarray(weights, np.float64)[order]
    cum = np.cumsum(sw) - sw * (1.0 - alpha)
    thresh = alpha * np.sum(sw)
    k = int(np.searchsorted(cum, thresh, side="left"))
    k = min(max(k, 0), len(values) - 1)
    return float(sv[k])
