"""Objective functions: output transforms, model-text names, gradients.

Counterparts of the reference objectives (src/objective/*.hpp):
``convert_output`` (raw score -> prediction, on class-major [K, N]
tensors like the reference's ConvertOutput), ``to_string`` (the model
file's ``objective=`` line) and, for binary logloss, the training half:
``init`` on the labels, ``get_gradients`` and ``boost_from_score``. The
transforms run in the dtype they are given; the port gives them float64,
as the reference does. Gradients are f32 tensor code on the scores'
device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils import log


class ObjectiveFunction:
    """Base interface (include/LightGBM/objective_function.h:20-80)."""

    name = "base"

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        """Read the training labels; objectives without a training half
        raise."""
        raise NotImplementedError(
            f"training with objective {self.name!r} is not ported to "
            f"lightgbm_tpu_torch yet")

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw score -> output transform (identity by default)."""
        return raw

    def to_string(self) -> str:
        return self.name


class RegressionL2Loss(ObjectiveFunction):
    """L2 (regression_objective.hpp:96-108)."""
    name = "regression"

    def convert_output(self, raw):
        if self.config.reg_sqrt:
            return torch.sign(raw) * raw * raw
        return raw


class RegressionL1Loss(RegressionL2Loss):
    """L1 (regression_objective.hpp:185-199)."""
    name = "regression_l1"


class BinaryLogloss(ObjectiveFunction):
    """binary_objective.hpp:17-160."""
    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid

    def init(self, metadata, num_data: int) -> None:
        """Labels to +-1 and class weights (binary_objective.hpp:40-90)."""
        self.label = np.asarray(metadata.label, np.float32)
        self.weights = (None if metadata.weights is None
                        else np.asarray(metadata.weights, np.float32))
        self.num_data = num_data
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
        self._dev = {}
        if cnt_pos == 0 or cnt_neg == 0:
            log.warning("Contains only one class")

    def get_gradients(self, score: torch.Tensor):
        """(g, h) [N] f32 on score's device (binary_objective.hpp:92-120)."""
        dev = score.device
        if dev not in self._dev:
            self._dev[dev] = (torch.from_numpy(self.label_val).to(dev),
                              torch.from_numpy(self.label_weight).to(dev))
        lv, lw = self._dev[dev]
        sig = float(np.float32(self.sigmoid))
        response = -lv * sig / (1.0 + torch.exp(lv * sig * score))
        ar = torch.abs(response)
        return response * lw, ar * (sig - ar) * lw

    def boost_from_score(self, class_id: int) -> float:
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


class MulticlassSoftmax(ObjectiveFunction):
    """multiclass_objective.hpp:16-160."""
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class

    def convert_output(self, raw):
        return torch.softmax(raw, dim=0)

    def to_string(self):
        return f"multiclass num_class:{self.num_class}"


class LambdarankNDCG(ObjectiveFunction):
    """rank_objective.hpp: scores are used as they are."""
    name = "lambdarank"


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
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "softmax": MulticlassSoftmax,
    "lambdarank": LambdarankNDCG,
}


def create_objective(name: str, config) -> Optional[ObjectiveFunction]:
    """objective_function.cpp:10-46, for the objectives ported so far."""
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
