"""Objective functions: the output transforms and model-text names.

Counterparts of the reference objectives (src/objective/*.hpp) for what a
loaded model needs: ``convert_output`` (raw score -> prediction, on
class-major [K, N] tensors like the reference's ConvertOutput) and
``to_string`` (the model file's ``objective=`` line). Gradients come with
the training slice. The transforms run in the dtype they are given; the
port gives them float64, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import log


class ObjectiveFunction:
    """Base interface (include/LightGBM/objective_function.h:20-80)."""

    name = "base"

    def __init__(self, config):
        self.config = config

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
