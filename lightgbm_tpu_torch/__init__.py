"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

It trains binary GBDT models (``train(params, Dataset(X, label=y),
valid_sets=[...])``, ``cv`` and the C-API calls in ``capi``) with valid
sets, evaluation and early stopping, writes and loads LightGBM v2 model
text, and scores rows (``Booster(model_file=...).predict(X)``) on an
NVIDIA GPU. Entry points run on ``cuda:0`` unless given
``device="cpu"``.
"""
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .engine import CVBooster, cv, train
from .utils.log import LightGBMError

__all__ = ["Booster", "CVBooster", "Dataset", "EarlyStopException",
           "LightGBMError", "cv", "early_stopping", "print_evaluation",
           "record_evaluation", "reset_parameter", "train"]
