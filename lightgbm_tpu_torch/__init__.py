"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

It trains GBDT, GOSS, DART and random-forest models with every objective
of the JAX package (``train(params, Dataset(X, label=y),
valid_sets=[...], init_model=...)``, ``cv`` and the C-API calls in
``capi``), with valid sets, evaluation, early stopping, forced splits and
continued training, writes and loads LightGBM v2 model text, and scores
rows (``Booster(model_file=...).predict(X)``) on an NVIDIA GPU. The
scikit-learn estimators (``LGBMRegressor``, ``LGBMClassifier``,
``LGBMRanker``) are exported where scikit-learn is installed. Entry
points run on ``cuda:0`` unless given ``device="cpu"``.
"""
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .engine import CVBooster, cv, train
from .utils.log import LightGBMError

try:
    from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
    _SKLEARN_EXPORTS = ["LGBMModel", "LGBMRegressor", "LGBMClassifier",
                        "LGBMRanker"]
except ImportError:          # scikit-learn is not installed
    _SKLEARN_EXPORTS = []

__all__ = ["Booster", "CVBooster", "Dataset", "EarlyStopException",
           "LightGBMError", "cv", "early_stopping", "print_evaluation",
           "record_evaluation", "reset_parameter",
           "train"] + _SKLEARN_EXPORTS
