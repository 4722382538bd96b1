"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

It trains GBDT, GOSS, DART and random-forest models with every objective
of the JAX package (``train(params, Dataset(X, label=y),
valid_sets=[...], init_model=...)``, ``cv`` and the C-API calls in
``capi``), with valid sets, evaluation, early stopping, forced splits and
continued training, writes and loads LightGBM v2 model text, and scores
rows (``Booster(model_file=...).predict(X)``) on an NVIDIA GPU. The
scikit-learn estimators (``LGBMRegressor``, ``LGBMClassifier``,
``LGBMRanker``) are exported where scikit-learn is installed; the
plotting functions run on the host and import matplotlib when called.
Entry points run on ``cuda:0`` unless given ``device="cpu"``.
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

# plotting imports matplotlib lazily inside each function, so the
# module itself always imports
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_tree)
_PLOT_EXPORTS = ["create_tree_digraph", "plot_importance", "plot_metric",
                 "plot_tree"]

__all__ = ["Booster", "CVBooster", "Dataset", "EarlyStopException",
           "LightGBMError", "cv", "early_stopping", "print_evaluation",
           "record_evaluation", "reset_parameter",
           "train"] + _SKLEARN_EXPORTS + _PLOT_EXPORTS
