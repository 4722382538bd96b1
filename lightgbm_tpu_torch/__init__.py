"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

It trains binary GBDT models (``train(params, Dataset(X, label=y))`` and
the C-API calls in ``capi``), writes and loads LightGBM v2 model text,
and scores rows (``Booster(model_file=...).predict(X)``) on an NVIDIA
GPU. Entry points run on ``cuda:0`` unless given ``device="cpu"``.
"""
from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

__all__ = ["Booster", "Dataset", "LightGBMError", "train"]
