"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

This slice loads LightGBM v2 model text and scores rows on an NVIDIA
GPU: ``Booster(model_file=...).predict(X)`` and the ``capi`` scoring
calls. Entry points run on ``cuda:0`` unless given ``device="cpu"``.
"""
from .basic import Booster
from .utils.log import LightGBMError

__all__ = ["Booster", "LightGBMError"]
