"""Carry the JAX package's stacked tables across to the port.

``stacked_from_numpy`` takes the host arrays of a JAX ``StackedModel``
(as numpy) and each of its trees' node arrays, and returns the port's
device tables: the forest kernel's ``Forest`` and, for an all-numerical
model, the device-binning tensors. Both packages then score from the
same tables. Model text (models/gbdt.py) is the other carrier.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from .ops.forest import Forest
from .ops.stacked_predict import edge_tensors, walk_tables
from .utils.device import resolve_device


def stacked_from_numpy(arrays: Mapping, device=None
                       ) -> Tuple[Forest, Optional[Tuple[torch.Tensor, ...]]]:
    """``arrays`` holds the JAX StackedModel's ``_W_host``, ``_P_host``,
    ``_tgt_host``, ``_leaf_host``, ``_offsets``, ``_rep_sizes``,
    ``num_class`` and, when it bins on the device, ``_E_f32``,
    ``_off32`` and ``_nan_slot``; plus ``split_feature``,
    ``left_child`` and ``right_child``: one sequence per tree. Returns
    (Forest, (E, off32, nan_slot) or None) on ``device`` (None:
    cuda:0). The ancestor matrix and targets are not needed by the walk,
    which reaches the leaf they select."""
    dev = resolve_device(device)
    forest = walk_tables(
        arrays["_W_host"], arrays["_leaf_host"], arrays["_offsets"],
        arrays["_rep_sizes"], arrays["split_feature"],
        arrays["left_child"], arrays["right_child"],
        num_class=int(arrays["num_class"]), device=dev)
    edges = None
    if arrays.get("_E_f32") is not None:
        edges = edge_tensors(arrays["_E_f32"], arrays["_off32"],
                             arrays["_nan_slot"], dev)
    return forest, edges
