"""Carry the JAX package's state across to the port, as numpy arrays.

- ``stacked_from_numpy``: a JAX ``StackedModel``'s host arrays -> the
  forest kernel's ``Forest`` and the device-binning tensors;
- ``dataset_from_numpy``: a JAX ``TpuDataset``'s bins, mapper fields and
  index maps -> the port's ``BinnedDataset``;
- ``tree_record_from_numpy``: a JAX ``TreeRecord`` -> the port's.

Both packages then score, grow and train from the same inputs. Model
text (models/gbdt.py) is the other carrier.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .io.binning import BinMapper
from .io.dataset import BinnedDataset, Metadata
from .ops.forest import Forest
from .ops.grower import TreeRecord
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


def mapper_from_dict(d: Mapping) -> BinMapper:
    """A BinMapper from the JAX mapper's ``to_dict()``."""
    m = BinMapper()
    for k in ("num_bin", "missing_type", "bin_type", "is_trivial",
              "sparse_rate", "min_val", "max_val", "default_bin"):
        setattr(m, k, d[k])
    m.bin_upper_bound = np.asarray(d["bin_upper_bound"], np.float64)
    m.bin_2_categorical = [int(c) for c in d["bin_2_categorical"]]
    m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
    return m


def dataset_from_numpy(bins: np.ndarray, mappers: Sequence[Mapping],
                       used_feature_map: Sequence[int],
                       num_total_features: int, config, label=None,
                       weight=None, feature_names=None,
                       device=None) -> BinnedDataset:
    """A BinnedDataset on ``device`` (None: cuda:0) from a JAX
    TpuDataset's host bins [N, F] (``host_bins()``), its used mappers'
    ``to_dict()``, ``used_feature_map`` and ``num_total_features``."""
    ds = BinnedDataset(config, device)
    ds.num_data = bins.shape[0]
    ds.num_total_features = int(num_total_features)
    ds.mappers = [mapper_from_dict(d) for d in mappers]
    ds.used_feature_map = np.asarray(used_feature_map, np.int32)
    ds.real_to_inner = {int(r): i for i, r in enumerate(ds.used_feature_map)}
    ds.max_bin_global = max((m.num_bin for m in ds.mappers), default=1)
    ds.metadata = Metadata(label=label, weight=weight)
    ds.feature_names = (list(feature_names) if feature_names else
                        [f"Column_{i}" for i in range(ds.num_total_features)])
    ds.bins_t = torch.from_numpy(np.ascontiguousarray(bins.T)).to(
        ds.bin_dtype()).to(ds.device)
    return ds


def tree_record_from_numpy(rec: Mapping, device=None) -> TreeRecord:
    """The port's TreeRecord from a JAX TreeRecord's fields as numpy."""
    dev = resolve_device(device)
    fields = {}
    for k in TreeRecord._fields:
        v = np.asarray(rec[k])
        fields[k] = (int(v) if k == "num_leaves"
                     else torch.from_numpy(np.array(v)).to(dev))
    return TreeRecord(**fields)
