"""Leaf outputs of an existing tree re-learned on new data (refit).

The JAX package's ``refit_one`` (models/gbdt.py:2263-2268; reference
FitByExistingTree, serial_tree_learner.cpp:223-253): each leaf's sums of
g and h over its rows, its output ``-ThresholdL1(sum_g) / (sum_h + l2)``
(clipped by max_delta_step) times the tree's shrinkage, blended with the
old output as ``decay * old + (1 - decay) * new``.

The sums are where the two devices part. The JAX package's
``zeros(L).at[leaf].add(g)`` is an XLA scatter, which on the CPU adds the
rows to their leaves serially in row order (``sum_h`` starts from
KEPSILON). For CPU tensors ``leaf_sums`` does exactly that (PyTorch's CPU
``index_add_`` of a 1-D tensor is the same serial loop in f32), so the
plain path gives the JAX package's bits. On the card a scatter-add with
atomics adds in an order that changes from run to run; here the rows are
stably sorted by leaf and each leaf's segment summed in XLA's CPU order
of a reduction (``ops/f32math.py xla_segment_sum``: windows of 32), with
elementwise ops only, so every run gives the same bits, and those sums
differ from the serial ones only by the f32 rounding of two orders of
addition: ``sum_bound`` bounds it.
"""
from __future__ import annotations

import numpy as np
import torch

from .f32math import fma, xla_segment_sum
from .split import KEPSILON, calculate_leaf_output

F32_UNIT = 2.0 ** -24       # f32 unit roundoff


def leaf_sums(leaf_ids: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
              num_leaves: int) -> tuple:
    """(sum_g [L], KEPSILON + sum_h [L]) f32 of the rows of each leaf;
    ``leaf_ids`` [N] in [0, L), ``g`` and ``h`` [N] f32 on the same
    device. Serial in row order on the CPU; sorted segments on the
    card."""
    if g.device.type != "cpu":
        return sorted_leaf_sums(leaf_ids, g, h, num_leaves)
    L = int(num_leaves)
    f32 = torch.float32
    leaf = leaf_ids.to(torch.int64)
    eps = float(np.float32(KEPSILON))
    sg = torch.zeros(L, dtype=f32).index_add_(0, leaf, g.to(f32))
    sh = torch.full((L,), eps, dtype=f32).index_add_(0, leaf, h.to(f32))
    return sg, sh


def sorted_leaf_sums(leaf_ids: torch.Tensor, g: torch.Tensor,
                     h: torch.Tensor, num_leaves: int) -> tuple:
    """The card's ``leaf_sums`` on any device: the rows stably sorted by
    leaf, each leaf's segment summed in XLA's order of a reduction, then
    KEPSILON added to sum_h."""
    L = int(num_leaves)
    leaf = leaf_ids.to(torch.int64)
    order = torch.sort(leaf, stable=True).indices
    counts = torch.bincount(leaf, minlength=L)[:L]
    starts = torch.cumsum(counts, 0) - counts
    sg = xla_segment_sum(g.to(torch.float32)[order], starts, counts)
    sh = xla_segment_sum(h.to(torch.float32)[order], starts, counts)
    return sg, sh + float(np.float32(KEPSILON))


def refit_leaf_outputs(leaf_ids: torch.Tensor, g: torch.Tensor,
                       h: torch.Tensor, old: torch.Tensor, l1: float,
                       l2: float, max_delta_step: float, shrink: float,
                       decay: float) -> torch.Tensor:
    """[L] f32: ``decay * old + (1 - decay) * new`` with ``new`` each
    leaf's output on the rows' g and h, times ``shrink``, rounded as XLA
    compiles the JAX package's jitted blend on the CPU (the constants are
    f32, JAX's weakly typed scalars): the first product and the sum
    contract into one fused multiply-add, ``fma(decay, old, (1 - decay)
    * new)``; where the two constants are equal (decay 0.5) XLA first
    factors them out, ``(old + out * shrink) * 0.5``, and the shrinkage's
    product and that sum contract instead."""
    f32 = torch.float32
    sg, sh = leaf_sums(leaf_ids, g, h, old.shape[0])
    out = calculate_leaf_output(sg, sh, l1, l2, max_delta_step)
    shrink = float(np.float32(shrink))
    keep = float(np.float32(decay))
    rest = float(np.float32(1.0 - decay))
    old = old.to(f32)
    if keep == rest:
        return fma(out, shrink, old) * keep
    return fma(keep, old, rest * (out * shrink))


def sum_bound(n: np.ndarray, abs_sum: np.ndarray) -> np.ndarray:
    """Per leaf, a bound on the difference of two f32 sums of the same
    ``n`` values whose absolute values sum to ``abs_sum``, added in any
    two orders: each is within gamma(n) * abs_sum of the exact sum
    (Higham, Accuracy and Stability, 4.2), gamma(n) = n u / (1 - n u)
    with one more term for the start value."""
    m = np.asarray(n, np.float64) + 1.0
    gamma = m * F32_UNIT / (1.0 - m * F32_UNIT)
    return 2.0 * gamma * np.asarray(abs_sum, np.float64)
