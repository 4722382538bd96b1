"""Leaf output renewal for the L1 family (regression_l1, quantile, mape).

The JAX package's ``ops/renew.py`` (reference RenewTreeOutput,
serial_tree_learner.cpp:780-818, with PercentileFun and
WeightedPercentileFun, regression_objective.hpp:11-60): each leaf's
output becomes the (weighted) alpha-percentile of the residuals of its
rows. PyTorch ops on the residuals' device, no readback:

- one stable sort by (leaf, residual): the residuals are ordered by
  their f32 total order (-0.0 before +0.0, NaN last), as ``lax.sort``
  compares them, and rows of equal residual keep their row order, as its
  stable sort keeps them; rows of weight 0 (out of the bag) sort after
  every leaf;
- per-leaf counts and starts, so each leaf is a sorted segment;
- unweighted: the reference's linear interpolation from the top of the
  segment; weighted: the first row whose weighted CDF passes
  ``alpha * total``, interpolated between it and the row before. The
  CDF and the total are each leaf's masked prefix sums and sum in XLA's
  CPU order of addition (ops/f32math.py), so the outputs are the JAX
  package's bits on the CPU and on the card alike.

Leaves without rows keep their current output.
"""
from __future__ import annotations

from typing import Optional

import torch

from .f32math import fma, xla_segment_cumsum, xla_segment_sum


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """int64 keys that order f32 values as ``lax.sort`` compares them:
    -inf < ... < 0 < ... < inf < NaN, with -0.0 equal to +0.0 and every
    NaN equal."""
    v = torch.where(v == 0.0, 0.0, v)
    v = torch.where(torch.isnan(v), float("nan"), v)
    i = v.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF) - 1, i)


def renew_leaf_outputs(leaf_ids: torch.Tensor, residual: torch.Tensor,
                       weights: Optional[torch.Tensor], num_leaves: int,
                       alpha: float, cur_outputs: torch.Tensor,
                       sample_mask: Optional[torch.Tensor] = None,
                       sum_length: int = 0) -> torch.Tensor:
    """[L] f32: ``cur_outputs`` with each leaf that has rows of nonzero
    weight given the alpha-percentile of its residuals. ``leaf_ids``
    [N] int, ``residual`` [N] f32, ``weights`` [N] f32 or None
    (unweighted), ``sample_mask`` [N] 0/1 (bagging; weight 0 rows take no
    part). ``sum_length`` (>= N): the weighted totals add in the order of
    a sum over that many rows, the last of them weight 0 (the JAX
    package's padded score width)."""
    dev = residual.device
    n = residual.shape[0]
    f32 = torch.float32
    L = int(num_leaves)
    res = residual.to(f32)
    weighted = weights is not None
    w = weights.to(f32) if weighted else torch.ones(n, dtype=f32, device=dev)
    if sample_mask is not None:
        w = w * sample_mask.to(f32)
    dead = w <= 0.0
    key = torch.where(dead, L, leaf_ids.to(torch.int64))
    # lexicographic by (key, residual), stable: sort by the minor key,
    # then stably by the major one
    o1 = torch.sort(_order_key(res), stable=True).indices
    o2 = torch.sort(key[o1], stable=True).indices
    order = o1[o2]
    sorted_res = res[order]
    counts = torch.bincount(key, minlength=L + 1)[:L]
    starts = torch.cumsum(counts, 0) - counts
    cur = cur_outputs[:L].to(f32)

    def val_at(i):
        return sorted_res[(starts + i).clamp(0, n - 1)]

    cnt_f = counts.to(f32)
    if not weighted:
        fp = float(torch.tensor(1.0 - alpha, dtype=f32)) * cnt_f
        pos = torch.floor(fp).to(torch.int64)
        bias = fp - pos.to(f32)
        vmax = val_at(counts - 1)
        vmin = val_at(torch.zeros_like(counts))
        v1 = val_at(counts - pos)
        v2 = val_at(counts - pos - 1)
        # XLA contracts v1 - (v1 - v2) * bias into one fused multiply-add
        mid = fma(-(v1 - v2), bias, v1)
        out = torch.where(pos < 1, vmax, torch.where(pos >= counts, vmin,
                                                     mid))
    else:
        sorted_w = w[order]
        # each sorted row's leaf; the dead rows, past the last leaf, form
        # a segment of their own that nothing reads
        seg_of = key[order]
        seg_start = torch.cat([starts, starts.new_tensor([n])])[seg_of]
        cdf = xla_segment_cumsum(sorted_w, seg_start)
        total = xla_segment_sum(sorted_w, starts, counts, sum_length)
        alpha32 = float(torch.tensor(alpha, dtype=f32))
        thr = alpha32 * total
        idx = torch.arange(n, device=dev)
        live = seg_of < L
        above = live & (cdf > thr[seg_of.clamp(max=L - 1)])
        first = torch.full((L,), n, dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, seg_of.clamp(max=L - 1)[above],
                                     idx[above], "amin")
        pos = torch.where(first < n, first, starts + counts - 1)
        i = pos - starts
        v1 = val_at(i - 1)
        v2 = val_at(i)
        # the masked CDF is 0 before the segment
        c1 = torch.where(pos - 1 >= starts, cdf[(pos - 1).clamp(0, n - 1)],
                         0.0)
        c2 = cdf[pos.clamp(0, n - 1)]
        # XLA contracts alpha * total - c1 and v1 + t * (v2 - v1) into
        # fused multiply-adds
        t = torch.where(c2 > c1, fma(alpha32, total, -c1) / (c2 - c1), 0.0)
        out = torch.where(i <= 0, v2, fma(t, v2 - v1, v1))
    new = torch.where(counts > 0, out, cur)
    full = cur_outputs.clone()
    full[:L] = new
    return full
