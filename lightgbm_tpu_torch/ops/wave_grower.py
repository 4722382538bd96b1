"""Wave-batched leaf-wise tree grower (serial learner, exact f32 tier).

The JAX package's ``ops/wave_grower.py`` ``make_wave_grower`` (:224)
with its default seams and the fused route (:761-780); reference
SerialTreeLearner::Train (serial_tree_learner.cpp:157-221). Each wave
splits the top-W leaves by gain at once: one fused pass (K1,
ops/hist_wave.py) moves their rows to the new leaves and builds the W
smaller-child histograms; the siblings come from parent - smaller
subtraction out of a per-leaf histogram pool. The root histogram is one
K2 pass.

Leaf numbering matches Tree::Split: the left child keeps the parent's
index, the right child takes the next free index, assigned within a
wave in gain-rank order, so split i's right child is leaf i + 1.

JAX runs the waves in a ``lax.while_loop`` on the device. Here the loop
is Python: each wave reads its number of active splits back to the host
once, which both ends the loop and sizes the next launches. Capturing
the loop in a CUDA graph is left for later.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .grower import TreeRecord
from .hist_wave import fused_partition_histogram, wave_histogram
from .split import (KMIN_SCORE, FeatureMeta, SplitParams, _f32,
                    calculate_leaf_output, find_best_split)


class WaveGrowerConfig(NamedTuple):
    num_leaves: int
    num_bins: int            # histogram width B
    wave_size: int = 16
    max_depth: int = -1
    hp: SplitParams = SplitParams()


_SUM_BLOCK = 8192
_WINDOW = 32


def _window_sums(x: torch.Tensor) -> torch.Tensor:
    """[..., k * 32] -> [..., k]: each run of 32 added in sequence."""
    x = x.reshape(*x.shape[:-1], -1, _WINDOW)
    acc = x[..., 0]
    for j in range(1, _WINDOW):
        acc = acc + x[..., j]
    return acc


def _stable_sum(v: torch.Tensor) -> torch.Tensor:
    """The JAX package's shape-stable f32 row sum (wave_grower.py:169):
    8192-row blocks (zero-padded) summed each, then the block sums added
    in sequence, so zero padding cannot change the result. Within a
    block the order is XLA's on the CPU, which rewrites a long reduction
    into a tree of sequential 32-element windows (8192 -> 256 -> 8 -> 1):
    the port adds in that order too, so the two agree bit for bit. The
    block sums are added in sequence on the host."""
    n = v.shape[0]
    pad = (-n) % _SUM_BLOCK
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    part = _window_sums(_window_sums(v.reshape(-1, _SUM_BLOCK)))   # [k, 8]
    bs = part[:, 0]
    for j in range(1, part.shape[1]):
        bs = bs + part[:, j]
    total = np.add.accumulate(bs.cpu().numpy(), dtype=np.float32)[-1]
    return torch.tensor(total, dtype=torch.float32, device=v.device)


class WaveGrower:
    """Grows one tree per ``grow`` call from bins [F, N] on one device."""

    def __init__(self, cfg: WaveGrowerConfig, meta: FeatureMeta, device):
        self.cfg = cfg
        self.L = cfg.num_leaves
        self.W = min(cfg.wave_size, max(self.L - 1, 1))
        self.meta = meta.to(device)
        self.device = device

    def _depth_ok(self, depth: torch.Tensor) -> torch.Tensor:
        if self.cfg.max_depth > 0:
            return depth < self.cfg.max_depth
        return torch.ones_like(depth, dtype=torch.bool)

    def grow(self, bins_t: torch.Tensor, grad: torch.Tensor,
             hess: torch.Tensor, sample_mask: torch.Tensor,
             feature_mask: torch.Tensor):
        """One tree. bins_t [F, N]; grad, hess, sample_mask [N] f32
        (mask 0/1 from bagging); feature_mask [F] bool. Returns
        (TreeRecord, leaf ids [N] int32 of every row, out-of-bag rows
        included, for the score update)."""
        cfg, meta, L, W = self.cfg, self.meta, self.L, self.W
        hp = cfg.hp
        B = cfg.num_bins
        dev = bins_t.device
        F, n = bins_t.shape
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        l1, l2, mds = _f32(hp.lambda_l1), _f32(hp.lambda_l2), \
            float(hp.max_delta_step)
        grad = grad.to(f32) * sample_mask
        hess = hess.to(f32) * sample_mask
        in_bag = sample_mask > 0

        # root: one K2 pass over the in-bag rows (out-of-bag rows read
        # as leaf -1). The JAX package passes W slots with only slot 0
        # active; the other slots' histograms are zeros never read.
        leaf_ids = torch.zeros(n, dtype=i32, device=dev)
        root_hist = wave_histogram(
            bins_t, grad, hess, torch.where(in_bag, leaf_ids, -1),
            torch.zeros(1, dtype=i32, device=dev), B)
        root_g = _stable_sum(grad)
        root_h = _stable_sum(hess)
        root_c = sample_mask.sum()
        res = find_best_split(root_hist, root_g[None], root_h[None],
                              root_c[None], feature_mask, meta, hp,
                              self._depth_ok(torch.zeros(1, dtype=i32,
                                                         device=dev)))

        def table(fill, dtype, first):
            t = torch.full((L,), fill, dtype=dtype, device=dev)
            t[0] = first[0]
            return t

        pool = torch.zeros((L, F, B, 3), dtype=f32, device=dev)
        pool[0] = root_hist[0]
        t = {name: table(fill, dtype, getattr(res, name))
             for name, fill, dtype in (
                 ("gain", KMIN_SCORE, f32), ("feature", 0, i32),
                 ("threshold_bin", 0, i32), ("default_left", False,
                                             torch.bool),
                 ("left_output", 0.0, f32), ("right_output", 0.0, f32),
                 ("left_count", 0.0, f32), ("right_count", 0.0, f32),
                 ("left_sum_g", 0.0, f32), ("left_sum_h", 0.0, f32),
                 ("right_sum_g", 0.0, f32), ("right_sum_h", 0.0, f32))}
        leaf_output = torch.zeros(L, dtype=f32, device=dev)
        leaf_count = table(0.0, f32, root_c[None])
        leaf_sum_g = table(0.0, f32, root_g[None])
        leaf_sum_h = table(0.0, f32, root_h[None])
        leaf_depth = torch.zeros(L, dtype=i32, device=dev)
        rec = dict(
            split_leaf=torch.full((L - 1,), -1, dtype=i32, device=dev),
            split_feature=torch.full((L - 1,), -1, dtype=i32, device=dev),
            split_bin=torch.zeros(L - 1, dtype=i32, device=dev),
            split_gain=torch.zeros(L - 1, dtype=f32, device=dev),
            split_default_left=torch.zeros(L - 1, dtype=torch.bool,
                                           device=dev),
            internal_value=torch.zeros(L - 1, dtype=f32, device=dev),
            internal_count=torch.zeros(L - 1, dtype=f32, device=dev))
        num_leaves = 1

        while num_leaves < L:
            # 1. elect the wave: the top-W leaves by gain (ties to the
            # lower leaf id, as lax.top_k), capped by the leaf budget.
            # Gains sort descending, so the active slots are a prefix.
            order = torch.sort(t["gain"], descending=True,
                               stable=True).indices[:W]
            top_gain = t["gain"][order]
            rank = torch.arange(order.shape[0], device=dev)
            active = (top_gain > 0.0) & (rank < L - num_leaves)
            k = int(active.sum())             # the one readback per wave
            if k == 0:
                break
            wl = order[:k]
            new_ids = torch.arange(num_leaves, num_leaves + k, device=dev)

            # 2. per-slot split parameters
            feat = t["feature"][wl].to(i64)
            lcnt, rcnt = t["left_count"][wl], t["right_count"][wl]
            lg, lh = t["left_sum_g"][wl], t["left_sum_h"][wl]
            rg, rh = t["right_sum_g"][wl], t["right_sum_h"][wl]
            lo, ro = t["left_output"][wl], t["right_output"][wl]
            dleft = t["default_left"][wl]

            # 3+4. partition and smaller-child histograms in one K1
            # call; siblings by subtraction from the parents' histograms
            left_smaller = lcnt <= rcnt
            small_ids = torch.where(left_smaller, wl, new_ids)
            tbl = torch.stack([x.to(i32) for x in (
                wl, new_ids, feat, t["threshold_bin"][wl], dleft,
                meta.missing_type[feat], meta.default_bin[feat],
                meta.num_bin[feat], small_ids)])      # TBL_* rows
            leaf_ids, hist_small = fused_partition_histogram(
                bins_t, grad, hess, sample_mask, leaf_ids, tbl, B)
            hist_large = pool[wl] - hist_small
            ls4 = left_smaller[:, None, None, None]
            hist_left = torch.where(ls4, hist_small, hist_large)
            hist_right = torch.where(ls4, hist_large, hist_small)
            pool[wl] = hist_left
            pool[new_ids] = hist_right

            # 5. record the wave's splits after the num_leaves - 1 so far
            pos = slice(num_leaves - 1, num_leaves - 1 + k)
            rec["split_leaf"][pos] = wl.to(i32)
            rec["split_feature"][pos] = feat.to(i32)
            rec["split_bin"][pos] = t["threshold_bin"][wl]
            rec["split_gain"][pos] = top_gain[:k]
            rec["split_default_left"][pos] = dleft
            rec["internal_value"][pos] = calculate_leaf_output(
                leaf_sum_g[wl], leaf_sum_h[wl], l1, l2, mds)
            rec["internal_count"][pos] = leaf_count[wl]

            # 6. per-leaf aggregates (the left child keeps the parent id)
            child_depth = leaf_depth[wl] + 1
            for arr, lv, rv in ((leaf_output, lo, ro),
                                (leaf_count, lcnt, rcnt),
                                (leaf_sum_g, lg, rg), (leaf_sum_h, lh, rh),
                                (leaf_depth, child_depth, child_depth)):
                arr[wl] = lv
                arr[new_ids] = rv

            # 7. best splits of the 2k children
            can = self._depth_ok(child_depth)
            res = find_best_split(
                torch.cat([hist_left, hist_right]), torch.cat([lg, rg]),
                torch.cat([lh, rh]), torch.cat([lcnt, rcnt]), feature_mask,
                meta, hp, torch.cat([can, can]))
            idx2 = torch.cat([wl, new_ids])
            for name in t:
                v = getattr(res, name)
                if name == "gain":
                    v = torch.where(torch.isfinite(v), v, KMIN_SCORE)
                t[name][idx2] = v.to(t[name].dtype)
            num_leaves += k

        record = TreeRecord(num_leaves=num_leaves, leaf_output=leaf_output,
                            leaf_count=leaf_count, leaf_sum_g=leaf_sum_g,
                            leaf_sum_h=leaf_sum_h, **rec)
        return record, leaf_ids
