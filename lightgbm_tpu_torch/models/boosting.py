"""Boosting variants: GOSS, DART and RF (the JAX package's
``models/boosting.py``; reference src/boosting/goss.hpp, dart.hpp, rf.hpp,
the factory boosting.cpp:57-83).

- GOSS overrides the base class's sample hook (``GBDT._sample``): after
  the gradients, it keeps the rows of the largest ``Σ_k |g h|`` and a
  hashed draw of the rest, and amplifies the drawn rows' g and h. The
  draw is the JAX package's default, shard-invariant sampler
  (``_hash_hook``): the lowbias32 hash of (row index, key ^ 0x27D4EB2F)
  with a key drawn once an iteration from ``bagging_seed``, so the same
  rows are kept on the card, on the CPU and in the JAX package. The
  counts are f32 products, as the JAX package computes them in its step.
  ``tpu_goss_hash=0`` takes the JAX package's legacy sampler instead
  (``legacy_goss_sample``): the k-th largest score as the threshold and
  ``jax.random.uniform``'s threefry2x32 draw (ops/threefry.py), kept as
  its repro oracle; it runs without the step cache, as there.
- DART subtracts the dropped trees (replayed, K3 at shrink -1), trains
  on the lowered shrinkage and rescales the dropped trees' records and
  scores (dart.hpp:86-190).
- RF grows each tree on fixed targets (g = -label or -one-hot, h = 1)
  under bagging, keeps the scores a running mean of the trees' outputs
  and writes ``average_output`` (rf.hpp:18-172).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import threefry
from ..ops.f32math import fma
from ..ops.predict import add_leaf_outputs
from ..ops.quantize import hash_uniform
from ..ops.renew import renew_leaf_outputs
from ..utils import log
from .gbdt import GBDT

# the hashed GOSS draw's salt: the key also salts the int8 tiers'
# rounding streams (key and key ^ 0x9E3779B9), so GOSS xors a third
# constant (the JAX package's boosting.py:50-54)
GOSS_SALT = 0x27D4EB2F


def create_boosting(boosting_type: str, device=None) -> GBDT:
    """Boosting::CreateBoosting (boosting.cpp:57-83)."""
    return {"gbdt": GBDT, "goss": GOSS, "dart": DART, "rf": RF}[
        boosting_type](device)


def goss_sample(g_all: torch.Tensor, h_all: torch.Tensor,
                mask: torch.Tensor, key: int, top_rate: float,
                other_rate: float) -> tuple:
    """The hashed GOSS sampler (the JAX package's ``_hash_hook``,
    boosting.py:102-157) on g, h [K, n] and the mask [n + passengers]:
    each row scored by ``Σ_k |g h|`` (classes added in order), the
    ``top_k`` rows of the largest scores kept (ties at the threshold
    kept too), the others drawn with probability ``other_k / (n -
    top_k)`` by ``hash_uniform(row, key ^ GOSS_SALT)`` and their g and h
    multiplied by ``(n - top_k) / other_k``. ``top_k`` and ``other_k``
    are ``floor(f32(n) * f32(rate))``, at least 1, in f32 as in the JAX
    step. A ``key`` of 0 (warm-up) passes everything through. The
    passengers' mask stays 0. Returns (g, h, mask)."""
    if key == 0:
        return g_all, h_all, mask
    n = g_all.shape[1]
    f32 = np.float32
    nf = f32(n)
    top_k = max(np.floor(nf * f32(top_rate)), f32(1.0))
    other_k = max(np.floor(nf * f32(other_rate)), f32(1.0))
    multiply = f32((nf - top_k) / other_k)
    p = f32(other_k / max(nf - top_k, f32(1.0)))
    score = (g_all[0] * h_all[0]).abs()
    for k in range(1, g_all.shape[0]):
        score = score + (g_all[k] * h_all[k]).abs()
    # the top_k-th largest score: a selection, exact as the JAX sort
    thr = torch.kthvalue(score, n - int(top_k) + 1).values
    is_top = score >= thr
    u = hash_uniform(torch.arange(n, dtype=torch.int64, device=g_all.device),
                     key ^ GOSS_SALT)
    sampled = (u < float(p)) & ~is_top
    amp = torch.where(sampled, float(multiply), 1.0)
    keep = (is_top | sampled).to(torch.float32)
    tail = mask.shape[0] - n
    if tail:
        keep = torch.cat([keep, keep.new_zeros(tail)])
    return g_all * amp, h_all * amp, mask * keep


def legacy_goss_sample(g_all: torch.Tensor, h_all: torch.Tensor,
                       mask: torch.Tensor, seed: int, top_rate: float,
                       other_rate: float) -> tuple:
    """The legacy GOSS sampler (``tpu_goss_hash=0``; the JAX package's
    ``_legacy_hook``, boosting.py:159-192) on g, h [K, n] and the mask
    [n + passengers]: the counts from the host's n in double (``top_k =
    max(1, int(n * top_rate))``), the rows of the ``top_k`` largest
    ``Σ_k |g h|`` kept (ties at the ``top_k``-th value kept too, as
    ``lax.top_k``'s last value thresholds them), the others drawn where
    ``jax.random.uniform(PRNGKey(seed), (n,)) < f32(other_k / (n -
    top_k))`` and their g and h multiplied by ``f32((n - top_k) /
    other_k)``. A ``seed`` of 0 (warm-up's zero key) passes everything
    through. The passengers' mask stays 0. Returns (g, h, mask)."""
    if seed == 0:
        return g_all, h_all, mask
    n = g_all.shape[1]
    top_k = max(1, int(n * top_rate))
    other_k = max(1, int(n * other_rate))
    multiply = float(np.float32((n - top_k) / other_k))
    p = float(np.float32(other_k / max(n - top_k, 1)))
    score = (g_all[0] * h_all[0]).abs()
    for k in range(1, g_all.shape[0]):
        score = score + (g_all[k] * h_all[k]).abs()
    thr = torch.topk(score, top_k).values[-1]
    is_top = score >= thr
    u = threefry.uniform(threefry.prng_key(seed), n, g_all.device)
    sampled = (u < p) & ~is_top
    amp = torch.where(sampled, multiply, 1.0)
    keep = (is_top | sampled).to(torch.float32)
    tail = mask.shape[0] - n
    if tail:
        keep = torch.cat([keep, keep.new_zeros(tail)])
    return g_all * amp, h_all * amp, mask * keep


class GOSS(GBDT):
    """Gradient-based One-Side Sampling (goss.hpp:26-216)."""

    def init(self, config, train_data, objective, training_metrics=()):
        if not config.top_rate + config.other_rate <= 1.0:
            log.fatal("top_rate + other_rate cannot be larger than 1.0")
        if not (config.top_rate > 0.0 and config.other_rate > 0.0):
            log.fatal("top_rate and other_rate should be larger than 0")
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            log.fatal("Cannot use bagging in GOSS")
        super().init(config, train_data, objective, training_metrics)
        log.info("Using GOSS")
        self._hook_rng = np.random.default_rng(config.bagging_seed)
        # sampling starts after 1/learning_rate iterations
        # (goss.hpp:137-139); the key stream does not advance before
        self._goss_warmup = int(1.0 / max(config.learning_rate, 1e-12))
        return self

    def _step_cache_eligible(self) -> bool:
        """The legacy sampler's stream is positional and its counts are
        the booster's own: it trains uncached, as in the JAX package."""
        return (self.config.tpu_goss_hash != 0
                and super()._step_cache_eligible())

    def _sample(self, g_all, h_all, mask):
        if self.iter_ < self._goss_warmup:
            return g_all, h_all, mask
        # the JAX package's key: PRNGKey of this draw (gbdt.py:1574)
        key = int(self._hook_rng.integers(1, 2 ** 31))
        sample = (legacy_goss_sample if self.config.tpu_goss_hash == 0
                  else goss_sample)
        return sample(g_all, h_all, mask, key, self.config.top_rate,
                      self.config.other_rate)


class DART(GBDT):
    """Dropouts meet Multiple Additive Regression Trees
    (dart.hpp:17-190)."""

    def init(self, config, train_data, objective, training_metrics=()):
        super().init(config, train_data, objective, training_metrics)
        self._drop_rng = np.random.default_rng(config.drop_seed)
        self._tree_weight = []          # per iteration (uniform_drop off)
        self._sum_weight = 0.0
        self._drop_index = []
        self._drop_leaves = {}
        return self

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """TrainOneIter (dart.hpp:52-66): drop, train on the dropped
        scores with the lowered shrinkage, normalize."""
        self._dropping_trees()
        if super().train_one_iter(grad, hess):
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self._tree_weight.append(self.shrinkage_rate)
            self._sum_weight += self.shrinkage_rate
        return False

    def _select_drops(self) -> list:
        """The dropped iterations, from ``drop_seed``'s stream in the JAX
        package's order of draws (dart.hpp:86-120)."""
        cfg = self.config
        drops = []
        if self._drop_rng.random() < cfg.skip_drop:
            return drops
        drop_rate = cfg.drop_rate
        if not cfg.uniform_drop:
            if self._sum_weight <= 0:
                return drops
            inv_avg = len(self._tree_weight) / self._sum_weight
            if cfg.max_drop > 0:
                drop_rate = min(drop_rate,
                                cfg.max_drop * inv_avg / self._sum_weight)
            for i in range(self.iter_):
                if self._drop_rng.random() < \
                        drop_rate * self._tree_weight[i] * inv_avg:
                    drops.append(i)
                    if len(drops) >= cfg.max_drop > 0:
                        break
        else:
            if cfg.max_drop > 0 and self.iter_ > 0:
                drop_rate = min(drop_rate, cfg.max_drop / self.iter_)
            for i in range(self.iter_):
                if self._drop_rng.random() < drop_rate:
                    drops.append(i)
                    if len(drops) >= cfg.max_drop > 0:
                        break
        return drops

    def _dropping_trees(self) -> None:
        """DroppingTrees (dart.hpp:86-135): each dropped tree replayed on
        the train rows and subtracted (K3 at shrink -1); the new tree's
        shrinkage lowered. The replayed leaf ids are kept for
        ``_normalize``: the dropped trees' splits do not change."""
        cfg = self.config
        self._drop_index = self._select_drops()
        self._drop_leaves = {}
        K = self.num_tree_per_iteration
        # unpacked from the 4-bit form when the grower reads it packed
        tb = self._train_bins_t() if self._drop_index else None
        for i in self._drop_index:
            for k in range(K):
                rec = self.records[i * K + k]
                leaf = self._replay(rec, tb)
                self._drop_leaves[i * K + k] = leaf
                add_leaf_outputs(self._scores[k], leaf, rec.leaf_output, -1.0)
        kdrop = len(self._drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + kdrop)
        else:
            self.shrinkage_rate = (
                cfg.learning_rate if kdrop == 0
                else cfg.learning_rate / (cfg.learning_rate + kdrop))

    def _normalize(self) -> None:
        """Normalize (dart.hpp:137-190): each dropped tree rescaled to
        ``keep_scale`` of its weight, its record and host tree with it,
        and the train and valid scores patched. The JAX package's jitted
        ``add_leaf_outputs`` contracts ``scores + f32(scale) * out[leaf]``
        into one fused multiply-add, as K3 computes it; the rescaled
        record is an f32 product."""
        cfg = self.config
        if not self._drop_index:
            return
        kdrop = float(len(self._drop_index))
        K = self.num_tree_per_iteration
        if not cfg.xgboost_dart_mode:
            keep_scale = kdrop / (kdrop + 1.0)    # the final tree weight
            weight_sub = 1.0 / (kdrop + 1.0)      # dart.hpp:163
        else:
            # shrinkage lr / (lr + k): the final weight k / (lr + k)
            keep_scale = kdrop * self.shrinkage_rate / cfg.learning_rate
            weight_sub = 1.0 / (kdrop + cfg.learning_rate)  # dart.hpp:181
        keep = float(np.float32(keep_scale))
        for i in self._drop_index:
            for k in range(K):
                t = i * K + k
                rec = self.records[t]
                old = rec.leaf_output
                # valid rows held +old; now keep_scale * old
                for v, scores in zip(self.valid_sets, self._valid_scores):
                    add_leaf_outputs(scores[k], self._replay(rec, v.bins_t),
                                     old, keep_scale - 1.0)
                # train rows: subtracted in full; keep_scale * old back
                add_leaf_outputs(self._scores[k], self._drop_leaves[t], old,
                                 keep_scale)
                self.records[t] = rec._replace(
                    leaf_output=old * keep,
                    internal_value=rec.internal_value * keep)
                self.models[t] = None     # the host tree built anew
            if not cfg.uniform_drop:
                self._sum_weight -= self._tree_weight[i] * weight_sub
                self._tree_weight[i] *= keep_scale
        self._drop_leaves = {}
        self._invalidate_stacked()


class RF(GBDT):
    """Random Forest (rf.hpp:18-172): bagged trees on fixed targets,
    their outputs averaged."""

    def __init__(self, device=None):
        super().__init__(device)
        self.average_output = True

    def init(self, config, train_data, objective, training_metrics=()):
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            log.fatal("RF needs bagging_freq > 0 and bagging_fraction in "
                      "(0, 1)")
        super().init(config, train_data, objective, training_metrics)
        if train_data.metadata.init_score is not None:
            log.fatal("Cannot use init_score with RF")
        self.shrinkage_rate = 1.0
        # GetRFTargets (rf.hpp:81-107): g = -label, or -1 at the row's
        # class; h = 1
        n, K = self._n, self.num_tree_per_iteration
        label = train_data.metadata.label
        label = (np.zeros(n, np.float32) if label is None
                 else np.asarray(label, np.float32))
        g = np.zeros((K, n), np.float32)
        if K == 1:
            g[0] = -label
        else:
            g[label.astype(np.int64), np.arange(n)] = -1.0
        self._rf_g = torch.from_numpy(g).to(self.device)
        self._rf_h = torch.ones((K, n), dtype=torch.float32,
                                device=self.device)
        return self

    def boost_from_average(self, class_id: int) -> float:
        return 0.0

    def _jax_score_width(self) -> int:
        # RF's step is its own in the JAX package, at the exact width
        return self._n

    @staticmethod
    def _average(scores: torch.Tensor, leaf_ids: torch.Tensor,
                 table: torch.Tensor, it: float) -> None:
        """scores = (scores * it + table[leaf]) / (it + 1) in place, the
        product and the add one fused multiply-add as XLA contracts the
        JAX package's jitted RF step. The leaf outputs are gathered by K3
        onto zeros."""
        gathered = torch.zeros_like(scores)
        add_leaf_outputs(gathered, leaf_ids, table, 1.0)
        scores.copy_(fma(scores, it, gathered) / (it + 1.0))

    def _replay_into(self, scores, bins_t, records) -> None:
        """The running mean of ``train_one_iter`` replayed, splitless
        trees skipped: a valid set added late, or a continued model's
        train set, starts where a set there from the first iteration
        stands (the reference's RF::AddValidDataset rescales its sum; the
        JAX package keeps the sum of the trees)."""
        K = self.num_tree_per_iteration
        for t_idx, rec in enumerate(records):
            if rec.num_leaves > 1:
                self._average(scores[t_idx % K], self._replay(rec, bins_t),
                              rec.leaf_output, float(t_idx // K))

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """TrainOneIter (rf.hpp:112-151): fixed targets under bagging,
        the L1 family renewed against zero scores, the train and valid
        scores a running mean over the trees that split; never stops on
        its own (a splitless bag says nothing of the next one)."""
        if grad is not None or hess is not None:
            log.fatal("RF does not support custom objectives")
        K = self.num_tree_per_iteration
        n, tail = self._n, self._n_total - self._n
        dev = self.device
        mask_np = self._bagging_mask(self.iter_)
        if tail:
            mask_np = np.concatenate([mask_np, np.zeros(tail, np.float32)])
        mask = torch.from_numpy(mask_np).to(dev)
        fmask = torch.from_numpy(self._feature_mask()).to(dev)
        it = float(self.iter_)
        for k in range(K):
            g, h = self._rf_g[k], self._rf_h[k]
            if tail:
                g = torch.cat([g, g.new_zeros(tail)])
                h = torch.cat([h, h.new_zeros(tail)])
            rec, leaf_ids = self._grower.grow(
                self._grower_bins(), g, h, mask, fmask, counted_rows=n,
                sparse=self._sparse_planes)
            if rec.num_leaves > 1:
                if self._renew is not None:
                    # against zero scores (rf.hpp:146)
                    alpha, label, w = self._renew
                    rec = rec._replace(leaf_output=renew_leaf_outputs(
                        leaf_ids[:n], label, w, self._grower_cfg.num_leaves,
                        alpha, rec.leaf_output, mask[:n],
                        sum_length=self._jax_score_width()))
                self._average(self._scores[k], leaf_ids[:n],
                              rec.leaf_output, it)
                for scores, (off, nv) in zip(self._valid_scores,
                                             self._valid_row_slices):
                    self._average(scores[k], leaf_ids[off:off + nv],
                                  rec.leaf_output, it)
            self.records.append(rec)
            self.models.append(None)
            self._tree_shrinkage.append(1.0)
        self.iter_ += 1
        self._bump_model_gen()
        return False

    def rollback_one_iter(self) -> None:
        """RollbackOneIter (rf.hpp:153-166): the last trees taken out of
        the running means, each operation rounded apart as the JAX
        package's eager code does."""
        if self.iter_ <= 0:
            return
        K = self.num_tree_per_iteration
        it = float(self.iter_)
        div = float(max(self.iter_ - 1, 1))
        train_bins = self._train_bins_t()
        for k in range(K - 1, -1, -1):
            rec = self.records.pop()
            self.models.pop()
            self._tree_shrinkage.pop()
            if rec.num_leaves <= 1:
                continue
            for scores, bins in [(self._scores, train_bins)] + [
                    (s, v.bins_t) for s, v in zip(self._valid_scores,
                                                  self.valid_sets)]:
                scores[k].mul_(it)
                add_leaf_outputs(scores[k], self._replay(rec, bins),
                                 rec.leaf_output, -1.0)
                scores[k].div_(div)
        self.iter_ -= 1
        self._bump_model_gen()
