"""Distributed tree learners on ``torch.distributed``: one process a rank.

The JAX package's ``parallel/learners.py`` runs each learner as one SPMD
program (``shard_map`` over a device mesh) whose collectives are XLA's
``psum``, ``all_gather`` and ``pmax``. Here each rank is an OS process
(parallel/cluster.py joins them) that runs the port's own wave grower
(ops/wave_grower.py) on its own rows, with the grower's collective
points (``Seams``) calling the process group:

  reference                              here
  ---------------------------------     ------------------------------
  histogram ReduceScatter                ``psum`` of each wave's
    (data_parallel_tree_learner.cpp:147)   [W, F, B, C] histograms
  best-split AllReduce, max-gain         ``sync_best_splits``: an
    reducer (parallel_tree_learner.h:183)  all-gather and an argmax
  top-k vote Allgather                   ``psum`` of the votes, then of
    (voting_parallel_tree_learner.cpp:342) the elected features' slices

Modes (``tree_learner``):
- data: rank r holds the contiguous rows ``[r*S, r*S + n_r)`` of the
  matrix (S = io/ingest.py ``shard_width``, the JAX package's
  :268-275); every wave's K1 runs on the rank's rows and its histograms
  are summed over the ranks before the subtraction, so every rank
  searches the same global histograms. With ``tpu_quantized_psum`` the
  int8 sums cross as integers (exact; ``make_hist_reduce``), else as
  f32. The int8 scales are global (``pmax``) and the rounding hash takes
  global row indices, so the int8 trees equal the serial learner's.
- feature: every rank holds every row, partitions them all, histograms
  its slice of the features (one K2 a wave on its columns of the bin
  matrix, the partition unfused, as the JAX package's :314-414) and
  searches it; the best split of each child is ``sync_best_splits``'s.
  The slice's f32 sums keep the whole matrix's order of addition
  (ops/hist_wave.py ``wave_histogram(order_features=)``), so the
  feature learner's trees equal the serial learner's bit for bit on the
  card too.
- voting (PV-Tree): the data layout, with local histograms; per child
  each rank votes its top-k features by local gain (gates scaled by
  1/D), the votes and gain sums are summed, ``votes*F + rank(gain sum)``
  elects the top 2k, and only the elected features' histograms are
  summed (the JAX package's :416-515).

The f32 sums cross as an all-gather added in rank order, so every rank
gets the same bits whatever the backend's reduction order; integer sums
and maxima are exact and use all-reduce. Under gloo (ranks sharing a
card, or on the CPU) tensors cross through host memory.

``set_network_functions`` is the seam for injected collectives
(``LGBM_NetworkInitWithFunctions``): an override is ``fn(value,
default_collective) -> value``. The JAX package compiles its
collectives into the program, so there an override runs once per
collective site per compilation; the port runs eagerly, so an override
runs at every call of its collective.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..io.efb import expand_bundle_histogram
from ..ops.f32math import xla_sum
from ..ops.hist_wave import wave_histogram
from ..ops.split import FeatureMeta, SplitResult, find_best_split
from ..ops.wave_grower import Seams, WaveGrower, WaveGrowerConfig
from . import cluster

_collective_overrides: dict = {}

# a list that gets each voting search's elected features [M, 2k] (tests,
# lightgbm_tpu_torch/testing.py), or None
election_log = None

# bytes this rank sent through the seams and the seconds spent in them,
# since the last ``reset_meter`` (models/gbdt.py reads them an iteration)
_meter = {"bytes": 0, "seconds": 0.0, "calls": 0}


def set_network_functions(reduce_scatter_fn=None, allgather_fn=None) -> None:
    """Install (or with both None, clear) collective overrides: the
    histogram and scalar sums go through ``reduce_scatter_fn``, the
    best-split gather through ``allgather_fn``; each is called as
    ``fn(value, default)`` at every collective (eager, unlike the JAX
    package's trace-time seam)."""
    _collective_overrides.clear()
    if reduce_scatter_fn is not None:
        _collective_overrides["reduce_scatter"] = reduce_scatter_fn
    if allgather_fn is not None:
        _collective_overrides["allgather"] = allgather_fn


def reset_meter() -> None:
    _meter.update(bytes=0, seconds=0.0, calls=0)


def meter() -> dict:
    """{bytes, seconds, calls} of this rank's collectives since the last
    ``reset_meter``: the payload bytes it contributed, the wall seconds
    spent in the calls (host staging included)."""
    return dict(_meter)


def _group_size() -> int:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def _stage(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the wire's device: host memory under gloo."""
    x = x.detach().reshape(-1) if x.ndim == 0 else x.detach()
    if cluster.backend() != "nccl" and x.device.type != "cpu":
        x = x.to("cpu")
    return x.contiguous()


def _account(nbytes: int, t0: float) -> None:
    _meter["bytes"] += int(nbytes)
    _meter["seconds"] += time.perf_counter() - t0
    _meter["calls"] += 1


_NARROW = (torch.int8, torch.int16)


def _psum_base(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks: int32 and int64 exactly by all-reduce; floats
    by an all-gather added in rank order (the same bits on every rank);
    the narrow wires' int8 and int16 as their bytes by an all-gather
    (neither gloo nor NCCL reduces int16), added in int32 and cast back,
    exact inside the bound their wire was chosen under."""
    import torch.distributed as dist
    D = _group_size()
    if D == 1:
        return x
    t0 = time.perf_counter()
    w = _stage(x)
    if x.is_floating_point() or x.dtype in _NARROW:
        raw = w.view(torch.uint8) if x.dtype in _NARROW else w
        parts = [torch.empty_like(raw) for _ in range(D)]
        dist.all_gather(parts, raw)
        if x.dtype in _NARROW:
            parts = [p.view(x.dtype).to(torch.int32) for p in parts]
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        acc = acc.to(x.dtype)
    else:
        acc = w.clone()
        dist.all_reduce(acc)
    out = acc.reshape(x.shape).to(x.device)
    _account(w.numel() * w.element_size(), t0)
    return out


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, through the injectable seam."""
    ov = _collective_overrides.get("reduce_scatter")
    return ov(x, _psum_base) if ov is not None else _psum_base(x)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The max over ranks (exact)."""
    import torch.distributed as dist
    if _group_size() == 1:
        return x
    t0 = time.perf_counter()
    w = _stage(x).clone()
    dist.all_reduce(w, op=dist.ReduceOp.MAX)
    _account(w.numel() * w.element_size(), t0)
    return w.reshape(x.shape).to(x.device)


_WIRE_DTYPES = {"int8": torch.int8, "int16": torch.int16,
                "int32": torch.int32}


def slot_psum(x: torch.Tensor, slots: int, sum_fn=psum) -> torch.Tensor:
    """The histogram collective as ``slots`` independent sums along the
    feature axis (``tpu_async_psum``; the JAX package's ``_slot_psum``):
    a sum is elementwise over ranks, so the split is bit-identical to
    one collective."""
    slots = max(int(slots), 1)
    if slots == 1 or x.ndim < 2 or x.shape[1] < slots:
        return sum_fn(x)
    F = x.shape[1]
    step = F // slots
    parts, lo = [], 0
    for s in range(slots):
        hi = F if s == slots - 1 else lo + step
        parts.append(sum_fn(x[:, lo:hi]))
        lo = hi
    return torch.cat(parts, dim=1)


def make_hist_reduce(cfg: WaveGrowerConfig):
    """The data learner's histogram collective from the config's wire
    and slots (the JAX package's :133-158): with ``quant_psum`` the raw
    integer sums cross in ``psum_wire``'s dtype, exact inside the
    127*N bound that ops/autotune.py ``tune_psum_wire`` proves, widened
    after; ``psum_slots`` independent collectives along F."""
    wire = _WIRE_DTYPES.get(cfg.psum_wire, torch.int32)
    narrow = bool(cfg.quant_psum) and cfg.psum_wire != "int32"

    def one(x):
        if narrow and x.dtype != wire:
            return psum(x.to(wire)).to(x.dtype)
        return psum(x)

    def hist_reduce(x):
        return slot_psum(x, cfg.psum_slots, sum_fn=one)
    return hist_reduce


_SPLIT_INT = ("feature", "threshold_bin")
_SPLIT_BOOL = ("default_left", "is_cat")


def _gather_splits(res: SplitResult) -> SplitResult:
    """Every rank's ``res`` ([M] fields) as [D, M] fields, by one
    all-gather of the fields packed in float64 (int32 and f32 values are
    exact there)."""
    import torch.distributed as dist
    D = _group_size()
    M = res.gain.shape[0]
    cols = [getattr(res, f).to(torch.float64).reshape(M, 1)
            for f in SplitResult._fields if f != "cat_words"]
    cols.append(res.cat_words.to(torch.float64))
    packed = torch.cat(cols, dim=1)
    if D == 1:
        rows = packed[None]
    else:
        t0 = time.perf_counter()
        w = _stage(packed)
        parts = [torch.empty_like(w) for _ in range(D)]
        dist.all_gather(parts, w)
        rows = torch.stack(parts).to(res.gain.device)
        _account(w.numel() * w.element_size(), t0)
    out, j = {}, 0
    for f in SplitResult._fields:
        ref = getattr(res, f)
        if f == "cat_words":
            out[f] = rows[:, :, j:].to(ref.dtype)
        else:
            out[f] = rows[:, :, j].to(ref.dtype)
            j += 1
    return SplitResult(**out)


def sync_best_splits(res: SplitResult) -> SplitResult:
    """Each child's best split over the ranks (SyncUpGlobalBestSplit,
    parallel_tree_learner.h:183-207): an all-gather, then per child the
    argmax of the gains over ranks, ties to the lowest rank (as
    ``jnp.argmax``)."""
    ov = _collective_overrides.get("allgather")
    g = ov(res, _gather_splits) if ov is not None else _gather_splits(res)
    best = torch.argmax(g.gain, dim=0)                     # [M]
    m = torch.arange(best.shape[0], device=best.device)
    return SplitResult(*[f[best, m] for f in g])


def _slice_meta(meta: FeatureMeta, lo: int, hi: int) -> FeatureMeta:
    # scalar sentinels (is_cat, bundle, offset defaults) pass through
    return FeatureMeta(*[x if x.ndim == 0 else x[lo:hi] for x in meta])


# the JAX package's f32 row chunk (its grower pads each shard's rows to
# a multiple of it once the data are large enough, gbdt.py:559-564)
LEARNER_CHUNK = 8192


def learner_block(n: int, world_n: int, rank_n: int,
                  chunk: int = LEARNER_CHUNK) -> tuple:
    """[lo, hi): rank ``rank_n``'s rows of ``n`` under data and voting,
    the JAX package's shard layout (gbdt.py:559-564): shards of
    ceil(n / D) rows, or of a multiple of ``chunk`` once n >= 4 D chunk;
    the last one short (the JAX package pads it with weightless rows)."""
    D = max(int(world_n), 1)
    S = -(-n // D)
    if n >= 4 * D * chunk:
        S = -(-n // (D * chunk)) * chunk
    lo = min(rank_n * S, n)
    return lo, min(lo + S, n)


def _row_offset_fn(row_offset: int):
    def row_offset_fn(n_local):
        return row_offset
    return row_offset_fn


def make_data_parallel_grower(cfg: WaveGrowerConfig, meta: FeatureMeta,
                              device, row_offset: int) -> WaveGrower:
    """Rows sharded over the ranks; the wave histograms summed before
    the subtraction (DataParallelTreeLearner). ``row_offset``: the
    global index of this rank's first row. K1 stays the fused kernel on
    each rank's rows; only the histograms, root sums and scales cross."""
    return WaveGrower(cfg, meta, device, Seams(
        reduce_fn=psum, hist_reduce_fn=make_hist_reduce(cfg),
        max_reduce_fn=pmax, row_offset_fn=_row_offset_fn(row_offset)))


def feature_slice(num_features: int) -> tuple:
    """[lo, hi): this rank's features (F cut in ceil(F / D) parts)."""
    D, r = _group_size(), cluster.rank()
    Fd = -(-num_features // D)
    lo = min(r * Fd, num_features)
    return lo, min(lo + Fd, num_features)


class FeatureSliceGrower(WaveGrower):
    """The feature learner's grower: the two-pass route (each rank holds
    every row, so it partitions them all, ``WaveGrower._partition``),
    with each wave's histograms of this rank's slice of the bin matrix's
    columns only: one K2 over those rows of the matrix (features, or
    under EFB bundle columns expanded to their members), added in the
    whole matrix's order (``wave_histogram(order_features=)``), zeros
    for the other columns."""

    def __init__(self, cfg: WaveGrowerConfig, meta: FeatureMeta, device,
                 seams: Seams, columns: tuple):
        if cfg.count_proxy or cfg.packed4 or cfg.sparse_hist:
            raise ValueError("the feature learner takes neither the "
                             "count-proxy, packed4 nor sparse tiers")
        super().__init__(cfg, meta, device, seams)
        self.two_pass = True
        self.columns = columns

    def _hist(self, bins_t, hg, hh, ids, wl, scale, counted_rows, sparse):
        cfg = self.cfg
        lo, hi = self.columns
        B = cfg.bundle_bins or cfg.num_bins
        shape = (wl.shape[0], bins_t.shape[0], B, 3)
        int_raw = cfg.precision == "int8" and scale is None
        full = torch.zeros(shape, device=bins_t.device,
                           dtype=torch.int32 if int_raw else torch.float32)
        if hi > lo:
            full[:, lo:hi] = wave_histogram(
                bins_t[lo:hi], hg, hh, ids, wl, B, precision=cfg.precision,
                num_features=hi - lo, gh_scale=scale,
                counted_rows=counted_rows, order_features=bins_t.shape[0])
        if not cfg.bundle_bins:
            return full
        m = self.meta
        return expand_bundle_histogram(full, m.bundle, m.offset, m.num_bin,
                                       m.default_bin, cfg.num_bins)


def make_feature_parallel_grower(cfg: WaveGrowerConfig, meta: FeatureMeta,
                                 device, num_features: int) -> WaveGrower:
    """Every rank holds every row, histograms its slice of the features
    and searches it; the best split of each child is the argmax over
    ranks (FeatureParallelTreeLearner). The only collective is that
    gather of the children's best splits."""
    lo, hi = feature_slice(num_features)
    # more ranks than features: an empty slice searches one feature
    # masked off, whose gathered split never wins
    a, b = (lo, hi) if hi > lo else (num_features - 1, num_features)
    meta_l = _slice_meta(meta.to(device), a, b)

    def split_fn(hists, sg, sh, nd, fmask, can, sum_scale=None):
        res = find_best_split(hists[:, a:b], sg, sh, nd,
                              fmask[a:b] & (hi > lo), meta_l, cfg.hp, can,
                              sum_scale=sum_scale)
        res = res._replace(feature=torch.where(
            res.feature >= 0, res.feature + a, -1).to(torch.int32))
        return sync_best_splits(res)

    return FeatureSliceGrower(cfg, meta, device, Seams(split_fn=split_fn),
                              (lo, hi))


def make_feature_parallel_bundled_grower(cfg: WaveGrowerConfig,
                                         meta: FeatureMeta,
                                         device) -> WaveGrower:
    """The feature learner over EFB bundle columns (the JAX package's
    :363-414): each rank histograms its slice of the bundle columns,
    expands it to those bundles' members and searches them; the best
    split of each child is the argmax over ranks."""
    num_bundles = int(np.asarray(meta.bundle).max()) + 1
    lo, hi = feature_slice(num_bundles)
    meta_dev = meta.to(device)
    owned = (meta_dev.bundle >= lo) & (meta_dev.bundle < hi)

    def split_fn(hists, sg, sh, nd, fmask, can, sum_scale=None):
        res = find_best_split(hists, sg, sh, nd, fmask & owned, meta_dev,
                              cfg.hp, can, sum_scale=sum_scale)
        return sync_best_splits(res)

    return FeatureSliceGrower(cfg, meta, device, Seams(split_fn=split_fn),
                              (lo, hi))


def _top(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of each row, ties to the lower index
    (``lax.top_k``)."""
    return torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]


def make_voting_parallel_grower(cfg: WaveGrowerConfig, meta: FeatureMeta,
                                device, num_features: int, top_k: int,
                                row_offset: int) -> WaveGrower:
    """The data layout with PV-Tree vote compression
    (VotingParallelTreeLearner, voting_parallel_tree_learner.cpp:166-360):
    per child a local top-k vote, the top 2k features elected, and only
    their histograms summed; each search's elected features go to
    ``election_log`` when it is a list."""
    D = _group_size()
    F = num_features
    k = max(1, min(top_k, F))
    k2 = min(2 * k, F)
    meta_dev = meta.to(device)
    # the local vote's gates scaled to a rank's share, as the reference's
    # local_config (voting_parallel_tree_learner.cpp:53-55)
    hp_vote = cfg.hp._replace(
        min_data_in_leaf=cfg.hp.min_data_in_leaf / D,
        min_sum_hessian_in_leaf=cfg.hp.min_sum_hessian_in_leaf / D)

    def split_fn(hists, sg, sh, nd, fmask, can, sum_scale=None):
        M, _, B, C = hists.shape
        # 1. the local gains of each feature over the LOCAL histograms
        # and the local leaf sums (every row lies in one bin of feature 0)
        local_sums = [xla_sum(hists[:, 0, :, c]) for c in range(3)]
        local_gain = find_best_split(hists, *local_sums, fmask, meta_dev,
                                     hp_vote, can, per_feature=True)
        # 2. the votes: each rank's top k, summed
        votes = torch.zeros((M, F), dtype=torch.float32, device=device)
        votes.scatter_(1, _top(local_gain, k), 1.0)
        votes = psum(votes)
        # the election orders by (votes, summed local gain): the gain
        # sums ranked 0..F-1 per child; a gated feature adds 0, not -inf
        gain_sum = psum(torch.where(torch.isfinite(local_gain), local_gain,
                                    0.0))
        order = torch.sort(gain_sum, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(F, device=device).expand(M, F))
        elected = _top(votes * F + rank.to(torch.float32), k2)   # [M, 2k]
        if election_log is not None:
            election_log.append(elected.cpu())
        # 3. only the elected features' histograms are summed
        idx = elected[:, :, None, None].expand(M, k2, B, C)
        full = torch.zeros_like(hists)
        full.scatter_(1, idx, psum(hists.gather(1, idx)))
        fm = torch.zeros((M, F), dtype=torch.bool, device=device)
        fm.scatter_(1, elected, True)
        return find_best_split(full, sg, sh, nd, fm & fmask[None],
                               meta_dev, cfg.hp, can, sum_scale=sum_scale)

    return WaveGrower(cfg, meta, device, Seams(
        reduce_fn=psum, split_fn=split_fn, max_reduce_fn=pmax,
        row_offset_fn=_row_offset_fn(row_offset)))


def make_grower_for_mode(mode: str, cfg: WaveGrowerConfig, meta: FeatureMeta,
                         device, num_features: int, top_k: int = 20,
                         row_offset: int = 0) -> WaveGrower:
    """TreeLearner::CreateTreeLearner (tree_learner.cpp:9-33): the
    serial learner alone (or for a one-rank world), else the mode's."""
    if mode == "serial" or _group_size() == 1:
        return WaveGrower(cfg, meta, device)
    if mode == "data":
        return make_data_parallel_grower(cfg, meta, device, row_offset)
    if mode == "feature" and cfg.bundle_bins:
        return make_feature_parallel_bundled_grower(cfg, meta, device)
    if mode == "feature":
        return make_feature_parallel_grower(cfg, meta, device, num_features)
    if mode == "voting":
        return make_voting_parallel_grower(cfg, meta, device, num_features,
                                           top_k, row_offset)
    raise ValueError(f"Unknown tree_learner {mode!r}")
