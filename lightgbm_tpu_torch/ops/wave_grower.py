"""Wave-batched leaf-wise tree grower (serial learner).

The JAX package's ``ops/wave_grower.py`` ``make_wave_grower`` (:224)
with its default seams and the fused route (:761-780); reference
SerialTreeLearner::Train (serial_tree_learner.cpp:157-221). Each wave
splits the top-W leaves by gain at once: one fused pass (K1,
ops/hist_wave.py) moves their rows to the new leaves and builds the W
smaller-child histograms; the siblings come from parent - smaller
subtraction out of a per-leaf histogram pool. The root histogram is one
K2 pass.

Histogram tiers (``WaveGrowerConfig.precision``): "f32", the exact
tier, or "int8", where each tree's gradients are quantized
(ops/quantize.py) and the histogram passes sum integers, dequantized on
the way out (the JAX package's :531-584, :610-668). With
``count_proxy`` the int8 passes carry no count channel: the grower fills
it with per-bin lower bounds from the g/h sums (``bound_counts``, :477),
K1 returns each slot's exact in-bag moved-right count, and the leaf
counts the trees record stay exact (:820-835). With ``packed4`` the bins
are [ceil(F/2), N], two 4-bit bins per byte, read by K1 and K2 only.

Forced splits (``WaveGrowerConfig.forced``, from the JAX package's
:926-1010) are a prefix of every tree: each is a wave of one slot with
its (feature, bin) chosen instead of elected: the partition, one K2 pass
over the left child (which keeps the parent's leaf), the right child by
subtraction from the parent, the children's sums over feature 0's bins,
and their best splits, after which growth by gain goes on. They exclude
the count-proxy and packed4 tiers (the JAX package's :281-292).

With categorical features (``SplitParams.has_cat``) each leaf also
carries its best split's categorical flag and left-set bitset (the JAX
package's ``t_is_cat``, ``t_cat_words``, :152-153); they ride into K1's
split table (its 18-row form) and into the record.

Leaf numbering matches Tree::Split: the left child keeps the parent's
index, the right child takes the next free index, assigned within a
wave in gain-rank order, so split i's right child is leaf i + 1.

Two routes leave the fused pass off, as the JAX package's two-pass
route does (:346, :375-416): under EFB bundles (``bundle_bins`` > 0,
io/efb.py) each wave's partition decodes every slot's member from its
bundle column (``member_column``), then one K2 pass over the bundle
columns at ``bundle_bins`` bins builds the smaller children's bundle
histograms, which ``expand_bundle_histogram`` turns into member
histograms (the JAX package's hist seam, models/gbdt.py:739-771, which
passes the int8 scales into the pass and expands in f32); under the
sparse tier (``sparse_hist``, a CSR-built set) the partition reads the
member rows and the histograms are ``wave_histogram_sparse``'s scatter
over the explicit entries. Both take the sibling as parent minus smaller
child, in f32.

JAX runs the waves in a ``lax.while_loop`` on the device. Here the loop
is Python: each wave reads its number of active splits back to the host
once, which both ends the loop and picks the next wave's launches. A
wave's device work (its body: the split table, K1 or the two-pass
partition and histograms, the subtraction, the record and leaf tables,
the children's split search; then the next wave's election, a stable
sort and its top W) reads the leaf count from a device scalar, so it
depends on the host only through k, the wave width. Under the step
cache (ops/step_cache.py) a tree grows on a ``WaveState``: static
tensors (the inputs padded to the cached geometry's rows, and every
table the waves read or write) and, on a card, one CUDA graph per k,
captured after that width's first wave ran eagerly (its warm-up) and
replayed at every later wave of that width, in this tree or another
booster's. The root (its K2 pass and ``_stable_sum``'s host add) stays
outside the graphs. Without a state the same code runs eagerly on the
booster's own tensors.

The distributed learners (parallel/learners.py) grow on the same code
through its collective points (``Seams``, the JAX package's
``make_wave_grower`` arguments, :224-263): the root's and each wave's
histograms go through ``hist_reduce_fn`` before the subtraction (with
``quant_psum`` as raw integer sums, dequantized after it), the root's
sums, count-proxy counts and the quantization salt's bit sum through
``reduce_fn``, the int8 scales through ``max_reduce_fn``, the rounding
hash takes ``row_offset_fn``'s global index of the first row, and
``split_fn`` replaces the split search. Without seams the grower runs
the serial learner as it always did.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import step_cache
from .grower import TreeRecord
from .f32math import fma, xla_sum
from .hist_wave import (dequantize, fused_partition_histogram,
                        wave_histogram, wave_histogram_sparse)
from .quantize import INV127, quantize
from .partition import apply_split, member_column, row_goes_right
from ..io.efb import expand_bundle_histogram
from .split import (KMIN_SCORE, NCAT_WORDS, FeatureMeta, SplitParams,
                    _f32, calculate_leaf_output, find_best_split,
                    threshold_l1)
from ..utils.device import capture_graph


class WaveGrowerConfig(NamedTuple):
    num_leaves: int
    num_bins: int            # histogram width B
    wave_size: int = 16
    max_depth: int = -1
    hp: SplitParams = SplitParams()
    precision: str = "f32"   # "f32" or "int8" (tpu_quantized_hist)
    count_proxy: bool = False
    packed4: bool = False
    forced: tuple = ()       # ((parent leaf, inner feature, bin), ...) BFS
    # EFB: the bins of the K2 pass over bundle columns (max(bundle
    # width, 2)); 0 when the set is unbundled
    bundle_bins: int = 0
    # the sparse histogram tier: grow() takes the set's binned entries
    sparse_hist: bool = False
    # the data learner's quantized wire (tpu_quantized_psum): the int8
    # histograms cross the collective as raw integer sums in
    # ``psum_wire``'s dtype, in ``psum_slots`` collectives along F
    # (tpu_async_psum); the serial learner keeps the defaults
    quant_psum: bool = False
    psum_wire: str = "int32"
    psum_slots: int = 1


class Seams(NamedTuple):
    """The collective points of a distributed learner; None keeps the
    serial learner's (the JAX package's make_wave_grower :224-263).

    ``reduce_fn(x)``: the sum over ranks of a locally summed tensor
    (exact for integer tensors); ``hist_reduce_fn(h)``: the sum over
    ranks of a wave's [W, F, B, C] histograms; ``max_reduce_fn(x)``: the
    max over ranks (the int8 scales); ``row_offset_fn(n_local)``: the
    global index of this rank's first row; ``split_fn(hists, sg, sh, nd,
    fmask, can, sum_scale)``: the split search of 2k children, returning
    a ``SplitResult`` with global feature indices."""
    reduce_fn: Optional[Callable] = None
    hist_reduce_fn: Optional[Callable] = None
    max_reduce_fn: Optional[Callable] = None
    row_offset_fn: Optional[Callable] = None
    split_fn: Optional[Callable] = None


def _same(x):
    return x


def bound_counts(hist: torch.Tensor, sg, sh) -> torch.Tensor:
    """Count-proxy: [..., >= 2] dequantized g/h sums -> [..., 3] with
    the count channel set to each bin's lower bound max(|sum gq|, sum
    hq) / 127 (|gq|, hq <= 127 per row), the JAX package's
    ``bound_counts`` (wave_grower.py:477). XLA multiplies by f32(1/127)
    for its division by 127, and so does this."""
    h2 = hist[..., :2]
    lb = torch.maximum(h2[..., 0].abs() / sg, h2[..., 1] / sh) * INV127
    return torch.cat([h2, lb[..., None]], dim=-1)


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


def _forced_gain(sum_g, sum_h, l1: float, l2: float, mds: float,
                 child: bool) -> torch.Tensor:
    """GetLeafSplitGain of a forced split's child or parent, rounded as
    XLA's CPU code rounds the JAX package's jitted grower: a child's
    ``2 g out + (h + l2) out out`` unfused, the parent's contracted into
    one fused multiply-add around ``2 g * out``."""
    out = calculate_leaf_output(sum_g, sum_h, l1, l2, mds)
    twice_g = 2.0 * threshold_l1(sum_g, l1)
    if child:
        return -(twice_g * out + (sum_h + l2) * out * out)
    return -fma(twice_g, out, (sum_h + l2) * out * out)


def pad_meta(meta: FeatureMeta, features: int) -> FeatureMeta:
    """``meta`` of F features with trivial features appended up to
    ``features``, the JAX package's pad (models/gbdt.py:634-651): num_bin
    1 (no split candidate), no missing type, default bin 0, no monotone
    constraint, penalty 1, numerical; unbundled."""
    pad = features - int(meta.num_bin.shape[0])
    if pad == 0:
        return meta

    def ext(x, fill):
        x = torch.as_tensor(x)
        if x.ndim == 0:
            x = x.expand(features - pad)
        return torch.cat([x, x.new_full((pad,), fill)])
    return meta._replace(
        num_bin=ext(meta.num_bin, 1), missing_type=ext(meta.missing_type, 0),
        default_bin=ext(meta.default_bin, 0),
        monotone=ext(meta.monotone, 0), penalty=ext(meta.penalty, 1.0),
        is_cat=ext(meta.is_cat, 0))


class WaveState:
    """A step-cache entry (ops/step_cache.py): one grower geometry's
    static tensors and its wave graphs. ``owner`` is the bin token of the
    booster whose bins and feature metadata the state holds."""

    def __init__(self, device: torch.device, rows: int, features: int,
                 bin_rows: int, num_bins: int, packed4: bool):
        self.device = device
        self.rows = rows            # the padded columns of every input
        # F padded with trivial features (step_cache.bucket_features),
        # and the bin matrix's padded rows (features / 2 when packed)
        self.features = features
        self.bin_rows = bin_rows
        self.num_bins = num_bins    # the histogram width B
        self.packed4 = packed4
        self.owner = None
        self.meta: Optional[FeatureMeta] = None
        self._bufs: dict = {}
        self.graphs: dict = {}      # k -> utils.device.Captured
        # one memory pool for the graphs of this state: they never run at
        # once, and no intermediate outlives its wave
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
        # the card's reserved memory grown over this state's captures:
        # what its graph pool holds, about (another thread's allocations
        # over a capture count too)
        self.pool_bytes = 0

    def nbytes(self) -> int:
        """Device bytes the state holds: its static tensors (the padded
        copy of the owner's bins among them) and its graph pool."""
        return self.pool_bytes + sum(t.numel() * t.element_size()
                                     for t in self._bufs.values())

    def keep(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t``'s value in this state's persistent tensor ``name``."""
        buf = self._bufs.get(name)
        if buf is None:
            buf = self._bufs[name] = torch.empty(t.shape, dtype=t.dtype,
                                                 device=self.device)
        return buf.copy_(t)

    def padded(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` [..., n] in the persistent [..., rows] tensor ``name``,
        zeros past column n."""
        n = t.shape[-1]
        buf = self._bufs.get(name)
        if buf is None:
            buf = self._bufs[name] = torch.zeros(
                t.shape[:-1] + (self.rows,), dtype=t.dtype,
                device=self.device)
        buf[..., :n].copy_(t)
        buf[..., n:].zero_()
        return buf

    def load(self, owner, bins_t: torch.Tensor, meta: FeatureMeta):
        """(bins, meta) of ``owner`` in the static tensors, padded to the
        state's features and rows, copied only when another booster (or
        other bins) held them last. The pad features' metadata are
        trivial (``pad_meta``: num_bin 1, so no bin of theirs is ever a
        split candidate) and their bins the row index mod B: with one
        bin for all rows, every counted row of a pad feature would add
        to one histogram cell, and the pass's shared-memory adds
        serialize on it."""
        if self.owner is not owner:
            buf = self._bufs.get("bins")
            if buf is None:
                buf = self._bufs["bins"] = torch.zeros(
                    (self.bin_rows, self.rows), dtype=bins_t.dtype,
                    device=self.device)
            f, n = bins_t.shape
            buf[:f, :n].copy_(bins_t)
            buf[:f, n:].zero_()
            if f < self.bin_rows:
                spread = torch.arange(n, device=self.device) % self.num_bins
                if self.packed4:
                    spread = spread | (spread << 4)
                buf[f:, :n].copy_(spread.to(buf.dtype))
                buf[f:, n:].zero_()
            self.meta = FeatureMeta(*[
                self.keep(f"meta_{name}", x) for name, x in zip(
                    meta._fields, pad_meta(meta, self.features))])
            self.owner = owner
        return self._bufs["bins"], self.meta

    def feature_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """``mask`` [F] in the static [features] mask, False past F."""
        pad = mask.new_zeros(self.features - mask.shape[0])
        return self.keep("fmask", torch.cat([mask, pad]))

    def run_wave(self, k: int, fn) -> None:
        """Wave width ``k``'s work: its graph's replay, or on its first
        wave ``fn`` eagerly and then its capture (on the CPU, ``fn``)."""
        if self.device.type != "cuda":
            fn()
            return
        graph = self.graphs.get(k)
        if graph is not None:
            graph.replay()
            return
        t0 = time.perf_counter()
        fn()
        held = torch.cuda.memory_reserved(self.device)
        self.graphs[k] = capture_graph(fn, self.device, pool=self.pool)
        self.pool_bytes += max(
            torch.cuda.memory_reserved(self.device) - held, 0)
        step_cache.record_capture(time.perf_counter() - t0)


class WaveGrower:
    """Grows one tree per ``grow`` call from bins [F, N] on one device."""

    def __init__(self, cfg: WaveGrowerConfig, meta: FeatureMeta, device,
                 seams: Seams = Seams()):
        if cfg.quant_psum and (cfg.precision != "int8" or cfg.bundle_bins
                               or cfg.sparse_hist):
            raise ValueError("quant_psum needs the int8 tier on the "
                             "fused route")
        if cfg.forced and (cfg.count_proxy or cfg.packed4):
            raise ValueError("forced splits do not compose with the "
                             "count-proxy or packed4 tiers")
        if cfg.sparse_hist and (cfg.count_proxy or cfg.packed4):
            raise ValueError("sparse_hist does not compose with "
                             "count_proxy/packed4/quant_psum")
        if cfg.sparse_hist and cfg.bundle_bins:
            raise ValueError("the sparse tier does not compose with EFB "
                             "bundles")
        if cfg.bundle_bins and (cfg.count_proxy or cfg.packed4):
            raise ValueError("EFB bundles do not compose with the "
                             "count-proxy or packed4 tiers")
        if bool(cfg.bundle_bins) != meta.bundled:
            raise ValueError("bundle_bins needs the bundles' meta")
        self.cfg = cfg
        self.L = cfg.num_leaves
        self.W = min(cfg.wave_size, max(self.L - 1, 1))
        self.host_meta = meta
        self.meta = meta.to(device)
        self.device = device
        self.two_pass = bool(cfg.bundle_bins) or cfg.sparse_hist
        self.seams = seams

    def _hist(self, bins_t, hg, hh, ids, wl, scale, counted_rows, sparse):
        """[W, F, B, 3] histograms of the wave leaves ``wl`` on the
        two-pass routes, f32 (int8 sums dequantized by ``scale``): the
        sparse tier's
        scatter, or one K2 pass over the bundle columns expanded to the
        members (the JAX package's gbdt.py:759-767)."""
        cfg = self.cfg
        if cfg.sparse_hist:
            # int8 sums come back raw when ``scale`` is None
            return wave_histogram_sparse(
                sparse, hg, hh, ids, wl, cfg.num_bins,
                int(self.host_meta.num_bin.shape[0]), self.L,
                gh_scale=scale)
        bh = wave_histogram(bins_t, hg, hh, ids, wl, cfg.bundle_bins,
                            precision=cfg.precision, gh_scale=scale,
                            counted_rows=counted_rows)
        m = self.meta
        return expand_bundle_histogram(bh, m.bundle, m.offset, m.num_bin,
                                       m.default_bin, cfg.num_bins)

    def _partition(self, bins_t, leaf_ids, wl, new_ids, feat, tbin, dleft,
                   iscat, catw):
        """The two-pass routes' partition (the JAX package's
        ``apply_wave_splits``): each slot's right-side rows to its new
        leaf, its feature's column decoded as ``member_column`` does,
        every slot at once ([k, N]; a row matches at most one slot)."""
        m = self.meta
        col = bins_t[m.bundle[feat] if m.bundled else feat].to(torch.int32)
        db, nb = m.default_bin[feat][:, None], m.num_bin[feat][:, None]
        if m.bundled:
            off = m.offset[feat][:, None]
            col = torch.where((col >= off) & (col < off + nb), col - off, db)
        right = row_goes_right(col, tbin[:, None], dleft[:, None],
                               m.missing_type[feat][:, None], db, nb,
                               is_cat=iscat[:, None], cat_words=catw)
        moved = (leaf_ids[None, :] == wl[:, None]) & right
        slot = torch.argmax(moved.to(torch.uint8), dim=0)
        return torch.where(moved.any(dim=0), new_ids.to(torch.int32)[slot],
                           leaf_ids)

    def _depth_ok(self, depth: torch.Tensor) -> torch.Tensor:
        if self.cfg.max_depth > 0:
            return depth < self.cfg.max_depth
        return torch.ones_like(depth, dtype=torch.bool)

    def grow(self, bins_t: torch.Tensor, grad: torch.Tensor,
             hess: torch.Tensor, sample_mask: torch.Tensor,
             feature_mask: torch.Tensor, counted_rows=None, sparse=None,
             state: Optional[WaveState] = None, owner=None):
        """One tree. bins_t [F, N] (packed4: [ceil(F/2), N]); grad, hess,
        sample_mask [N] f32 (mask 0/1 from bagging); feature_mask [F]
        bool. Returns (TreeRecord, leaf ids [N] int32 of every row,
        out-of-bag rows included, for the score update).

        ``counted_rows``: the training rows, the first of the N; the
        columns past them are passengers (the valid sets' rows, the JAX
        package's gbdt.py:1165), whose grad, hess and sample_mask are 0:
        every split moves them and nothing counts them, and the f32
        passes keep the training rows' order of addition
        (``hist_wave.row_ranges``).

        ``bins_t`` holds the bundle columns under EFB; ``sparse``: the
        set's binned entries (codes, feat, row, zero_bins) under the
        sparse tier.

        ``state``: a step-cache entry (``WaveState``; the fused route
        without forced splits): the inputs pad to its rows as uncounted
        columns (``counted_rows`` must be given), ``owner``'s bins and
        metadata load into it when it held another's, the tree grows on
        its static tensors and its waves run as CUDA graphs; the record
        and leaf ids returned are copies."""
        cfg, meta, L, W = self.cfg, self.meta, self.L, self.W
        n_in = bins_t.shape[1]
        if state is not None:
            if self.two_pass or cfg.forced or counted_rows is None:
                raise ValueError("the step cache takes the fused route "
                                 "without forced splits, with counted rows")
            bins_t, meta = state.load(owner, bins_t, meta)
            grad = state.padded("grad", grad)
            hess = state.padded("hess", hess)
            sample_mask = state.padded("mask", sample_mask)
            feature_mask = state.feature_mask(feature_mask)
            keep = state.keep
        else:
            def keep(name, t):
                return t
        hp = cfg.hp
        B = cfg.num_bins
        dev = bins_t.device
        F = int(feature_mask.shape[0])
        n = bins_t.shape[1]
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        l1, l2, mds = _f32(hp.lambda_l1), _f32(hp.lambda_l2), \
            float(hp.max_delta_step)
        grad = grad.to(f32) * sample_mask
        hess = hess.to(f32) * sample_mask
        in_bag = sample_mask > 0
        proxy = cfg.count_proxy
        tier = dict(precision=cfg.precision, count_proxy=proxy,
                    packed4=cfg.packed4, num_features=F,
                    counted_rows=counted_rows)
        sm = self.seams
        red = sm.reduce_fn or _same
        hred = sm.hist_reduce_fn or _same
        if cfg.precision == "int8":
            q = quantize(grad, hess, sm.max_reduce_fn or _same, red,
                         sm.row_offset_fn(n) if sm.row_offset_fn else 0)
            hg, hh = keep("hg", q.gq), keep("hh", q.hq)
            scale = (keep("sg", q.sg), keep("sh", q.sh))
            qscale = keep("qscale", torch.stack([q.sg, q.sh,
                                                 torch.ones_like(q.sg)]))
        else:
            hg, hh = keep("hg", grad), keep("hh", hess)
            scale = None

        # root: one K2 pass over the in-bag rows (out-of-bag rows read
        # as leaf -1). The JAX package passes W slots with only slot 0
        # active; the other slots' histograms are zeros never read.
        leaf_ids = torch.zeros(n, dtype=i32, device=dev)
        root_ids = torch.where(in_bag, leaf_ids, -1)
        root_wl = torch.zeros(1, dtype=i32, device=dev)
        if self.two_pass:
            root_hist = hred(self._hist(bins_t, hg, hh, root_ids, root_wl,
                                        scale, counted_rows, sparse))
        elif cfg.quant_psum:
            # the quantized wire: raw integer sums cross the collective,
            # dequantized after it
            root_hist = dequantize(hred(wave_histogram(
                bins_t, hg, hh, root_ids, root_wl, B, **tier)), scale)
        else:
            root_hist = hred(wave_histogram(bins_t, hg, hh, root_ids, root_wl,
                                            B, gh_scale=scale, **tier))
        if scale is None:
            root_g = red(_stable_sum(grad))
            root_h = red(_stable_sum(hess))
            sums = (root_g[None], root_h[None])
        else:
            # dequantized sums of the integers the passes add: exact
            # (|sum| <= 127 n < 2^31, which the kernels' guard holds),
            # converted to f32 once; the split search takes the integer
            # sums and the scales (ops/split.py sum_scale)
            sums = (red(hg.to(i64).sum()).to(f32)[None],
                    red(hh.to(i64).sum()).to(f32)[None])
            root_g = sums[0][0] * scale[0]
            root_h = sums[1][0] * scale[1]
        root_c = red(sample_mask.sum())
        if proxy:
            root_hist = bound_counts(root_hist, *scale)

        def split(hists, sg, sh, nd, can, sum_scale=None):
            if sm.split_fn is not None:
                return sm.split_fn(hists, sg, sh, nd, feature_mask, can,
                                   sum_scale)
            return find_best_split(hists, sg, sh, nd, feature_mask, meta, hp,
                                   can, sum_scale=sum_scale)

        res = split(root_hist, *sums, root_c[None],
                    self._depth_ok(torch.zeros(1, dtype=i32, device=dev)),
                    sum_scale=scale)

        def table(fill, dtype, first, name):
            t = torch.full((L,), fill, dtype=dtype, device=dev)
            t[0] = first[0]
            return keep(name, t)

        pool = keep("pool", torch.zeros((L, F, B, 3), dtype=f32,
                                        device=dev))
        pool[0] = root_hist[0]
        leaf_ids = keep("leaf_ids", leaf_ids)
        t = {name: table(fill, dtype, getattr(res, name), "t_" + name)
             for name, fill, dtype in (
                 ("gain", KMIN_SCORE, f32), ("feature", 0, i32),
                 ("threshold_bin", 0, i32), ("default_left", False,
                                             torch.bool),
                 ("left_output", 0.0, f32), ("right_output", 0.0, f32),
                 ("left_count", 0.0, f32), ("right_count", 0.0, f32),
                 ("left_sum_g", 0.0, f32), ("left_sum_h", 0.0, f32),
                 ("right_sum_g", 0.0, f32), ("right_sum_h", 0.0, f32),
                 ("is_cat", False, torch.bool))}
        t["cat_words"] = keep("t_cat_words", torch.zeros(
            (L, NCAT_WORDS), dtype=i32, device=dev))
        t["cat_words"][0] = res.cat_words[0]
        leaf_output = keep("leaf_output", torch.zeros(L, dtype=f32,
                                                      device=dev))
        leaf_count = table(0.0, f32, root_c[None], "leaf_count")
        leaf_sum_g = table(0.0, f32, root_g[None], "leaf_sum_g")
        leaf_sum_h = table(0.0, f32, root_h[None], "leaf_sum_h")
        leaf_depth = keep("leaf_depth", torch.zeros(L, dtype=i32,
                                                    device=dev))
        rec = dict(
            split_leaf=torch.full((L - 1,), -1, dtype=i32, device=dev),
            split_feature=torch.full((L - 1,), -1, dtype=i32, device=dev),
            split_bin=torch.zeros(L - 1, dtype=i32, device=dev),
            split_gain=torch.zeros(L - 1, dtype=f32, device=dev),
            split_default_left=torch.zeros(L - 1, dtype=torch.bool,
                                           device=dev),
            internal_value=torch.zeros(L - 1, dtype=f32, device=dev),
            internal_count=torch.zeros(L - 1, dtype=f32, device=dev),
            split_is_cat=torch.zeros(L - 1, dtype=torch.bool, device=dev),
            split_cat_words=torch.zeros((L - 1, NCAT_WORDS), dtype=i32,
                                        device=dev))
        rec = {name: keep("rec_" + name, v) for name, v in rec.items()}
        num_leaves = 1

        # the forced prefix: a wave of one slot per forced split (the JAX
        # package's :926-1010, step for step)
        tiny, tiny2 = _f32(1e-15), _f32(2e-15)
        for fs_leaf, fs_feat, fs_bin in cfg.forced:
            wl = torch.tensor([fs_leaf], dtype=i64, device=dev)
            new_id = torch.tensor([num_leaves], dtype=i64, device=dev)
            leaf_ids.copy_(apply_split(
                leaf_ids, member_column(bins_t, fs_feat, self.host_meta),
                fs_leaf, num_leaves, fs_bin, False,
                meta.missing_type[fs_feat], meta.default_bin[fs_feat],
                meta.num_bin[fs_feat]))
            ids = torch.where(in_bag, leaf_ids, -1)
            if scale is None or cfg.bundle_bins:
                hist_left = hred(self._hist(bins_t, hg, hh, ids, wl.to(i32),
                                            scale, counted_rows, sparse)
                                 if self.two_pass else
                                 wave_histogram(bins_t, hg, hh, ids,
                                                wl.to(i32), B, **tier))
                hist_right = pool[wl] - hist_left
            else:
                # int8: the right child's subtraction fuses the
                # dequantization, as in the waves below
                raw = hred(self._hist(bins_t, hg, hh, ids, wl.to(i32), None,
                                      counted_rows, sparse)
                           if self.two_pass else
                           wave_histogram(bins_t, hg, hh, ids, wl.to(i32), B,
                                          **tier))
                hist_left = dequantize(raw, scale)
                hist_right = fma(raw.to(f32), -qscale, pool[wl])
            pool[wl] = hist_left
            pool[new_id] = hist_right
            # each row lies in one bin of any feature: the child sums
            # over feature 0's bins, in XLA's order
            lg, lh, lcnt = (xla_sum(hist_left[:, 0, :, c]) for c in range(3))
            pg, ph, pc = leaf_sum_g[wl], leaf_sum_h[wl], leaf_count[wl]
            rg, rh, rcnt = pg - lg, ph - lh, pc - lcnt
            gain = (_forced_gain(lg, lh + tiny, l1, l2, mds, True)
                    + _forced_gain(rg, rh + tiny, l1, l2, mds, True)
                    - _forced_gain(pg, ph + tiny2, l1, l2, mds, False))
            pos = num_leaves - 1
            rec["split_leaf"][pos] = fs_leaf
            rec["split_feature"][pos] = fs_feat
            rec["split_bin"][pos] = fs_bin
            rec["split_gain"][pos] = gain[0]
            rec["internal_value"][pos] = calculate_leaf_output(
                pg, ph, l1, l2, mds)[0]
            rec["internal_count"][pos] = pc[0]
            # an empty child gets output 0, not -0/0
            lo = torch.where(lcnt > 0, calculate_leaf_output(
                lg, lh + tiny, l1, l2, mds), 0.0)
            ro = torch.where(rcnt > 0, calculate_leaf_output(
                rg, rh + tiny, l1, l2, mds), 0.0)
            child_depth = leaf_depth[wl] + 1
            for arr, lv, rv in ((leaf_output, lo, ro),
                                (leaf_count, lcnt, rcnt),
                                (leaf_sum_g, lg, rg), (leaf_sum_h, lh, rh),
                                (leaf_depth, child_depth, child_depth)):
                arr[wl] = lv
                arr[new_id] = rv
            can = self._depth_ok(child_depth)
            res = split(
                torch.cat([hist_left, hist_right]), torch.cat([lg, rg]),
                torch.cat([lh, rh]), torch.cat([lcnt, rcnt]),
                torch.cat([can, can]))
            idx2 = torch.cat([wl, new_id])
            for name in t:
                v = getattr(res, name)
                if name == "gain":
                    v = torch.where(torch.isfinite(v), v, KMIN_SCORE)
                t[name][idx2] = v.to(t[name].dtype)
            num_leaves += 1

        # the waves: the leaf count on the device (``nl``), the election
        # into static tensors, one readback a wave (k)
        nl = keep("nl", torch.tensor(num_leaves, dtype=i64, device=dev))
        elected = (keep("order", torch.zeros(W, dtype=i64, device=dev)),
                   keep("top_gain", torch.zeros(W, dtype=f32, device=dev)),
                   keep("k", torch.zeros((), dtype=i64, device=dev)))

        # capture: ok(L, W) — the leaf budget and wave width, fields of
        # the grower's config, which the step key holds
        def elect():
            # the top-W leaves by gain (ties to the lower leaf id, as
            # lax.top_k), capped by the leaf budget; gains sort
            # descending, so the active slots are a prefix
            order = torch.sort(t["gain"], descending=True,
                               stable=True).indices[:W]
            top_gain = t["gain"][order]
            rank = torch.arange(order.shape[0], device=dev)
            active = (top_gain > 0.0) & (rank < L - nl)
            elected[0].copy_(order)
            elected[1].copy_(top_gain)
            elected[2].copy_(active.sum())

        # capture: ok(self, cfg, hp, B, proxy, tier, l1, l2,
        # counted_rows) — the grower and its config's fields, and the f32
        # row ranges of counted_rows: the step key holds them
        # (models/gbdt.py _step_pool)
        # capture: ok(in_bag, sparse) — the two-pass routes' alone, which
        # never run under a state (grow raises)
        # capture: ok(sm, red, hred, split) — the seams: a distributed
        # learner never takes the step cache (models/gbdt.py
        # _step_cache_eligible), and without seams they are the identity
        # and the default search
        def wave(k):
            wl = elected[0][:k]
            new_ids = nl + torch.arange(k, device=dev)

            # 2. per-slot split parameters
            feat = t["feature"][wl].to(i64)
            lcnt, rcnt = t["left_count"][wl], t["right_count"][wl]
            lg, lh = t["left_sum_g"][wl], t["left_sum_h"][wl]
            rg, rh = t["right_sum_g"][wl], t["right_sum_h"][wl]
            lo, ro = t["left_output"][wl], t["right_output"][wl]
            dleft = t["default_left"][wl]
            iscat, catw = t["is_cat"][wl], t["cat_words"][wl]

            # 3+4. partition and smaller-child histograms in one K1
            # call (or the two-pass routes' partition, then histograms);
            # siblings by subtraction from the parents' histograms
            left_smaller = lcnt <= rcnt
            small_ids = torch.where(left_smaller, wl, new_ids)
            # int8 with exact counts: raw sums, so that the sibling's
            # subtraction fuses the dequantization as XLA contracts
            # ``parent - hist * scale`` (one rounding); on the sparse
            # tier too, but not under bundles, which expand in f32. A
            # collective of f32 histograms (the int8 tier without the
            # quantized wire) takes them dequantized, and the sibling
            # is an unfused subtraction, as in the JAX package's learner
            fuse_sub = (scale is not None and not proxy
                        and not cfg.bundle_bins
                        and (sm.hist_reduce_fn is None or cfg.quant_psum))
            raw_out = fuse_sub or cfg.quant_psum
            if self.two_pass:
                leaf_ids.copy_(self._partition(
                    bins_t, leaf_ids, wl, new_ids, feat,
                    t["threshold_bin"][wl], dleft, iscat, catw))
                hist_small = hred(self._hist(
                    bins_t, hg, hh, torch.where(in_bag, leaf_ids, -1),
                    small_ids.to(i32), None if fuse_sub else scale,
                    counted_rows, sparse))
            else:
                tbl = torch.stack([x.to(i32) for x in (
                    wl, new_ids, feat, t["threshold_bin"][wl], dleft,
                    meta.missing_type[feat], meta.default_bin[feat],
                    meta.num_bin[feat], small_ids)])      # TBL_* rows
                if hp.has_cat:
                    tbl = torch.cat([tbl, iscat.to(i32)[None], catw.T])
                out = fused_partition_histogram(
                    bins_t, hg, hh, sample_mask, leaf_ids, tbl, B,
                    gh_scale=None if raw_out else scale,
                    any_cat=hp.has_cat, **tier)
                leaf_ids.copy_(out[0])
                hist_small = hred(out[1])
            if raw_out:
                raw = hist_small
                hist_small = dequantize(raw, scale)
            if proxy:
                # exact child counts from the partition; the count
                # channel holds lower bounds, which do not survive the
                # subtraction: each child's is recomputed from its own
                # g/h sums
                cnt_r = red(out[2])
                lcnt_x = leaf_count[wl] - cnt_r
                rcnt_x = cnt_r
                hist_small = bound_counts(hist_small, *scale)
            else:
                lcnt_x, rcnt_x = lcnt, rcnt
            if fuse_sub:
                hist_large = fma(raw.to(f32), -qscale, pool[wl])
            else:
                hist_large = pool[wl] - hist_small
            if proxy:
                hist_large = bound_counts(hist_large, *scale)
            ls4 = left_smaller[:, None, None, None]
            hist_left = torch.where(ls4, hist_small, hist_large)
            hist_right = torch.where(ls4, hist_large, hist_small)
            pool[wl] = hist_left
            pool[new_ids] = hist_right

            # 5. record the wave's splits after the num_leaves - 1 so far
            pos = new_ids - 1
            rec["split_leaf"][pos] = wl.to(i32)
            rec["split_feature"][pos] = feat.to(i32)
            rec["split_bin"][pos] = t["threshold_bin"][wl]
            rec["split_gain"][pos] = elected[1][:k]
            rec["split_default_left"][pos] = dleft
            rec["split_is_cat"][pos] = iscat
            rec["split_cat_words"][pos] = catw
            rec["internal_value"][pos] = calculate_leaf_output(
                leaf_sum_g[wl], leaf_sum_h[wl], l1, l2, mds)
            rec["internal_count"][pos] = leaf_count[wl]

            # 6. per-leaf aggregates (the left child keeps the parent id)
            child_depth = leaf_depth[wl] + 1
            for arr, lv, rv in ((leaf_output, lo, ro),
                                (leaf_count, lcnt_x, rcnt_x),
                                (leaf_sum_g, lg, rg), (leaf_sum_h, lh, rh),
                                (leaf_depth, child_depth, child_depth)):
                arr[wl] = lv
                arr[new_ids] = rv

            # 7. best splits of the 2k children
            can = self._depth_ok(child_depth)
            res = split(
                torch.cat([hist_left, hist_right]), torch.cat([lg, rg]),
                torch.cat([lh, rh]), torch.cat([lcnt_x, rcnt_x]),
                torch.cat([can, can]))
            idx2 = torch.cat([wl, new_ids])
            for name in t:
                v = getattr(res, name)
                if name == "gain":
                    v = torch.where(torch.isfinite(v), v, KMIN_SCORE)
                t[name][idx2] = v.to(t[name].dtype)
            nl.add_(k)
            elect()

        elect()
        while num_leaves < L:
            k = int(elected[2])               # the one readback per wave
            if k == 0:
                break
            if state is None:
                wave(k)
            else:
                state.run_wave(k, lambda: wave(k))
            num_leaves += k

        if state is not None:
            # the static tensors are the next tree's
            leaf_ids = leaf_ids[:n_in].clone()
            leaf_output, leaf_count, leaf_sum_g, leaf_sum_h = (
                x.clone() for x in (leaf_output, leaf_count, leaf_sum_g,
                                    leaf_sum_h))
            rec = {name: v.clone() for name, v in rec.items()}
        record = TreeRecord(num_leaves=num_leaves, leaf_output=leaf_output,
                            leaf_count=leaf_count, leaf_sum_g=leaf_sum_g,
                            leaf_sum_h=leaf_sum_h, **rec)
        return record, leaf_ids
