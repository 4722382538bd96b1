"""Exclusive Feature Bundling (EFB).

The JAX package's ``io/efb.py`` (reference Dataset::FindGroups and
FastFeatureBundling, src/io/dataset.cpp:66-210; NIPS'17 LightGBM paper
§4). Mutually exclusive sparse features share one column of the device's
bin matrix: member k owns the bin range [offset_k, offset_k + num_bin_k)
of its bundle, and the column value 0 means "every member at its default
bin". A bundle of one feature keeps that feature's own bins.

- ``find_bundles``, ``would_bundle``, ``sample_rows_for_probe`` and the
  host ``bundle_bins`` are the JAX package's host code, copied: the
  grouping is decided on the host from a sample of binned rows, the same
  rng(3) sample in both packages, so both bundle alike;
- ``bundle_bins_device`` and ``bundle_bins_sparse`` encode the bundle
  columns on the device from the [F, N] member bins or from the explicit
  entries of a sparse matrix: the host ``bundle_bins``' integers, later
  members winning the conflicts as dataset.cpp:186-199 merges them;
- ``expand_bundle_histogram`` turns bundle histograms into member
  histograms: a gather of each member's range, and at its default bin
  the complement, the bundle's row total minus the member's other bins
  (the most-frequent-bin trick of dense_bin.hpp), added in the order XLA
  reduces the JAX package's two sums on the CPU (``xla_sum``).

The partition decodes a member from its bundle column
(ops/partition.py ``member_column``). Split search, records and host
trees keep the original member features and bin spaces.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.f32math import xla_sum

EFB_SAMPLE_CNT = 50_000


def sample_rows_for_probe(n: int):
    """Row indices ``find_bundles`` draws from an n-row bin matrix (the
    same rng(3), the same count), or None when it uses every row."""
    if n > EFB_SAMPLE_CNT:
        return np.random.default_rng(3).choice(n, EFB_SAMPLE_CNT,
                                               replace=False)
    return None


def would_bundle(sample_bins: np.ndarray, mappers,
                 max_conflict_rate: float) -> bool:
    """True iff ``find_bundles`` on the whole matrix would bundle
    anything, decided from the rows ``sample_rows_for_probe`` selected,
    binned ([sn, F] host bins)."""
    if sample_bins.shape[1] <= 1:
        return False
    db = np.array([m.default_bin for m in mappers], np.int32)
    nb = np.array([m.num_bin for m in mappers], np.int32)
    bundles = find_bundles(sample_bins, db, nb, max_conflict_rate,
                           presampled=True)
    return len(bundles) < sample_bins.shape[1]


def find_bundles(bins: np.ndarray, default_bins: np.ndarray,
                 num_bins: np.ndarray, max_conflict_rate: float,
                 sample_cnt: int = EFB_SAMPLE_CNT,
                 max_bundle_bins: int = 255,
                 presampled: bool = False) -> List[List[int]]:
    """Greedy conflict-bounded grouping (Dataset::FindGroups,
    dataset.cpp:66-159) of host bins [N, F]: features by descending
    non-default count; each joins the first bundle whose conflicts stay
    within ``max_conflict_rate * n`` and whose bins fit. ``presampled``:
    ``bins`` already is the rng(3) row sample."""
    n, f = bins.shape
    if f <= 1:
        return [[j] for j in range(f)]
    if n > sample_cnt and not presampled:
        idx = np.random.default_rng(3).choice(n, sample_cnt,
                                              replace=False)
        sample = bins[idx]
    else:
        sample = bins
    sn = sample.shape[0]
    nondefault = sample != default_bins[None, :]      # [sn, F] bool
    counts = nondefault.sum(axis=0)
    order = np.argsort(-counts, kind="stable")
    max_conflict = int(max_conflict_rate * sn)

    bundle_masks: List[np.ndarray] = []
    bundle_conflicts: List[int] = []
    bundle_bins_total: List[int] = []
    bundles: List[List[int]] = []
    for j in order:
        placed = False
        fj = nondefault[:, j]
        width = int(num_bins[j])
        for bi in range(len(bundles)):
            conflict = int((bundle_masks[bi] & fj).sum())
            if (bundle_conflicts[bi] + conflict <= max_conflict
                    and bundle_bins_total[bi] + width
                    <= max_bundle_bins):
                bundles[bi].append(int(j))
                bundle_masks[bi] |= fj
                bundle_conflicts[bi] += conflict
                bundle_bins_total[bi] += width
                placed = True
                break
        if not placed:
            bundles.append([int(j)])
            bundle_masks.append(fj.copy())
            bundle_conflicts.append(0)
            bundle_bins_total.append(width)
    # member order stays stable inside each bundle
    return [sorted(b) for b in bundles]


def bundle_layout(bundles: Sequence[Sequence[int]], num_bins,
                  num_features: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(member_bundle [F], member_offset [F], widest bundle's bins): a
    bundle of several members starts its first at offset 1 (0 is the
    all-default value); a bundle of one keeps its member's bins."""
    member_bundle = np.zeros(num_features, np.int32)
    member_offset = np.zeros(num_features, np.int32)
    width = 1
    for bi, members in enumerate(bundles):
        if len(members) == 1:
            j = members[0]
            member_bundle[j] = bi
            width = max(width, int(num_bins[j]))
            continue
        off = 1
        for j in members:
            member_bundle[j] = bi
            member_offset[j] = off
            off += int(num_bins[j])
        width = max(width, off)
    return member_bundle, member_offset, width


def bundle_bins(bins: np.ndarray, bundles: List[List[int]],
                default_bins: np.ndarray, num_bins: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host member bins [N, F] -> (bundled [N, F_b], member_bundle [F],
    member_offset [F], widest bundle's bins). Member k at a non-default
    bin b writes offset_k + b; later members win the conflicts."""
    n, f = bins.shape
    member_bundle, member_offset, width = bundle_layout(bundles, num_bins,
                                                        f)
    out = np.zeros((n, len(bundles)),
                   bins.dtype if width <= 256 else np.int32)
    for bi, members in enumerate(bundles):
        if len(members) == 1:
            out[:, bi] = bins[:, members[0]]
            continue
        col = np.zeros(n, np.int64)
        for j in members:
            nd = bins[:, j] != default_bins[j]
            col[nd] = member_offset[j] + bins[nd, j]
        out[:, bi] = col.astype(out.dtype)
    return out, member_bundle, member_offset, width


def _bundled_dtype(member_dtype: torch.dtype, width: int) -> torch.dtype:
    return member_dtype if width <= 256 else torch.int32


def bundle_bins_device(bins_t: torch.Tensor, bundles: List[List[int]],
                       default_bins, num_bins
                       ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, int]:
    """``bundle_bins`` of the device's member bins [F, N]: (bundled
    [F_b, N] on the same device, member_bundle, member_offset, width),
    the host version's integers."""
    f, n = bins_t.shape
    member_bundle, member_offset, width = bundle_layout(bundles, num_bins,
                                                        f)
    out = torch.empty((len(bundles), n),
                      dtype=_bundled_dtype(bins_t.dtype, width),
                      device=bins_t.device)
    for bi, members in enumerate(bundles):
        if len(members) == 1:
            out[bi] = bins_t[members[0]].to(out.dtype)
            continue
        col = torch.zeros(n, dtype=torch.int32, device=bins_t.device)
        for j in members:
            b = bins_t[j].to(torch.int32)
            col = torch.where(b != int(default_bins[j]),
                              b + int(member_offset[j]), col)
        out[bi] = col.to(out.dtype)
    return out, member_bundle, member_offset, width


def bundle_bins_sparse(n: int, codes: torch.Tensor, bounds: np.ndarray,
                       rows: torch.Tensor, zero_bins, bundles,
                       default_bins, num_bins, member_dtype: torch.dtype
                       ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, int]:
    """``bundle_bins_device`` of a sparse set's member bins without
    building them: feature j's cells are ``zero_bins[j]`` except at its
    explicit entries, ``codes`` and ``rows`` [E] (device) in the slice
    ``bounds[j]:bounds[j + 1]``. A member whose implicit bin is its
    default writes only its non-default entries; one whose implicit bin
    is not (a categorical feature without category 0) is built whole."""
    f = len(bounds) - 1
    member_bundle, member_offset, width = bundle_layout(bundles, num_bins,
                                                        f)
    dev = codes.device
    out = torch.empty((len(bundles), n),
                      dtype=_bundled_dtype(member_dtype, width), device=dev)

    def member(j):
        col = torch.full((n,), int(zero_bins[j]), dtype=torch.int32,
                         device=dev)
        sl = slice(int(bounds[j]), int(bounds[j + 1]))
        col[rows[sl]] = codes[sl]
        return col

    for bi, members in enumerate(bundles):
        if len(members) == 1:
            out[bi] = member(members[0]).to(out.dtype)
            continue
        col = torch.zeros(n, dtype=torch.int32, device=dev)
        for j in members:
            off, db = int(member_offset[j]), int(default_bins[j])
            if int(zero_bins[j]) != db:
                b = member(j)
                col = torch.where(b != db, b + off, col)
                continue
            sl = slice(int(bounds[j]), int(bounds[j + 1]))
            c = codes[sl]
            nd = c != db
            col[rows[sl][nd]] = c[nd] + off
        out[bi] = col.to(out.dtype)
    return out, member_bundle, member_offset, width


def expand_bundle_histogram(bundle_hist: torch.Tensor, member_bundle,
                            member_offset, member_num_bin,
                            member_default_bin, B_out: int) -> torch.Tensor:
    """[..., F_b, B_b, C] f32 bundle histograms -> member histograms
    [..., F, B_out, C]: each member's bins gathered from its range
    (zero past its num_bin and at its default bin), then at the default
    bin the bundle's total minus the member's other bins. The two sums
    over bins add in XLA's CPU order (``xla_sum``), so the members'
    histograms are the JAX package's bits."""
    dev = bundle_hist.device
    mb, mo, nb, db = (torch.as_tensor(a, device=dev).to(torch.int64)
                      for a in (
                          member_bundle, member_offset, member_num_bin,
                          member_default_bin))
    Bb = bundle_hist.shape[-2]
    lead = bundle_hist.shape[:-3]
    bidx = torch.arange(B_out, device=dev)[None, :]           # [1, B]
    src = (mo[:, None] + bidx).clamp(0, Bb - 1)               # [F, B]
    valid = (bidx < nb[:, None]) & (bidx != db[:, None])
    at_default = bidx == db[:, None]
    per_bundle = bundle_hist[..., mb, :, :]                   # [..., F, Bb, C]
    idx = src[(None,) * len(lead) + (slice(None), slice(None), None)]
    idx = idx.expand(*lead, -1, -1, bundle_hist.shape[-1])
    member = torch.gather(per_bundle, -2, idx)                # [..., F, B, C]
    member = member * valid.to(member.dtype)[..., None]
    tot = xla_sum(bundle_hist.transpose(-1, -2))[..., mb, :]  # [..., F, C]
    rest = xla_sum(member.transpose(-1, -2))
    comp = (tot - rest)[..., None, :]
    return member + comp * at_default.to(member.dtype)[..., None]
