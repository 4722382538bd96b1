"""Fault P (ROADMAP queue 3): the f32 histogram pass's order of addition
on a one-hot column.

The kernels (csrc/hist_wave.cu ``group_histogram_kernel``) add each
cell's rows of a row range in row order. Until the repair the running
sum was f32: a range holds up to ~10^5 rows of a cell, and in binary
logloss's first iteration g takes two values, so each rounding leans the
same way, and a one-hot column's zero bin, which holds nearly every row,
takes the whole drift. The pass now adds g and h in float64 from 0.0 and
rounds a range's sums once to f32; the ranges' f32 partials are added in
float64 and rounded once. ``hist_wave.scatter_in_ranges`` is that order
on the CPU, bit for bit (the card tests and chip_smoke.py hold the
kernels to it).

The data: one one-hot column of 300,000 rows, 1% of them in bin 1, whose
labels are all 1; bin 0's labels are 1 at a rate of 0.45; g = p - y and
h = p (1 - p) at the average's probability p, as binary logloss's
iteration 0 gives them. Bin 0's sums (float64): g 1,598.52, h 73,678.80.

- The order of the parent (one f32 running sum over a range; with one
  range of all the rows it is ``_scatter_hist3`` in f32) misses the bar
  of 1e-5 relative by orders of magnitude: g 2.98e-3, h 2.59e-3.
- The new order, one range of all the rows: g 3.8e-8 and h 3.9e-8 of
  float64, within 1e-5.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_wave as hw

pytestmark = pytest.mark.torch_port

REL = 1e-5
N = 300_000


def _one_hot(n=N, one_rate=0.01, rate=0.45, seed=7):
    """[1, n] bins of one one-hot column and binary logloss's iteration-0
    g and h for labels that are 1 on every bin-1 row and at ``rate`` on
    bin 0."""
    r = np.random.default_rng(seed)
    col = (r.random(n) < one_rate).astype(np.uint8)
    y = np.where(col == 1, 1.0, r.random(n) < rate).astype(np.float32)
    mean = float(y.mean())
    p = np.float32(1.0 / (1.0 + np.exp(-np.log(mean / (1.0 - mean)))))
    g = (p - y).astype(np.float32)
    h = np.full(n, p * (np.float32(1.0) - p), np.float32)
    return (torch.from_numpy(col[None]), torch.from_numpy(g),
            torch.from_numpy(h))


def _rel(got, ref):
    """|got - ref| / |ref| of bin 0's g and h sums."""
    return ((got[0, 0, 0, :2].double() - ref[0, 0, 0, :2]).abs()
            / ref[0, 0, 0, :2].abs()).tolist()


def _float64(bins, g, h):
    base = torch.zeros(bins.shape[1], dtype=torch.int64)
    return hw._scatter_hist3(bins, g.double(), h.double(), base, 2, 1)


@pytest.mark.parametrize("one_rate,rate,seed", [
    (0.01, 0.45, 7), (0.01, 0.02, 8), (0.05, 0.25, 9)])
def test_one_range_within_1e5_of_float64(one_rate, rate, seed):
    """One range of all 300,000 rows in the kernels' order: bin 0's g
    and h sums within 1e-5 relative of float64, counts exact."""
    bins, g, h = _one_hot(one_rate=one_rate, rate=rate, seed=seed)
    base = torch.zeros(N, dtype=torch.int64)
    got = hw.scatter_in_ranges(bins, g, h, base, 2, 1, (1, N))
    ref = _float64(bins, g, h)
    assert max(_rel(got, ref)) <= REL, _rel(got, ref)
    assert torch.equal(got[..., 2].double(), ref[..., 2])


def test_parent_order_misses_the_bar():
    """The parent's order (an f32 running sum over the range, which for
    one range is ``_scatter_hist3`` in f32, the XLA order) on the same
    data: more than 100 times the bar on both g and h."""
    bins, g, h = _one_hot()
    base = torch.zeros(N, dtype=torch.int64)
    old = hw._scatter_hist3(bins, g, h, base, 2, 1)
    ref = _float64(bins, g, h)
    rel = _rel(old, ref)
    assert min(rel) > 100 * REL, rel
    new = hw.scatter_in_ranges(bins, g, h, base, 2, 1, (1, N))
    assert max(_rel(new, ref)) * 100 < min(rel)


@pytest.mark.parametrize("W", [1, 4])
def test_planned_ranges_within_1e5_through_k1_and_k2(W):
    """The plain K2 and K1 in the kernels' order over the ranges the plan
    gives (``row_ranges``, many ranges here): every slot's bin-0 sums
    within 1e-5 relative of float64."""
    bins, g, h = _one_hot()
    assert hw.row_ranges(N, 1, W, 2)[0] > 1
    leaf = torch.arange(N, dtype=torch.int32) % W
    wl = torch.arange(W, dtype=torch.int32)
    got = hw.wave_histogram_plain(bins, g, h, leaf, wl, 2, kernel_order=True)
    ref = hw.wave_histogram_plain(bins, g.double(), h.double(), leaf, wl, 2)
    for w in range(W):
        assert max(_rel(got[w:w + 1], ref[w:w + 1])) <= REL
    assert torch.equal(got[..., 2].double(), ref[..., 2])
    # K1: every slot splits feature 0 at bin 0 and counts its left child
    # (the bin-0 rows, which keep the parent's leaf id)
    tbl = torch.zeros((hw.TBL_ROWS_NUM, W), dtype=torch.int32)
    tbl[hw.TBL_PARENT] = wl
    tbl[hw.TBL_NEW] = wl + W
    tbl[hw.TBL_SMALL] = wl
    tbl[hw.TBL_NUMBIN] = 2
    mask = torch.ones(N)
    _, k1 = hw.fused_partition_histogram_plain(bins, g, h, mask, leaf, tbl,
                                               2, kernel_order=True)
    _, k1_64 = hw.fused_partition_histogram_plain(
        bins, g.double(), h.double(), mask, leaf, tbl, 2)
    assert bool((k1[..., 1, :] == 0).all())
    diff = (k1[..., 0, :2].double() - k1_64[..., 0, :2]).abs()
    assert bool((diff <= REL * k1_64[..., 0, :2].abs()).all())


def test_order_is_a_pure_function_of_the_shapes():
    """``row_ranges`` and the plan depend on the shapes alone: equal for
    two data sets of one shape, the counted rows' ranges kept with
    passengers behind them, and the training rows' sums bit-equal with
    and without the passengers."""
    bins, g, h = _one_hot()
    plan = hw.hist_plan(N, 1, 1, 2)
    assert plan == hw.hist_plan(N, 1, 1, 2)
    nv = 40_000
    R, per = hw.row_ranges(N, 1, 1, 2)
    Rc, perc = hw.row_ranges(N + nv, 1, 1, 2, counted=N)
    assert (R, per) == (plan.ranges, plan.rows_per_range)
    assert perc == per and Rc * per >= N + nv > (Rc - 1) * per
    pb, pg, ph = _one_hot(nv, seed=11)
    cb, cg, ch = (torch.cat([bins, pb], 1), torch.cat([g, 0 * pg]),
                  torch.cat([h, 0 * ph]))
    leaf = torch.zeros(N, dtype=torch.int32)
    cleaf = torch.cat([leaf, torch.full((nv,), -1, dtype=torch.int32)])
    wl = torch.zeros(1, dtype=torch.int32)
    alone = hw.wave_histogram_plain(bins, g, h, leaf, wl, 2,
                                    kernel_order=True)
    ride = hw.wave_histogram_plain(cb, cg, ch, cleaf, wl, 2,
                                   kernel_order=True, counted_rows=N)
    assert torch.equal(alone, ride)
    # another data set of the same shape takes the same ranges
    other = _one_hot(seed=12)
    assert hw.row_ranges(other[0].shape[1], 1, 1, 2) == (R, per)
