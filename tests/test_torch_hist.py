"""Port parity: lightgbm_tpu_torch.ops.hist_wave (K2, K1) and
ops.predict (K3) against lightgbm_tpu.ops.

Bars: on the CPU the plain versions are bit-equal to the JAX package's
XLA formulations (``wave_histogram_xla``, ``fused_partition_histogram_xla``,
``add_leaf_outputs``): ``index_add_`` adds each histogram cell in row
order, as XLA's scatter does, and the score update with a shrinkage
rounds once, as XLA contracts ``scores + shrink * table[leaf]`` into a
fused multiply-add. The int8 and packed variants are held in
test_torch_quant.py. K3 is compared on in-range leaf
ids only, the two JAX paths disagree outside. The f32 kernels' launch
plan (``hist_plan``: feature groups, slot classes, row ranges) is
checked here on the CPU: it covers every (feature, row) once and fits
a block's shared memory, and the plain version in the kernels' order of
addition stays within the f32 summation bound of the JAX oracle; so is
the int8 pass's (``int_plan``: feature groups, slot classes, cell
copies, row parts), which takes every (feature, row, slot) once. The
kernels run only on a CUDA card: the tests that hold them against the
plain versions skip without one (on a card without JAX:
``pytest --noconftest tests/test_torch_hist.py -k "kernel and not jax"``).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from lightgbm_tpu.ops.hist_wave import (fused_partition_histogram_xla,
                                            wave_histogram_xla)
    from lightgbm_tpu.ops.predict import \
        add_leaf_outputs as j_add_leaf_outputs
except ImportError:
    # a machine with a card and no JAX runs the card tests alone:
    # pytest --noconftest tests/test_torch_hist.py -k "kernel and not jax"
    jnp = None
from lightgbm_tpu_torch.ops import hist_wave as hw
from lightgbm_tpu_torch.ops import predict as pr
from lightgbm_tpu_torch.utils.log import LightGBMError

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread a test worker, restored after: under parallel
    workers on a shared CPU, each small op's thread pool only contends
    (as in test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(F, n, B, W, seed, nb=None):
    r = np.random.default_rng(seed)
    nb = np.full(F, B) if nb is None else nb
    bins = np.stack([r.integers(0, nb[f], n) for f in range(F)]) \
        .astype(np.uint8)
    g = r.normal(size=n).astype(np.float32)
    h = (r.random(n) * 0.25).astype(np.float32)
    mask = (r.random(n) < 0.8).astype(np.float32)
    leaf = r.integers(0, 2 * W + 2, n).astype(np.int32)
    return r, bins, g * mask, h * mask, mask, leaf


def _split_table(r, F, B, W, leaf_hi, active):
    """Per-slot split fields of a wave: W slots, ``active`` of them live
    (the rest parent -1), parents distinct leaves below ``leaf_hi``."""
    wl = np.full(W, -1, np.int32)
    wl[:active] = r.choice(leaf_hi, active, replace=False)
    new_ids = np.where(wl >= 0, leaf_hi + np.arange(W), -1).astype(np.int32)
    feat = r.integers(0, F, W).astype(np.int32)
    tbin = r.integers(0, B - 1, W).astype(np.int32)
    dleft = r.integers(0, 2, W).astype(np.int32)
    miss = r.integers(0, 3, W).astype(np.int32)
    defb = r.integers(0, B, W).astype(np.int32)
    nb = np.full(W, B, np.int32)
    small = np.where(r.random(W) < 0.5, wl, new_ids).astype(np.int32)
    small[active:] = -1
    return dict(wl=wl, new_ids=new_ids, feat=feat, tbin=tbin, dleft=dleft,
                miss=miss, defb=defb, nb=nb, small=small)


def _tbl(t):
    return torch.from_numpy(np.stack([
        t["wl"], t["new_ids"], t["feat"], t["tbin"], t["dleft"], t["miss"],
        t["defb"], t["nb"], t["small"]]).astype(np.int32))


@pytest.mark.parametrize("F,n,B,W", [(3, 500, 16, 1), (6, 3000, 64, 4),
                                     (5, 2000, 256, 8), (4, 1000, 64, 32)])
def test_wave_histogram_plain_bit_equal(F, n, B, W):
    r, bins, g, h, mask, leaf = _inputs(F, n, B, W, seed=F * n)
    leaf = np.where(mask > 0, leaf, -1).astype(np.int32)   # out of bag
    wl = r.choice(2 * W + 2, W, replace=False).astype(np.int32)
    wl[W // 2] = -1                      # an inactive slot gives zeros
    want = np.asarray(wave_histogram_xla(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(leaf), jnp.asarray(wl), num_bins=B))
    got = hw.wave_histogram(torch.from_numpy(bins), torch.from_numpy(g),
                            torch.from_numpy(h), torch.from_numpy(leaf),
                            torch.from_numpy(wl), B)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[W // 2].any()


@pytest.mark.parametrize("F,n,B,W,active", [
    (3, 600, 16, 1, 1), (6, 3000, 64, 4, 3), (5, 2500, 256, 8, 8),
    (4, 1500, 64, 32, 20)])
def test_fused_partition_histogram_plain_bit_equal(F, n, B, W, active):
    r, bins, g, h, mask, leaf = _inputs(F, n, B, W, seed=7 * n + W)
    t = _split_table(r, F, B, W, 2 * W + 2, active)
    want_leaf, want_hist = fused_partition_histogram_xla(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(mask), jnp.asarray(leaf), jnp.asarray(t["wl"]),
        jnp.asarray(t["new_ids"]), jnp.asarray(t["feat"]),
        jnp.asarray(t["tbin"]), jnp.asarray(t["dleft"] != 0),
        jnp.zeros(W, bool), jnp.zeros((W, 8), jnp.int32),
        jnp.asarray(t["small"]), jnp.asarray(t["miss"]),
        jnp.asarray(t["defb"]), jnp.asarray(t["nb"]), num_bins=B)
    got_leaf, got_hist = hw.fused_partition_histogram(
        torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(mask), torch.from_numpy(leaf), _tbl(t), B)
    np.testing.assert_array_equal(got_leaf.numpy(), np.asarray(want_leaf))
    np.testing.assert_array_equal(got_hist.numpy(), np.asarray(want_hist))
    # rows moved: at least one slot split something
    assert (got_leaf.numpy() != leaf).any()


@pytest.mark.parametrize("L,n", [(2, 100), (31, 5000), (255, 20000)])
def test_leaf_gather_add_plain_bit_equal(L, n):
    r = np.random.default_rng(L)
    scores = r.normal(size=n).astype(np.float32)
    leaf = r.integers(0, L, n).astype(np.int32)
    out = r.normal(size=L).astype(np.float32)
    shrink = np.float32(0.1)
    table = out * shrink                       # the folded table
    want = np.asarray(j_add_leaf_outputs(jnp.asarray(scores),
                                         jnp.asarray(leaf),
                                         jnp.asarray(table), 1.0))
    got = pr.add_leaf_outputs(torch.from_numpy(scores.copy()),
                              torch.from_numpy(leaf),
                              torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    # the shrinkage fused into the add: XLA's contraction, one rounding
    want = np.asarray(j_add_leaf_outputs(jnp.asarray(scores),
                                         jnp.asarray(leaf),
                                         jnp.asarray(out), shrink))
    got = pr.add_leaf_outputs(torch.from_numpy(scores.copy()),
                              torch.from_numpy(leaf),
                              torch.from_numpy(out), float(shrink))
    np.testing.assert_array_equal(got.numpy(), want)


def test_leaf_gather_out_of_range_adds_nothing():
    scores = torch.tensor([1.0, 2.0, 3.0, 4.0])
    leaf = torch.tensor([-1, 0, 2, 5], dtype=torch.int32)
    got = pr.add_leaf_outputs(scores, leaf, torch.tensor([10.0, 20.0, 30.0]))
    assert got.tolist() == [1.0, 12.0, 33.0, 4.0]


def test_row_ranges_cover_every_row():
    for n, F, W, B in ((1, 1, 1, 16), (1000, 28, 32, 64),
                       (11_000_000, 28, 32, 64), (1_000_000, 53, 15, 256),
                       (5000, 2000, 1, 256), (0, 4, 1, 16)):
        ranges, per = hw.row_ranges(n, F, W, B)
        assert ranges * per >= n > (ranges - 1) * per or n == ranges - 1 == 0
        assert per % hw.TILE_ROWS == 0
        p = hw.int_plan(n, F, W, B, 3, False)
        ranges, per = p.parts, p.rows_per_part
        assert ranges * per >= n > (ranges - 1) * per or n == ranges - 1 == 0


def _covered(plan, n, F):
    """[F, n] counts of the work items (feature group, row range) of a
    launch plan that take each (feature, row)."""
    cover = np.zeros((F, n), np.int32)
    for q in range(plan.groups * plan.ranges):
        r, grp = divmod(q, plan.groups)
        f0 = grp * plan.fg
        cover[f0:f0 + plan.fg, r * plan.rows_per_range:
              (r + 1) * plan.rows_per_range] += 1
    return cover


@pytest.mark.parametrize("n,F,W,B", [
    (1, 1, 1, 16), (5000, 3, 1, 16), (300_000, 7, 16, 64),
    (200_003, 5, 64, 256), (100_000, 28, 32, 64), (60_000, 53, 15, 256),
    (120_000, 8, 32, 256), (70_000, 28, 1, 64), (90_001, 9, 24, 16)])
def test_hist_plan_covers_every_feature_and_row_once(n, F, W, B):
    p = hw.hist_plan(n, F, W, B)
    assert (_covered(p, n, F) == 1).all()
    assert p.warps in hw.WARP_COUNTS and p.warps >= p.fg * p.classes
    assert p.warps < 2 * p.fg * p.classes or p.warps == hw.WARP_COUNTS[0]
    assert p.classes & (p.classes - 1) == 0 and p.classes <= max(W, 1)
    assert p.groups == -(-F // p.fg)
    assert (p.ranges, p.rows_per_range) == hw.row_ranges(n, F, W, B)


@pytest.mark.parametrize("n,F,W,B", [
    (11_000_000, 28, 32, 64), (11_000_000, 28, 1, 64),
    (1_000_000, 52, 15, 256), (10_000_000, 8, 32, 256),
    (10_000_000, 8, 1, 256), (11_000_000, 28, 32, 16)])
def test_hist_plan_at_the_main_path_shapes(n, F, W, B):
    """The main path's launches: whole groups and ranges, every SM given
    work items (at least one per block the plan's estimate holds
    resident), and partial tiles no heavier than the rows' own bytes."""
    p = hw.hist_plan(n, F, W, B)
    assert p.groups * p.fg >= F > (p.groups - 1) * p.fg
    assert p.ranges * p.rows_per_range >= n > \
        (p.ranges - 1) * p.rows_per_range
    resident = hw._blocks_per_sm(p.smem, p.warps) * hw.NUM_SMS
    assert p.groups * p.ranges >= resident
    assert p.ranges * F * W * B * 12 <= n * (F + 12)


@pytest.mark.parametrize("F", [1, 3, 28, 53])
def test_hist_plan_fits_shared_memory(F):
    """Every (W, B) the wrappers accept (1 <= W <= 64, 1 <= B <= 256;
    packed bins take B <= 16 and the same plan): the block's shared
    memory, for its part of the slots, fits the card's 232,448 bytes and
    at least one block fits an SM."""
    for W in range(1, hw.MAX_WAVE + 1):
        for B in range(1, hw.MAX_BINS + 1):
            p = hw.hist_plan(1_000_000, F, W, B)
            Wp = -(-W // p.slot_parts)
            assert p.smem == hw.hist_smem_bytes(Wp, B, p.fg, p.classes) \
                <= hw.SMEM_MAX
            assert hw._blocks_per_sm(p.smem, p.warps) >= 1
            assert 1 <= p.fg <= F and p.classes <= W


@pytest.mark.parametrize("F,n,B,W,active", [
    (3, 600, 16, 1, 1), (6, 30_000, 64, 4, 3), (5, 25_000, 256, 8, 8),
    (4, 40_000, 64, 32, 20), (5, 150_000, 256, 64, 60)])
def test_kernel_order_plain_within_f32_bound_of_jax(F, n, B, W, active):
    """The plain version in the kernels' order (row ranges of
    ``row_ranges``, partials added in range order) against the JAX
    oracle's row-order sums: counts equal, g and h within the f32
    summation bound of any order, (count - 1) 2^-24 sum |v|."""
    r, bins, g, h, mask, leaf = _inputs(F, n, B, W, seed=11 * n + W)
    t = _split_table(r, F, B, W, 2 * W + 2, active)
    _, want = fused_partition_histogram_xla(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(mask), jnp.asarray(leaf), jnp.asarray(t["wl"]),
        jnp.asarray(t["new_ids"]), jnp.asarray(t["feat"]),
        jnp.asarray(t["tbin"]), jnp.asarray(t["dleft"] != 0),
        jnp.zeros(W, bool), jnp.zeros((W, 8), jnp.int32),
        jnp.asarray(t["small"]), jnp.asarray(t["miss"]),
        jnp.asarray(t["defb"]), jnp.asarray(t["nb"]), num_bins=B)
    want = torch.from_numpy(np.array(want))
    args = [torch.from_numpy(a) for a in (bins, g, h, mask, leaf)]
    assert hw.row_ranges(n, F, W, B)[0] > 1 or n < 2 * hw.TILE_ROWS
    _, got = hw.fused_partition_histogram_plain(*args, _tbl(t), B,
                                                kernel_order=True)
    _, p64 = hw.fused_partition_histogram_plain(
        args[0], args[1].double(), args[2].double(), *args[3:], _tbl(t), B)
    _, pabs = hw.fused_partition_histogram_plain(
        args[0], args[1].double().abs(), args[2].double(), *args[3:],
        _tbl(t), B)
    assert torch.equal(got[..., 2], want[..., 2])
    bound = _bound(p64[..., 2:3], pabs[..., :2])
    for a in (got, want):
        err = (a[..., :2].double() - p64[..., :2]).abs()
        assert bool((err <= bound).all())
    # the wave histogram's kernel order too
    wl = torch.from_numpy(t["wl"])
    lb = torch.where(args[3] > 0, args[4], -1).to(torch.int32)
    got2 = hw.wave_histogram_plain(args[0], args[1], args[2], lb, wl, B,
                                   kernel_order=True)
    want2 = torch.from_numpy(np.array(wave_histogram_xla(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(
            lb.numpy()), jnp.asarray(t["wl"]), num_bins=B)))
    assert torch.equal(got2[..., 2], want2[..., 2])
    w64 = hw.wave_histogram_plain(args[0], args[1].double(),
                                  args[2].double(), lb, wl, B)
    wabs = hw.wave_histogram_plain(args[0], args[1].double().abs(),
                                   args[2].double(), lb, wl, B)
    err = (got2[..., :2].double() - w64[..., :2]).abs()
    assert bool((err <= _bound(w64[..., 2:3], wabs[..., :2])).all())


def _int_covered(p, n, F, W):
    """[F, n, W] counts of the work items of an int8 plan that take each
    (feature, row, slot): item q = (row part q // units, unit), unit =
    (feature group, slot class)."""
    cover = np.zeros((F, n, W), np.int32)
    slots = np.arange(W)
    for q in range(p.items):
        r, u = divmod(q, p.units)
        grp, c = divmod(u, p.classes)
        f0 = grp * p.fg
        cover[f0:f0 + p.fg, r * p.rows_per_part:(r + 1) * p.rows_per_part,
              slots % p.classes == c] += 1
    return cover


@pytest.mark.parametrize("n,F,W,B,C,packed4", [
    (0, 3, 1, 16, 2, False), (1, 1, 1, 16, 3, False),
    (15, 5, 64, 256, 3, False), (17, 9, 64, 16, 2, True),
    (17, 2000, 1, 256, 3, False), (15, 2000, 64, 16, 2, True),
    (17, 7, 40, 256, 3, False), (15, 1, 64, 16, 2, True),
    (9000, 28, 64, 64, 2, False), (20_000, 53, 15, 256, 3, False)])
def test_int_plan_covers_every_feature_row_and_slot_once(n, F, W, B, C,
                                                          packed4):
    """int_plan at edge shapes (no row, one row, rows off a multiple of
    16, one slot and 64, 16 and 256 bins, packed bins with an odd feature
    count, 2000 features): its items take each (feature, row, slot)
    once, each part starting on an 8-row vector, and a packed group
    starts on a byte row."""
    p = hw.int_plan(n, F, W, B, C, packed4)
    assert (_int_covered(p, n, F, W) == 1).all()
    assert p.units == -(-F // p.fg) * p.classes
    assert p.items == p.units * p.parts
    assert p.rows_per_part % hw.INT_LANE_ROWS == 0
    assert p.parts * p.rows_per_part >= n > (p.parts - 1) * p.rows_per_part \
        or n == p.parts - 1 == 0
    assert p.classes & (p.classes - 1) == 0 and p.classes <= W
    assert p.copies in hw.INT_COPIES
    assert p.fg <= (2 if packed4 else 1) * hw.INT_BYTE_ROWS
    assert not packed4 or p.fg % 2 == 0 or p.fg >= F
    assert p.smem == hw.int_smem_bytes(W, B, C, p.fg, p.classes, p.copies)
    assert (-(-p.fg // 2) if packed4 else p.fg) <= p.byte_rows
    assert p.byte_rows in (hw.INT_BYTE_ROWS // 2, hw.INT_BYTE_ROWS)
    assert p.blocks == 1 or 2 * (p.smem + hw.SMEM_RESERVED) <= hw.SMEM_PER_SM


@pytest.mark.parametrize("F,C", [(1, 3), (8, 3), (28, 2), (53, 3)])
def test_int_plan_fits_shared_memory(F, C):
    """Every (W, B) the wrappers take (1 <= W <= 64, 1 <= B <= 256; packed
    bins B <= 16): the block's shared memory fits the card's 232,448
    bytes and at least one block fits an SM."""
    for packed4 in (False, True):
        for W in range(1, hw.MAX_WAVE + 1):
            for B in range(1, (16 if packed4 else hw.MAX_BINS) + 1):
                p = hw.int_plan(1_000_000, F, W, B, C, packed4)
                assert p.smem <= hw.SMEM_MAX
                assert p.blocks in (1, 2)


@pytest.mark.parametrize("n,F,W,B,C,packed4", [
    (11_000_000, 28, 64, 64, 2, False), (11_000_000, 28, 64, 16, 2, True),
    (10_000_000, 8, 40, 256, 3, False), (1_000_000, 52, 15, 256, 3, False),
    (11_000_000, 28, 1, 64, 2, False), (11_000_000, 28, 1, 16, 2, True),
    (1_000_000, 52, 1, 256, 3, False)])
def test_int_plan_at_the_main_path_shapes(n, F, W, B, C, packed4):
    """The int8 launches of the main path (K1q count-proxy at the HIGGS
    shape, packed, the airline tile of [40, 256, 3], LRB; K2q at W = 1):
    at least 16 resident warps an SM, work items that fill 80% or more
    of one wave of them and no more, the most copies of the root pass's
    small tiles, and at the airline shape slot classes: its [40, 256, 3]
    tile leaves room for one feature a block, two classes for three, so
    that the rows are staged 6 times, not 8. (Two blocks an SM would take
    twice the units there: measured slower, PERF.md.)"""
    p = hw.int_plan(n, F, W, B, C, packed4)
    blocks = p.blocks
    assert blocks * p.warps >= 16
    assert 0.8 * blocks * hw.NUM_SMS <= p.items <= blocks * hw.NUM_SMS
    if W == 1:
        assert p.copies == hw.INT_COPIES[-1]
    if W == 40:
        assert hw.int_smem_bytes(W, B, C, 2, 1, 1) > hw.SMEM_MAX
        assert p.classes == 2 and p.fg == 3 and p.units == 6


@pytest.mark.parametrize("n,F,W,B,C,packed4", [
    (11_000_000, 28, 64, 64, 2, False), (11_000_000, 28, 1, 16, 2, True),
    (10_000_000, 8, 40, 256, 3, False), (17, 9, 64, 16, 2, True)])
def test_int_plan_is_one_of_int_plans(n, F, W, B, C, packed4):
    """int_plan picks among int_plans, each of which int_plan_with makes
    for its own choices; int_plan_with takes another kernel instance
    where its byte rows hold the group, and refuses one that does not."""
    plans = hw.int_plans(n, F, W, B, C, packed4)
    p = hw.int_plan(n, F, W, B, C, packed4)
    assert p in plans
    assert all(q == hw.int_plan_with(n, F, W, B, C, packed4, q.fg,
                                     q.classes, q.copies) for q in plans)
    wide = hw.int_plan_with(n, F, W, B, C, packed4, p.fg, p.classes,
                            p.copies, byte_rows=hw.INT_BYTE_ROWS, blocks=1)
    assert (wide.byte_rows, wide.blocks) == (hw.INT_BYTE_ROWS, 1)
    assert wide.parts * wide.rows_per_part >= n
    with pytest.raises(LightGBMError):
        hw.int_plan_with(n, F, W, B, C, packed4, 10 if packed4 else 5, 1, 1,
                         byte_rows=hw.INT_BYTE_ROWS // 2)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(LightGBMError):
        hw.wave_histogram(x, x, x, x, x, 4)


# -- the kernels: only on a CUDA card ----------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _bound(counts, abs_sums):
    return (counts - 1).clamp(min=0) * 2.0 ** -24 * abs_sums * 1.01


def test_wave_histogram_kernel(cuda):
    F, n, B, W = 7, 300_000, 64, 16
    r, bins, g, h, mask, leaf = _inputs(F, n, B, W, seed=3)
    wl = np.arange(W, dtype=np.int32)
    wl[3] = -1
    args = [torch.from_numpy(a).to(cuda) for a in (bins, g, h, leaf, wl)]
    k1 = hw.wave_histogram(*args, B)
    k2 = hw.wave_histogram(*args, B)
    p64 = hw.wave_histogram_plain(args[0], args[1].double(),
                                  args[2].double(), *args[3:], B)
    pabs = hw.wave_histogram_plain(args[0], args[1].double().abs(),
                                   args[2].double(), *args[3:], B)
    assert torch.equal(k1, k2)
    assert torch.equal(k1[..., 2].double(), p64[..., 2])
    err = (k1[..., :2].double() - p64[..., :2]).abs()
    assert bool((err <= _bound(p64[..., 2:3], pabs[..., :2])).all())


def test_fused_partition_histogram_kernel(cuda):
    F, n, B, W = 6, 300_000, 256, 24
    r, bins, g, h, mask, leaf = _inputs(F, n, B, W, seed=5)
    t = _split_table(r, F, B, W, 2 * W + 2, 20)
    args = [torch.from_numpy(a).to(cuda) for a in (bins, g, h, mask, leaf)]
    tbl = _tbl(t).to(cuda)
    l1, k1 = hw.fused_partition_histogram(*args, tbl, B)
    l2, k2 = hw.fused_partition_histogram(*args, tbl, B)
    lp, p64 = hw.fused_partition_histogram_plain(
        args[0], args[1].double(), args[2].double(), *args[3:], tbl, B)
    _, pabs = hw.fused_partition_histogram_plain(
        args[0], args[1].double().abs(), args[2].double(), *args[3:], tbl, B)
    assert torch.equal(l1, l2) and torch.equal(k1, k2)
    assert torch.equal(l1, lp)
    assert torch.equal(k1[..., 2].double(), p64[..., 2])
    err = (k1[..., :2].double() - p64[..., :2]).abs()
    assert bool((err <= _bound(p64[..., 2:3], pabs[..., :2])).all())


def test_leaf_gather_kernel(cuda):
    r = np.random.default_rng(9)
    n, L = 1_000_003, 255
    scores = torch.from_numpy(r.normal(size=n).astype(np.float32)).to(cuda)
    leaf = torch.from_numpy(r.integers(-2, L + 2, n).astype(np.int32)).to(cuda)
    table = torch.from_numpy(r.normal(size=L).astype(np.float32)).to(cuda)
    for shrink in (1.0, 0.1):
        got = pr.add_leaf_outputs(scores.clone(), leaf, table, shrink)
        want = pr.add_leaf_outputs_plain(scores.clone(), leaf, table, shrink)
        assert torch.equal(got, want)


def _int8_case(case, B, W, proxy):
    """Inputs of one int8 launch shape of the card tests, on the CPU:
    (bins as the kernel reads them, gq, hq, mask, leaf ids, in-bag leaf
    ids, wave leaves, split table, F, wrapper keywords)."""
    F = dict(airline=8, packed_odd=9, one_row=1, packed_pair=2).get(case, 7)
    n = 300_000 if case in ("random", "one_cell", "airline",
                            "packed_odd") else 300_001
    r, bins, g, h, mask, leaf = _inputs(F, n, B, W, seed=B + W + len(case))
    gq = (r.integers(-127, 128, n) * mask).astype(np.int8)
    hq = (r.integers(0, 128, n) * mask).astype(np.int8)
    t = _split_table(r, F, B, W, 2 * W + 2, max(W - 2, 1))
    wl = np.arange(W, dtype=np.int32)
    if case == "one_cell":
        # every counted row in bin 3 of slot 0: slot 0's leaf holds every
        # row, its split sends them all left, and left is its small child
        bins[:] = 3
        leaf[:] = t["wl"][0]
        wl[0] = t["wl"][0]
        t["tbin"][0], t["miss"][0], t["small"][0] = 5, 0, t["wl"][0]
    tbl = _tbl(t)
    kw = {}
    if case == "airline":
        cat = np.stack([(r.random(W) < 0.7).astype(np.int32)]
                       + [r.integers(-2 ** 31, 2 ** 31, W, dtype=np.int64)
                          .astype(np.int32) for _ in range(8)])
        tbl = torch.cat([tbl, torch.from_numpy(cat)])
        kw = dict(any_cat=True)
    bt = torch.from_numpy(bins)
    if case in ("packed_odd", "packed_pair"):
        bt = hw.pack4(bt)
        kw = dict(packed4=True, num_features=F)
    lb = np.where(mask > 0, leaf, -1).astype(np.int32)
    return (bt, torch.from_numpy(gq), torch.from_numpy(hq),
            torch.from_numpy(mask), torch.from_numpy(leaf),
            torch.from_numpy(lb), torch.from_numpy(wl), tbl, F, kw)


def _offset_view(t, dev):
    """``t`` on ``dev`` as a contiguous view one element into a larger
    tensor: its data start off a 16-byte boundary."""
    big = torch.zeros(t.shape[0] + 1, dtype=t.dtype, device=dev)
    big[1:] = t.to(dev)
    return big[1:]


@pytest.mark.parametrize("B,W,proxy,case", [
    (64, 64, True, "random"), (256, 40, False, "random"),
    (16, 64, True, "random"), (16, 30, False, "random"),
    (64, 1, True, "random"), (256, 1, False, "random"),
    (64, 8, False, "one_cell"), (16, 24, True, "unaligned"),
    (256, 40, False, "airline"), (16, 64, True, "packed_odd"),
    (64, 8, False, "one_row"), (16, 24, True, "packed_pair")])
def test_int8_kernels_bit_equal_to_plain(cuda, B, W, proxy, case):
    """K2q and K1q: integer sums do not depend on order, so two launches
    and the plain version on the card agree bit for bit (every channel,
    K1's leaf ids and cnt_r): at W = 1 (the root pass), with every
    counted row in one cell (every lane of a step on one address), with
    N off a multiple of 16 and gq, hq and the mask as views off a 16-byte
    boundary (the pass's byte loads), at the airline tile [40, 256, 3]
    with categorical slots (slot classes), with packed bins of an odd
    feature count, and with N off a multiple of 8 where the bins are one
    byte row (one feature, two packed): 8-byte loads with a byte-loaded
    ragged end."""
    bt, gq, hq, mask, leaf, lb, wl, tbl, F, kw = _int8_case(case, B, W,
                                                            proxy)
    if case == "unaligned":
        gq, hq, mask = (_offset_view(a, cuda) for a in (gq, hq, mask))
    bt, gq, hq, mask, leaf, lb, wl, tbl = (
        a.to(cuda) for a in (bt, gq, hq, mask, leaf, lb, wl, tbl))
    assert hw.int_aligned(bt, gq, hq) == (case != "unaligned")
    kw = dict(kw, precision="int8", count_proxy=proxy)
    kw2 = {k: v for k, v in kw.items() if k != "any_cat"}
    pkw = {k: v for k, v in kw.items() if k != "precision"}
    pkw2 = {k: v for k, v in pkw.items() if k != "any_cat"}
    k2 = [hw.wave_histogram(bt, gq, hq, lb, wl, B, **kw2) for _ in "ab"]
    assert torch.equal(k2[0], k2[1])
    assert torch.equal(k2[0], hw.wave_histogram_plain(bt, gq, hq, lb, wl, B,
                                                      **pkw2))
    k1 = [hw.fused_partition_histogram(bt, gq, hq, mask, leaf, tbl, B, **kw)
          for _ in "ab"]
    want = hw.fused_partition_histogram_plain(bt, gq, hq, mask, leaf, tbl, B,
                                              **pkw)
    assert len(k1[0]) == len(want) == (3 if proxy else 2)
    for a, b, c in zip(k1[0], k1[1], want):
        assert torch.equal(a, b) and torch.equal(a, c)
    if case == "one_cell":
        hist = k1[0][1]
        assert int(hist[0, :, 3, 2].min()) == int((mask > 0).sum())


def test_packed_kernels_equal_unpacked_launch(cuda):
    """A packed launch reads the same bins in the same order as the
    unpacked one: the f32 and int8 kernels give its bits."""
    F, n, B, W = 9, 300_000, 16, 24
    r, bins, g, h, mask, leaf = _inputs(F, n, B, W, seed=21)
    d = [torch.from_numpy(a).to(cuda) for a in (bins, g, h, mask, leaf)]
    bins_d, g_d, h_d, mask_d, leaf_d = d
    packed = hw.pack4(bins_d)
    tbl = _tbl(_split_table(r, F, B, W, 2 * W + 2, W)).to(cuda)
    gq = torch.from_numpy((r.integers(-127, 128, n) * mask).astype(np.int8))
    hq = torch.from_numpy((r.integers(0, 128, n) * mask).astype(np.int8))
    for gg, hh, kw in ((g_d, h_d, {}),
                       (gq.to(cuda), hq.to(cuda),
                        dict(precision="int8", count_proxy=True))):
        lb = torch.where(mask_d > 0, leaf_d, -1).to(torch.int32)
        wl = torch.arange(W, dtype=torch.int32, device=cuda)
        assert torch.equal(
            hw.wave_histogram(bins_d, gg, hh, lb, wl, B, **kw),
            hw.wave_histogram(packed, gg, hh, lb, wl, B, packed4=True,
                              num_features=F, **kw))
        a = hw.fused_partition_histogram(bins_d, gg, hh, mask_d, leaf_d, tbl,
                                         B, **kw)
        b = hw.fused_partition_histogram(packed, gg, hh, mask_d, leaf_d, tbl,
                                         B, packed4=True, num_features=F,
                                         **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _f32_case(case):
    """Inputs of one f32 launch shape of the card tests: (bins as the
    kernel reads them, g, h, mask, leaf ids, wave leaves, split table,
    B, wrapper keywords)."""
    F, n, B, W = dict(w1=(7, 300_000, 64, 1), w64_b256=(5, 200_003, 256, 64),
                      skewed=(6, 300_000, 64, 8),
                      no_counted=(4, 100_000, 64, 8),
                      categorical=(6, 300_000, 256, 24),
                      packed=(9, 300_000, 16, 24))[case]
    r, bins, g, h, mask, leaf = _inputs(F, n, B, W, seed=len(case) + n)
    t = _split_table(r, F, B, W, 2 * W + 2, max(W - 2, 1))
    wl = np.arange(W, dtype=np.int32)
    if case == "skewed":
        # most rows in one cell: bin 3 of the first slot's leaf
        bins = np.where(r.random((F, n)) < 0.95, 3, bins).astype(np.uint8)
        leaf = np.where(r.random(n) < 0.95, t["wl"][0], leaf)
        wl[0] = t["wl"][0]
    if case == "no_counted":
        wl += 10_000
        t["wl"] = np.where(t["wl"] >= 0, t["wl"] + 10_000, -1)
    tbl = _tbl(t)
    kw = {}
    if case == "categorical":
        cat = np.stack([(r.random(W) < 0.5).astype(np.int32)]
                       + [r.integers(-2 ** 31, 2 ** 31, W, dtype=np.int64)
                          .astype(np.int32) for _ in range(8)])
        tbl = torch.cat([tbl, torch.from_numpy(cat)])
        kw = dict(any_cat=True)
    bt = torch.from_numpy(bins)
    if case == "packed":
        bt = hw.pack4(bt)
        kw = dict(packed4=True, num_features=F)
    lb = np.where(mask > 0, leaf, -1).astype(np.int32)
    return (bt, torch.from_numpy(g), torch.from_numpy(h),
            torch.from_numpy(mask), torch.from_numpy(leaf.astype(np.int32)),
            torch.from_numpy(lb), torch.from_numpy(wl), tbl, B, kw)


@pytest.mark.parametrize("case", ["w1", "w64_b256", "skewed", "no_counted",
                                  "categorical", "packed"])
def test_f32_kernels_equal_kernel_order_plain(cuda, case):
    """K2 and K1 on the f32 tier bit for bit against their plain
    versions run on the CPU in the kernels' order of addition (every
    channel, K1's leaf ids), two launches bit-identical: at W = 1 (one
    slot class, the jobs split by feature), at W = 64 x B = 256 (one
    feature per group), with most rows in one cell, with no counted
    rows, with categorical slots and with packed bins."""
    bt, g, h, mask, leaf, lb, wl, tbl, B, kw = [
        a.to(cuda) if torch.is_tensor(a) else a for a in _f32_case(case)]
    F = kw.get("num_features", bt.shape[0])
    plan = hw.hist_plan(bt.shape[1], F, tbl.shape[1], B)
    if case == "w64_b256":
        assert plan.fg == 1
    if case == "w1":
        assert plan.classes == 1 and plan.fg > 1
    kw2 = {k: v for k, v in kw.items() if k != "any_cat"}
    k2 = [hw.wave_histogram(bt, g, h, lb, wl, B, **kw2) for _ in "ab"]
    want = hw.plain_in_kernel_order(hw.wave_histogram_plain, bt, g, h, lb,
                                    wl, B, **kw2)
    assert torch.equal(k2[0], k2[1]) and torch.equal(k2[0], want)
    k1 = [hw.fused_partition_histogram(bt, g, h, mask, leaf, tbl, B, **kw)
          for _ in "ab"]
    want = hw.plain_in_kernel_order(hw.fused_partition_histogram_plain, bt,
                                    g, h, mask, leaf, tbl, B, **kw)
    for a, b, c in zip(k1[0], k1[1], want):
        assert torch.equal(a, b) and torch.equal(a, c)
    if case == "no_counted":
        assert not k2[0].any() and not k1[0][1].any()


@pytest.mark.parametrize("extra", [1, 2, 3])
def test_leaf_gather_kernel_unaligned_row_views(cuda, extra):
    """K3 on the rows of a [3, N] score matrix (rows 1 and 2 start off a
    16-byte boundary), N % 4 = ``extra``, ids partly outside [0, L):
    bit for bit against its plain version, the rows around untouched."""
    r = np.random.default_rng(extra)
    n, L = 1_000_000 + extra, 255
    mat = torch.from_numpy(r.normal(size=(3, 1_000_003)).astype(np.float32)
                           ).to(cuda)
    table = torch.from_numpy(r.normal(size=L).astype(np.float32)).to(cuda)
    for row in range(3):
        leaf = torch.from_numpy(r.integers(-2, L + 2, n).astype(np.int32)
                                ).to(cuda)
        for shrink in (1.0, 0.1):
            m = mat.clone()
            got = pr.add_leaf_outputs(m[row, :n], leaf, table, shrink)
            want = pr.add_leaf_outputs_plain(mat[row, :n].clone(), leaf,
                                             table, shrink)
            assert torch.equal(got, want)
            assert torch.equal(m[row, n:], mat[row, n:])
            others = [k for k in range(3) if k != row]
            assert torch.equal(m[others], mat[others])


def _with_passengers(case, nv, seed):
    """``_f32_case``'s inputs with ``nv`` passenger columns appended, as
    a valid set rides the grower's bin matrix: random bins, g = h = 0,
    sample mask 0, leaf id -1 for K2 and a wave leaf's id for K1 (every
    split moves them; nothing counts them). Returns (train inputs,
    combined inputs), each as ``_f32_case`` gives them."""
    bt, g, h, mask, leaf, lb, wl, tbl, B, kw = _f32_case(case)
    r = np.random.default_rng(seed)
    F = kw.get("num_features", bt.shape[0])
    pb = torch.from_numpy(r.integers(0, B, (F, nv)).astype(np.uint8))
    if kw.get("packed4"):
        pb = hw.pack4(pb)
    live = tbl[hw.TBL_PARENT][tbl[hw.TBL_PARENT] >= 0].numpy()
    pleaf = torch.from_numpy(r.choice(live, nv).astype(np.int32))
    zero = torch.zeros(nv, dtype=torch.float32)
    both = (torch.cat([bt, pb], 1), torch.cat([g, zero]),
            torch.cat([h, zero]), torch.cat([mask, zero]),
            torch.cat([leaf, pleaf]),
            torch.cat([lb, torch.full((nv,), -1, dtype=torch.int32)]),
            wl, tbl, B, kw)
    return (bt, g, h, mask, leaf, lb, wl, tbl, B, kw), both


def test_row_ranges_of_counted_rows():
    """With passengers behind the n counted rows, the ranges keep the
    rows per range of the n rows alone and cover the combined width."""
    for n, nv, F, W, B in ((1_000_000, 65_536, 53, 30, 256),
                           (11_000_000, 500_000, 28, 24, 64),
                           (5_000, 3_000, 6, 8, 64)):
        R, per = hw.row_ranges(n, F, W, B)
        Rc, perc = hw.row_ranges(n + nv, F, W, B, counted=n)
        assert perc == per and Rc * per >= n + nv > (Rc - 1) * per
        assert Rc >= R


@pytest.mark.parametrize("case", ["w1", "skewed", "categorical"])
def test_plain_in_ranges_unmoved_by_passengers(case):
    """On the CPU: the plain versions in the kernels' order of addition
    give the training rows' sums bit for bit with 20,000 passenger
    columns behind them (``counted_rows``) as without them, and K1 moves
    the passengers as it moves any row."""
    tr, both = _with_passengers(case, 20_000, 4)
    bt, g, h, mask, leaf, lb, wl, tbl, B, kw = tr
    cb, cg, ch, cm, cl, clb = both[:6]
    kw2 = {k: v for k, v in kw.items() if k != "any_cat"}
    n = bt.shape[1]
    alone = hw.wave_histogram_plain(bt, g, h, lb, wl, B, kernel_order=True,
                                    **kw2)
    ride = hw.wave_histogram_plain(cb, cg, ch, clb, wl, B, kernel_order=True,
                                   counted_rows=n, **kw2)
    assert torch.equal(alone, ride)
    la, ha = hw.fused_partition_histogram_plain(
        bt, g, h, mask, leaf, tbl, B, kernel_order=True, **kw)
    lr, hr = hw.fused_partition_histogram_plain(
        cb, cg, ch, cm, cl, tbl, B, kernel_order=True, counted_rows=n, **kw)
    assert torch.equal(ha, hr) and torch.equal(la, lr[:n])
    assert bool((lr[n:] != cl[n:]).any())


@pytest.mark.parametrize("case", ["w1", "w64_b256", "categorical", "packed"])
def test_f32_kernels_with_passenger_columns(cuda, case):
    """K2 and K1 on the f32 tier with 65,536 passenger columns behind the
    training rows (a valid set): bit for bit against their plain
    versions run on the CPU in the kernels' order of the counted rows'
    ranges (every channel, K1's leaf ids), two launches bit-identical,
    and the training rows' sums and leaf ids bit-equal to the launches
    without the passengers."""
    tr, both = _with_passengers(case, 65_536, 5)
    bt, g, h, mask, leaf, lb, wl, tbl, B, kw = [
        a.to(cuda) if torch.is_tensor(a) else a for a in tr]
    cb, cg, ch, cm, cl, clb = [a.to(cuda) for a in both[:6]]
    n = bt.shape[1]
    kw2 = {k: v for k, v in kw.items() if k != "any_cat"}
    k2 = [hw.wave_histogram(cb, cg, ch, clb, wl, B, counted_rows=n, **kw2)
          for _ in "ab"]
    want = hw.plain_in_kernel_order(hw.wave_histogram_plain, cb, cg, ch,
                                    clb, wl, B, counted_rows=n, **kw2)
    alone = hw.wave_histogram(bt, g, h, lb, wl, B, **kw2)
    assert torch.equal(k2[0], k2[1]) and torch.equal(k2[0], want)
    assert torch.equal(k2[0], alone)
    k1 = [hw.fused_partition_histogram(cb, cg, ch, cm, cl, tbl, B,
                                       counted_rows=n, **kw)
          for _ in "ab"]
    want = hw.plain_in_kernel_order(hw.fused_partition_histogram_plain, cb,
                                    cg, ch, cm, cl, tbl, B, counted_rows=n,
                                    **kw)
    for a, b, c in zip(k1[0], k1[1], want):
        assert torch.equal(a, b) and torch.equal(a, c)
    la, ha = hw.fused_partition_histogram(bt, g, h, mask, leaf, tbl, B, **kw)
    assert torch.equal(k1[0][1], ha) and torch.equal(k1[0][0][:n], la)


def test_leaf_gather_kernel_on_slices_of_leaf_ids(cuda):
    """K3 with leaf ids that are slices of one [N + Nv] vector, as the
    train update (``leaf_ids[:n]``) and a valid set's
    (``leaf_ids[n:n + nv]``, a view with a storage offset) read them:
    bit for bit against the plain version."""
    r = np.random.default_rng(11)
    n, nv, L = 1_000_003, 65_537, 31
    leaf = torch.from_numpy(r.integers(0, L, n + nv).astype(np.int32)
                            ).to(cuda)
    table = torch.from_numpy(r.normal(size=L).astype(np.float32)).to(cuda)
    for rows in (slice(0, n), slice(n, n + nv), slice(7, n + 3)):
        scores = torch.from_numpy(r.normal(size=rows.stop - rows.start)
                                  .astype(np.float32)).to(cuda)
        got = pr.add_leaf_outputs(scores.clone(), leaf[rows], table, 0.1)
        want = pr.add_leaf_outputs_plain(scores.clone(), leaf[rows], table,
                                         0.1)
        assert torch.equal(got, want)
