"""Port parity: lightgbm_tpu_torch.ops.hist_wave (K2, K1) and
ops.predict (K3) against lightgbm_tpu.ops.

Bars: on the CPU the plain versions are bit-equal to the JAX package's
XLA formulations (``wave_histogram_xla``, ``fused_partition_histogram_xla``,
``add_leaf_outputs``): ``index_add_`` adds each histogram cell in row
order, as XLA's scatter does, and the score update rounds the table
product and the add separately (the table is built first, as the JAX
package's step builds its folded table). K3 is compared on in-range leaf
ids only, the two JAX paths disagree outside. The kernels run only on a
CUDA card: the tests that hold them against the plain versions skip
without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.hist_wave import (fused_partition_histogram_xla,
                                        wave_histogram_xla)
from lightgbm_tpu.ops.predict import add_leaf_outputs as j_add_leaf_outputs
from lightgbm_tpu_torch.ops import hist_wave as hw
from lightgbm_tpu_torch.ops import predict as pr
from lightgbm_tpu_torch.utils.log import LightGBMError

pytestmark = pytest.mark.torch_port


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


def test_leaf_gather_out_of_range_adds_nothing():
    scores = torch.tensor([1.0, 2.0, 3.0, 4.0])
    leaf = torch.tensor([-1, 0, 2, 5], dtype=torch.int32)
    got = pr.add_leaf_outputs(scores, leaf, torch.tensor([10.0, 20.0, 30.0]))
    assert got.tolist() == [1.0, 12.0, 33.0, 4.0]


def test_row_ranges_cover_every_row():
    for n, F in ((1, 1), (1000, 28), (11_000_000, 28), (1_000_000, 53),
                 (5000, 2000)):
        ranges, per = hw.row_ranges(n, F)
        assert ranges * per >= n > (ranges - 1) * per


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
    got = pr.add_leaf_outputs(scores.clone(), leaf, table)
    want = pr.add_leaf_outputs_plain(scores.clone(), leaf, table)
    assert torch.equal(got, want)
