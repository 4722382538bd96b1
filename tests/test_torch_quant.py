"""Port parity for the quantized histogram tiers and 4-bit packed bins:
lightgbm_tpu_torch against lightgbm_tpu on the CPU.

What is held, and to which bar:
- the stochastic-rounding hash (``_mix32``, ``_hash_uniform``) and the
  quantize prelude of the JAX grower: bit for bit. PyTorch has no
  wrapping uint32 multiply, so the port masks int64 (ops/quantize.py);
  the salt's wrapping sum of the gradient bits is an exact int64 sum
  masked to 32 bits. XLA rewrites the division by the constant 127 into
  a product with f32(1/127), and the port multiplies too;
- XLA's f32 exp (the Cephes polynomial with fused multiply-adds) and its
  contraction of ``a * b + c`` into one fused multiply-add, which the
  port reproduces in ops/f32math.py, and the binary gradients built on
  them: bit for bit;
- the split search's prefix sums in XLA's order at widths 16, 32, 64 and
  256: bit for bit;
- the plain int8 histograms (K2q, K1q; count-proxy on and off, packed on
  and off, B in {16, 64, 256}, W up to 64, bagging on) against the JAX
  package's XLA route with ``precision="int8"`` and against its Pallas
  kernels in interpret mode: bit for bit, ``cnt_r`` included. The JAX
  CPU route sums integer-valued f32, exact while a cell's |sum| < 2^24,
  which these sizes keep; the port sums int32, as the TPU kernel does;
- the grower's TreeRecord against ``make_wave_grower(precision="int8",
  count_proxy=...)`` with the bars of test_torch_grower.py (every field
  bit for bit, split_gain within 4 ulp). The port follows the roundings
  XLA's fusion makes here: the sibling's subtraction of the int8 tier
  with exact counts, ``parent - hist * scale``, is one fused
  multiply-add, and the root's dequantized g sum is rounded for the
  gains but fused into the winner's side sums (ops/split.py). XLA does
  not fuse the same way everywhere: in about one root split in ten the
  right side's g sum comes out rounded twice, one ulp from the port's,
  and at width 16 under exact counts a sibling's sums can differ too.
  These cases are clear of both;
- ``train`` and the C-API sequence under the count-proxy tier, the int8
  tier with exact counts and 4-bit packed bins (exact and count-proxy
  tiers): every tree equal in structure, counts and leaf values, train
  AUC within 4e-4, and each package loads the other's text. The
  quantized tiers hash every gradient's bits into the rounding salt, so
  one ulp in one score re-draws every row's rounding from the next tree
  on. The sets here stay clear of the fusion differences above for 20
  iterations. Of the 16 (set, tier) pairs tried at 8,000 HIGGS-shape
  rows with bagging, 11 did and 5 parted at trees 9-18; of 8 LRB-shape
  C-API runs (3,000 rows, 255 bins, bagging and feature_fraction), 2
  did and 6 parted at trees 7-15; each parting a new draw of the
  quantization after such an ulp, not a tie;
- the tier resolution (W, precision, count-proxy, count_lb, packed4) and
  its log lines against the JAX package's ``GBDT._setup_grower``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from chip_smoke import (TRAIN_PARAMS, auc_np, lrb_labels, make_higgs_like,
                        make_lrb_rows, tree_diff)
from lightgbm_tpu import capi as jcapi
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.objectives import create_objective as j_create_objective
from lightgbm_tpu.ops import hist_wave as jhw
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops import wave_grower as jwg
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.models.gbdt import GBDT as TorchGBDT
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops import f32math
from lightgbm_tpu_torch.ops import hist_wave as hw
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.ops import wave_grower as twg
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small PyTorch ops; under parallel test
    workers (pytest-xdist) on a shared CPU, each op's thread pool only
    contends (a test of 10 s alone took 440 s so). One thread each,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_log_levels():
    """Training with verbose=-1 lowers either package's process-wide log
    level; later tests in the same worker may read warnings, so each
    test puts both levels back."""
    levels = jlog.get_level(), tlog.get_level()
    yield
    jlog.set_level(levels[0])
    tlog.set_level(levels[1])


AUC_TOL = 4e-4


# -- the rounding hash, the quantize prelude, XLA's f32 arithmetic -----------

@pytest.mark.parametrize("salt", [0, 0x9E3779B9, 0xFFFFFFFF])
def test_mix32_and_hash_uniform_bit_equal(salt):
    r = np.random.default_rng(salt & 0xFFFF)
    x = np.concatenate([[0, 1, 2 ** 31, 2 ** 32 - 1],
                        r.integers(0, 2 ** 32, 20_000)]).astype(np.uint32)
    xt = torch.from_numpy(x.astype(np.int64))
    want = np.asarray(jwg._mix32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(tq.mix32(xt).numpy(), want)
    want_u = np.asarray(jwg._hash_uniform(jnp.asarray(x),
                                          jnp.asarray(np.uint32(salt))))
    np.testing.assert_array_equal(tq.hash_uniform(xt, salt).numpy(), want_u)


@jax.jit
def _jax_prelude(grad, hess):
    """The JAX grower's quantize prelude (wave_grower.py:542-573) on one
    device, line for line."""
    f32 = jnp.float32
    sg_s = jnp.maximum(jnp.max(jnp.abs(grad)), 1e-30) / 127.0
    sh_s = jnp.maximum(jnp.max(hess), 1e-30) / 127.0
    bg = jax.lax.bitcast_convert_type(sg_s.astype(f32), jnp.uint32)
    bh = jax.lax.bitcast_convert_type(sh_s.astype(f32), jnp.uint32)
    gbits_sum = jnp.sum(jax.lax.bitcast_convert_type(grad, jnp.int32),
                        dtype=jnp.int32)
    salt = (bg ^ ((bh << jnp.uint32(16)) | (bh >> jnp.uint32(16)))
            ^ jwg._mix32(gbits_sum.astype(jnp.uint32)))
    gidx = jnp.arange(grad.shape[0], dtype=jnp.int32).astype(jnp.uint32)
    u_g = jwg._hash_uniform(gidx, salt)
    u_h = jwg._hash_uniform(gidx, salt ^ jnp.uint32(0x9E3779B9))
    gq = jnp.clip(jnp.floor(grad / sg_s + u_g), -127.0, 127.0)
    hq = jnp.clip(jnp.floor(hess / sh_s + u_h), 0.0, 127.0)
    return gq, hq, sg_s, sh_s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bit_equal(seed):
    r = np.random.default_rng(seed)
    n = 20_000
    mask = (r.random(n) < 0.8).astype(np.float32)
    g = (r.normal(size=n) * r.uniform(0.01, 3)).astype(np.float32) * mask
    h = r.uniform(0.01, 0.25, n).astype(np.float32) * mask
    want = [np.asarray(v) for v in _jax_prelude(jnp.asarray(g),
                                                jnp.asarray(h))]
    got = tq.quantize(torch.from_numpy(g), torch.from_numpy(h))
    np.testing.assert_array_equal(got.gq.numpy().astype(np.float32), want[0])
    np.testing.assert_array_equal(got.hq.numpy().astype(np.float32), want[1])
    assert float(got.sg) == float(want[2]) and float(got.sh) == float(want[3])


def test_exp_and_fma_bit_equal_to_xla():
    r = np.random.default_rng(4)
    x = np.concatenate([r.uniform(-88.3, 88.3, 200_000),
                        r.normal(size=200_000) * 4,
                        [-1000.0, -88.5, -87.34, -0.0, 0.0, 89.0, np.inf,
                         -np.inf]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    np.testing.assert_array_equal(f32math.exp(torch.from_numpy(x)).numpy(),
                                  want)
    a, b, c = [(r.normal(size=100_000) * np.exp(r.uniform(-20, 20, 100_000)))
               .astype(np.float32) for _ in range(3)]
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    got = f32math.fma(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("params,weighted", [({}, False),
                                             ({"sigmoid": 0.7}, True)])
def test_binary_gradients_bit_equal(params, weighted):
    r = np.random.default_rng(5 + weighted)
    n = 20_000
    y = (r.random(n) < 0.3).astype(np.float32)
    w = r.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    score = (r.normal(size=n) * 3).astype(np.float32)
    full = {"objective": "binary", **params}
    jo = j_create_objective("binary", JConfig().set(full))
    jo.init(JMeta(label=y, weight=w), n)
    to = create_objective("binary", TConfig().set(full))
    to.init(Metadata(label=y, weight=w), n)
    jg, jh = jo.get_gradients(jnp.asarray(score))
    tg, th = to.get_gradients(torch.from_numpy(score))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("B", [16, 32, 64, 256])
def test_prefix_sums_in_xla_order(B):
    r = np.random.default_rng(B)
    x = (r.normal(size=(3, 7, B, 3))
         * r.uniform(0.1, 100, (3, 7, B, 3))).astype(np.float32)
    x[..., ::5, :] = 0.0
    tril = jnp.tril(jnp.ones((B, B), jnp.float32))
    want = np.asarray(jax.jit(jax.vmap(lambda c: jnp.einsum(
        "bk,fkc->fbc", tril, c, precision=jax.lax.Precision.HIGHEST)))(
            jnp.asarray(x)))
    np.testing.assert_array_equal(ts.prefix_sums(torch.from_numpy(x)).numpy(),
                                  want)


# -- the int8 histograms ------------------------------------------------------

def _qinputs(F, n, B, W, seed):
    r = np.random.default_rng(seed)
    bins = r.integers(0, B, (F, n)).astype(np.uint8)
    mask = (r.random(n) < 0.8).astype(np.float32)
    gq = (r.integers(-127, 128, n) * mask).astype(np.float32)
    hq = (r.integers(0, 128, n) * mask).astype(np.float32)
    leaf = r.integers(0, 2 * W + 2, n).astype(np.int32)
    sg, sh = np.float32(r.uniform(1e-3, 1e-2)), np.float32(r.uniform(1e-4,
                                                                     1e-3))
    return r, bins, gq, hq, mask, leaf, (sg, sh)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tscale(scale):
    return tuple(torch.tensor(s, dtype=torch.float32) for s in scale)


def _split_table(r, F, B, W, leaf_hi, active):
    wl = np.full(W, -1, np.int32)
    wl[:active] = r.choice(leaf_hi, active, replace=False)
    new_ids = np.where(wl >= 0, leaf_hi + np.arange(W), -1).astype(np.int32)
    t = dict(wl=wl, new_ids=new_ids,
             feat=r.integers(0, F, W).astype(np.int32),
             tbin=r.integers(0, B - 1, W).astype(np.int32),
             dleft=r.integers(0, 2, W).astype(np.int32),
             miss=r.integers(0, 3, W).astype(np.int32),
             defb=r.integers(0, B, W).astype(np.int32),
             nb=np.full(W, B, np.int32))
    t["small"] = np.where(r.random(W) < 0.5, wl, new_ids).astype(np.int32)
    t["small"][active:] = -1
    return t


TIERS = [  # B, W, count_proxy, packed4
    (16, 64, True, True), (16, 24, True, False), (16, 8, False, False),
    (64, 64, True, False), (64, 40, False, False), (256, 32, True, False),
    (256, 40, False, False)]


@pytest.mark.parametrize("B,W,proxy,packed", TIERS)
def test_wave_histogram_int8_plain_bit_equal(B, W, proxy, packed):
    F, n = 5, 700
    r, bins, gq, hq, mask, leaf, scale = _qinputs(F, n, B, W, B + W)
    leaf = np.where(mask > 0, leaf, -1).astype(np.int32)
    wl = r.choice(2 * W + 2, W, replace=False).astype(np.int32)
    wl[W // 2] = -1
    jargs = [jnp.asarray(a) for a in (bins, gq, hq, leaf, wl)]
    want_xla = np.asarray(jhw.wave_histogram(
        *jargs, num_bins=B, precision="int8", gh_scale=scale,
        use_pallas=False))
    bt = hw.pack4(_t(bins)) if packed else _t(bins)
    kw = dict(precision="int8", count_proxy=proxy, packed4=packed,
              num_features=F)
    got = hw.wave_histogram(bt, _t(gq).to(torch.int8), _t(hq).to(torch.int8),
                            _t(leaf), _t(wl), B, gh_scale=_tscale(scale),
                            **kw)
    C = 2 if proxy else 3
    assert got.shape == (W, F, B, C)
    np.testing.assert_array_equal(got.numpy(), want_xla[..., :C])
    raw = hw.wave_histogram(bt, _t(gq).to(torch.int8),
                            _t(hq).to(torch.int8), _t(leaf), _t(wl), B, **kw)
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jhw.wave_histogram(
        *jargs, num_bins=B, precision="int8", gh_scale=scale,
        use_pallas=False, dequant=False))[..., :C])
    jbins = jnp.asarray(hw.pack4(_t(bins)).numpy()) if packed else jargs[0]
    want_pallas = np.asarray(jhw.wave_histogram_pallas(
        jbins, *jargs[1:], num_bins=B, chunk=256, interpret=True,
        precision="int8", gh_scale=scale, count_proxy=proxy, packed4=packed,
        num_features=F if packed else None))
    np.testing.assert_array_equal(got.numpy(), want_pallas)


@pytest.mark.parametrize("B,W,proxy,packed", TIERS)
def test_fused_partition_histogram_int8_plain_bit_equal(B, W, proxy, packed):
    F, n = 6, 900
    r, bins, gq, hq, mask, leaf, scale = _qinputs(F, n, B, W, 3 * B + W)
    t = _split_table(r, F, B, W, 2 * W + 2, max(W - 3, 1))
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    want_leaf, want_hist, want_cnt = jhw.fused_partition_histogram_xla(
        jnp.asarray(bins), jnp.asarray(gq), jnp.asarray(hq),
        jnp.asarray(mask), jnp.asarray(leaf), jt["wl"], jt["new_ids"],
        jt["feat"], jt["tbin"], jt["dleft"] != 0, jnp.zeros(W, bool),
        jnp.zeros((W, 8), jnp.int32), jt["small"], jt["miss"], jt["defb"],
        jt["nb"], num_bins=B, count_proxy=True, gh_scale=scale)
    tbl = _t(np.stack([t[k] for k in ("wl", "new_ids", "feat", "tbin",
                                      "dleft", "miss", "defb", "nb",
                                      "small")]).astype(np.int32))
    bt = hw.pack4(_t(bins)) if packed else _t(bins)
    out = hw.fused_partition_histogram(
        bt, _t(gq).to(torch.int8), _t(hq).to(torch.int8), _t(mask), _t(leaf),
        tbl, B, precision="int8", count_proxy=proxy, packed4=packed,
        num_features=F, gh_scale=_tscale(scale))
    C = 2 if proxy else 3
    assert len(out) == (3 if proxy else 2)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(want_leaf))
    np.testing.assert_array_equal(out[1].numpy(),
                                  np.asarray(want_hist)[..., :C])
    if proxy:
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(want_cnt))
        assert out[2].sum() > 0
    # the Pallas kernel in interpret mode, as tests/test_wave_ops.py runs it
    ptbl = jnp.concatenate([jnp.asarray(tbl.numpy()),
                            jnp.zeros((1, W), jnp.int32)])
    jbins = jnp.asarray(bt.numpy())
    pout = jhw.fused_partition_histogram_pallas(
        jbins, jnp.asarray(gq), jnp.asarray(hq), jnp.asarray(mask),
        jnp.asarray(leaf), ptbl, num_bins=B, chunk=256, interpret=True,
        precision="int8", gh_scale=scale, any_cat=False, count_proxy=proxy,
        packed4=packed, num_features=F if packed else None)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(pout[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(pout[1]))
    if proxy:
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(pout[2]))


def test_packed_plain_equals_unpacked():
    """A packed launch reads the same bins: the plain versions of both
    tiers give the unpacked result, odd F included."""
    F, n, B, W = 7, 1500, 16, 12
    r, bins, gq, hq, mask, leaf, scale = _qinputs(F, n, B, W, 11)
    packed = hw.pack4(_t(bins))
    assert packed.shape == (4, n)
    np.testing.assert_array_equal(hw.unpack4(packed, F).numpy(), bins)
    t = _split_table(r, F, B, W, 2 * W + 2, W)
    tbl = _t(np.stack([t[k] for k in ("wl", "new_ids", "feat", "tbin",
                                      "dleft", "miss", "defb", "nb",
                                      "small")]).astype(np.int32))
    g = _t(r.normal(size=n).astype(np.float32) * mask)
    h = _t(r.random(n).astype(np.float32) * mask)
    for kw, gg, hh in (({}, g, h),
                       (dict(precision="int8", count_proxy=True),
                        _t(gq).to(torch.int8), _t(hq).to(torch.int8))):
        a = hw.fused_partition_histogram(_t(bins), gg, hh, _t(mask),
                                         _t(leaf), tbl, B, **kw)
        b = hw.fused_partition_histogram(packed, gg, hh, _t(mask), _t(leaf),
                                         tbl, B, packed4=True,
                                         num_features=F, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_tier_refusals_and_overflow_guard():
    x8 = torch.zeros((2, 3), dtype=torch.uint8)
    q = torch.zeros(3, dtype=torch.int8)
    ids = torch.zeros(3, dtype=torch.int32)
    wl = torch.zeros(1, dtype=torch.int32)
    f = torch.zeros(3)
    with pytest.raises(NotImplementedError, match="count_proxy requires"):
        hw.wave_histogram(x8, f, f, ids, wl, 16, count_proxy=True)
    with pytest.raises(NotImplementedError, match="packed4 needs max_bin"):
        hw.wave_histogram(x8, f, f, ids, wl, 64, packed4=True,
                          num_features=4)
    with pytest.raises(NotImplementedError, match="count-proxy or hi/lo"):
        hw.wave_histogram(x8, q, q, ids, wl, 16, precision="int8",
                          packed4=True, num_features=4)
    # 127 * n >= 2^31: the int32 sums could wrap (hist_wave.py:528-531);
    # the views below hold no memory, and the guard raises before reading
    n = 2 ** 31 // 127 + 1
    big8 = torch.zeros((1, 1), dtype=torch.uint8).expand(1, n)
    bq = torch.zeros(1, dtype=torch.int8).expand(n)
    bi = torch.zeros(1, dtype=torch.int32).expand(n)
    with pytest.raises(NotImplementedError, match="overflow int32"):
        hw.wave_histogram(big8, bq, bq, bi, wl, 16, precision="int8")
    with pytest.raises(NotImplementedError, match="overflow int32"):
        hw.fused_partition_histogram(
            big8, bq, bq, torch.zeros(1).expand(n), bi,
            torch.zeros((hw.TBL_ROWS, 1), dtype=torch.int32), 16,
            precision="int8", count_proxy=True)


# -- the grower ---------------------------------------------------------------

def _grow_case(F, n, B, seed):
    r = np.random.default_rng(seed)
    nb = r.integers(4, B + 1, F).astype(np.int32)
    nb[0] = B
    mt = r.integers(0, 3, F).astype(np.int32)
    db = np.array([r.integers(0, b) for b in nb], np.int32)
    bins = np.stack([r.integers(0, nb[f], n) for f in range(F)]) \
        .astype(np.uint8)
    g = r.normal(size=n).astype(np.float32)
    h = r.uniform(0.05, 0.25, n).astype(np.float32)
    meta = dict(num_bin=nb, missing_type=mt, default_bin=db,
                monotone=np.zeros(F, np.int32),
                penalty=np.ones(F, np.float32))
    mask = (r.random(n) < 0.8).astype(np.float32)
    return bins, g, h, mask, meta


@pytest.mark.parametrize("F,n,B,L,W,proxy,packed", [
    (7, 2500, 16, 63, 32, True, False), (7, 2500, 16, 63, 32, True, True),
    (5, 6000, 64, 63, 64, True, False), (5, 6000, 64, 63, 40, False, False),
    (8, 3000, 256, 31, 30, True, False),
    (8, 3000, 256, 31, 30, False, False)])
def test_grower_record_int8_bit_equal(F, n, B, L, W, proxy, packed):
    bins, g, h, mask, meta = _grow_case(F, n, B, {16: 3, 64: 4, 256: 2}[B])
    fmask = np.ones(F, bool)
    hp = {"min_data_in_leaf": 20.0}
    jg = jwg.make_wave_grower(
        jwg.WaveGrowerConfig(num_leaves=L, num_bins=B, wave_size=W,
                             hp=js.SplitParams(**hp, has_cat=False,
                                               count_lb=proxy),
                             precision="int8", count_proxy=proxy,
                             packed4=packed),
        js.FeatureMeta(**meta))
    jb = hw.pack4(_t(bins)).numpy() if packed else bins
    jrec, jleaf = jg(jnp.asarray(jb), jnp.asarray(g), jnp.asarray(h),
                     jnp.asarray(mask), jnp.asarray(fmask))
    tg = twg.WaveGrower(
        twg.WaveGrowerConfig(num_leaves=L, num_bins=B, wave_size=W,
                             hp=ts.SplitParams(**hp, count_lb=proxy),
                             precision="int8", count_proxy=proxy,
                             packed4=packed),
        ts.FeatureMeta(**meta), torch.device("cpu"))
    trec, tleaf = tg.grow(_t(jb), _t(g), _t(h), _t(mask), _t(fmask))
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    tn = trec.to_numpy()
    assert tn["num_leaves"] == int(jrec.num_leaves) > 10
    for k in twg.TreeRecord._fields:
        want = np.asarray(getattr(jrec, k))
        if k == "split_gain":
            np.testing.assert_array_less(
                np.abs(tn[k] - want), 4 * np.spacing(np.abs(want)) + 1e-30)
            continue
        np.testing.assert_array_equal(np.asarray(tn[k]), want, err_msg=k)
    if proxy:
        # leaf counts are the partition's exact counts, not lower bounds
        leaf_rows = np.bincount(tleaf.numpy()[mask > 0],
                                minlength=L)[:tn["num_leaves"]]
        np.testing.assert_array_equal(tn["leaf_count"][:tn["num_leaves"]],
                                      leaf_rows)


# -- end to end ---------------------------------------------------------------

QUANT = {"tpu_quantized_hist": True}
CONFIGS = {  # name: (params, make_higgs_like seed)
    "proxy": ({**QUANT}, 8),
    "int8": ({**QUANT, "tpu_count_proxy": 0}, 8),
    "packed4_proxy": ({**QUANT, "max_bin": 15}, 9),
    "packed4_exact": ({"max_bin": 15}, 8),
}


def _check_models(jtext, ttext, X, y):
    jm = JaxGBDT().load_model_from_string(jtext)
    tm = TorchGBDT(device="cpu").load_model_from_string(ttext)
    assert len(jm.models) == len(tm.models)
    assert tree_diff(jm.models, tm.models) is None
    for a, b in zip(jm.models, tm.models):
        np.testing.assert_array_equal(b.leaf_value, a.leaf_value)
        np.testing.assert_array_equal(b.internal_value, a.internal_value)
    pj, pt = jm.predict(X), tm.predict(X)
    assert abs(auc_np(y, pj) - auc_np(y, pt)) <= AUC_TOL
    for text, own in ((ttext, pt), (jtext, pj)):
        np.testing.assert_allclose(
            JaxGBDT().load_model_from_string(text).predict(X), own,
            atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(
            lgt.Booster(model_str=text, device="cpu").predict(X), own,
            atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_matches_jax(name):
    extra, seed = CONFIGS[name]
    X, y = make_higgs_like(8000, seed=seed)
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 31,
              "min_data_in_leaf": 20, "bagging_fraction": 0.8,
              "bagging_freq": 3, "verbose": -1, **extra}
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=20)
    tb = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=20,
                   device="cpu")
    cfg = tb._gbdt._grower_cfg
    assert cfg.packed4 == name.startswith("packed4")
    assert cfg.precision == ("f32" if name == "packed4_exact" else "int8")
    if cfg.packed4:
        assert tb._gbdt.train_data.packed4
    _check_models(jb.model_to_string(), tb.model_to_string(), X, y)


def test_capi_sequence_int8_matches_jax():
    params = {**TRAIN_PARAMS, "tpu_quantized_hist": "true",
              "tpu_count_proxy": "0", "num_iterations": "20"}
    X = make_lrb_rows(3000, seed=17)
    y = lrb_labels(X, seed=18)
    Xn = make_lrb_rows(500, seed=7)
    out = {}
    for name, capi, kw in (("jax", jcapi, {}), ("port", tcapi,
                                                {"device": "cpu"})):
        ds = capi.LGBM_DatasetCreateFromMat(X, parameters=params, **kw)
        capi.LGBM_DatasetSetField(ds, "label", y)
        bst = capi.LGBM_BoosterCreate(ds, params)
        for _ in range(20):
            if capi.LGBM_BoosterUpdateOneIter(bst):
                break
        out[name] = (dict(capi.LGBM_BoosterGetEval(bst, 0)),
                     capi.LGBM_BoosterSaveModelToString(bst),
                     np.asarray(capi.LGBM_BoosterPredictForMat(bst, Xn)))
    assert abs(out["port"][0]["auc"] - out["jax"][0]["auc"]) <= AUC_TOL
    _check_models(out["jax"][1], out["port"][1], X, y)
    np.testing.assert_allclose(out["port"][2], out["jax"][2], atol=1e-5)


# -- the tier resolution ------------------------------------------------------

@pytest.mark.parametrize("extra", [
    {}, {"tpu_quantized_hist": True},
    {"tpu_quantized_hist": True, "tpu_count_proxy": 0},
    {"tpu_quantized_hist": True, "tpu_count_proxy": 1},
    {"max_bin": 15}, {"max_bin": 15, "tpu_quantized_hist": True},
    {"max_bin": 15, "tpu_quantized_hist": True, "tpu_packed_bins": 0},
    {"max_bin": 15, "tpu_quantized_hist": True, "tpu_count_proxy": 0},
    {"max_bin": 15, "tpu_use_dp": False},
    {"tpu_quantized_hist": True, "tpu_wave_size": 100},
    {"tpu_quantized_hist": True, "tpu_count_proxy": 0, "tpu_wave_size": 48},
    {"tpu_wave_size": 100}, {"num_leaves": 7, "tpu_quantized_hist": True}])
def test_tier_resolution_matches_jax(extra):
    X, y = make_higgs_like(600)
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
              **extra}
    logs = {}
    for name, mod, log in (("jax", lgb, jlog), ("port", lgt, tlog)):
        lines = []
        level = log.get_level()
        log.set_callback(lines.append)
        try:
            kw = {"device": "cpu"} if name == "port" else {}
            ds = mod.Dataset(X, label=y)
            log.set_level(log.LogLevel.INFO)
            bst = mod.Booster(params, ds, **kw)
        finally:
            log.set_callback(None)
            log.set_level(level)
        logs[name] = [ln for ln in lines
                      if "tpu_" in ln or "lane cap" in ln or "4-bit" in ln]
        logs[name + "_cfg"] = bst._gbdt._grower_cfg
    j, t = logs["jax_cfg"], logs["port_cfg"]
    assert t.wave_size == j.wave_size
    assert t.precision == {"int8": "int8"}.get(j.precision, "f32")
    assert (t.count_proxy, t.packed4, t.hp.count_lb) == \
        (j.count_proxy, j.packed4, j.hp.count_lb)
    assert logs["port"] == logs["jax"]
