"""Port parity for categorical features in training: lightgbm_tpu_torch
against lightgbm_tpu on the CPU.

What is held, and to which bar:
- the categorical BinMapper (every field, ``feature_info``) and the
  device bins, bit for bit: the golden2 ``catbin`` columns, a scrambled
  category set, negative values and NaN, a most frequent category 0 (the
  swap out of bin 0), more categories than ``max_bin`` (the 99% cut and
  the last bin for the rest) and ``min_data_in_bin`` cuts;
- XLA's order of a cumsum on the CPU (``xla_cumsum``: 16-wide blocks,
  sequential inside, a running total of the blocks added once), bit for
  bit against the jitted ``jnp.cumsum`` and against the prefix sums of
  the JAX package's ``_categorical_tables``;
- ``find_best_split`` with ``has_cat`` on random histograms (one-hot
  features, sorted mode from both ends, ``max_cat_threshold`` and
  ``min_data_per_group`` binding, numerical and categorical features
  together): every field equal, the bitset included, gains within 4 ulp
  (the bar of test_torch_grower.py; here they are equal). XLA contracts
  the categorical gain's ``2 g out + (h + l2) out^2`` into a fused
  multiply-add, and the port rounds it so too;
- the plain K1 with categorical slots against the JAX package's XLA
  route and its Pallas kernel in interpret mode (``any_cat=True``), on
  the f32 and int8 tiers and with packed bins: bit for bit;
- the grower's TreeRecord against ``make_wave_grower(has_cat=True)``:
  every field bit for bit;
- ``train`` and the C-API sequence (``categorical_feature=0,2``) on the
  golden2 catbin set with that model's parameters, on the exact tier,
  the int8 tier and with packed bins: every tree equal in structure,
  counts, leaf values and categorical bitsets, AUC within 4e-4, each
  package loads the other's text. The model texts are equal but for the
  split gains of a few categorical splits, 1 or 2 ulp apart: there the
  JAX package's compiled boosting step rounds the gain otherwise than
  its own grower run alone, which the port equals bit for bit on the
  same gradients (``test_grower_record_bit_equal``);
- the tier resolution with categorical features against the JAX
  package's ``_setup_grower``, its warning for ``tpu_count_proxy=1``
  included.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from chip_smoke import auc_np, tree_diff
from lightgbm_tpu import capi as jcapi
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.io.dataset import TpuDataset
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.ops import hist_wave as jhw
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops import wave_grower as jwg
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import mapper_from_dict
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.models.gbdt import GBDT as TorchGBDT
from lightgbm_tpu_torch.ops import hist_wave as hw
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.ops import wave_grower as twg
from lightgbm_tpu_torch.ops.predict import replay_partition
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port

DATA = os.path.join(os.path.dirname(__file__), "data", "golden2")
CPU = torch.device("cpu")
AUC_TOL = 4e-4
# g2_catbin_ours_model.txt's parameters
CATBIN_PARAMS = {"objective": "binary", "num_leaves": 15,
                 "learning_rate": 0.1, "min_data_in_leaf": 10,
                 "min_data_per_group": 5, "max_bin": 63,
                 "min_data_in_bin": 3, "verbose": -1}
MAPPER_FIELDS = ("num_bin", "missing_type", "bin_type", "default_bin",
                 "is_trivial", "sparse_rate", "min_val", "max_val",
                 "bin_2_categorical")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small PyTorch ops: one thread each under parallel test
    workers (see test_torch_train.py), restored after."""
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


def _catbin():
    X = np.fromfile(os.path.join(DATA, "g2_catbin_X.bin"),
                    np.float64).reshape(600, 8)
    y = np.fromfile(os.path.join(DATA, "g2_catbin_y.bin"), np.float32)
    return X, y


def _cat_problem(n=1200, n_cat=12, seed=5):
    """tests/test_categorical.py's set: the label follows a scrambled
    category set of column 0."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, n_cat, n)
    logit = np.where(np.isin(cat, [1, 4, 7, 10]), 2.0, -2.0)
    y = (logit + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    return np.column_stack([cat.astype(np.float64), rng.normal(size=n)]), y


def _mapper_rows(case):
    """(X, categorical columns, params) of each binning case."""
    r = np.random.default_rng(3)
    n = 2000
    if case == "catbin":
        return _catbin()[0], [0, 2], {"max_bin": 63, "min_data_in_bin": 3}
    if case == "cat_problem":
        return _cat_problem()[0], [0], {}
    X = np.column_stack([r.normal(size=n), r.normal(size=n)])
    if case == "negative_nan":
        c = r.integers(-3, 9, n).astype(np.float64)
        c[r.random(n) < 0.05] = np.nan
        c[::37] = 2.7                       # truncates to category 2
        c[::41] = -0.5                      # truncates to category 0
    elif case == "zero_most_frequent":
        c = np.where(r.random(n) < 0.5, 0, r.integers(1, 6, n))
    elif case == "many_categories":
        # Zipf-like counts over 400 codes: the 99% cut and max_bin bind
        c = np.minimum(r.zipf(1.3, n), 400).astype(np.float64) - 1
    elif case == "min_data_in_bin":
        c = np.concatenate([r.integers(0, 4, n - 9), np.arange(4, 13)])
    X = np.column_stack([c.astype(np.float64), X])
    params = {"many_categories": {"max_bin": 63},
              "min_data_in_bin": {"min_data_in_bin": 5}}.get(case, {})
    return X, [0], params


MAPPER_CASES = ["catbin", "cat_problem", "negative_nan",
                "zero_most_frequent", "many_categories", "min_data_in_bin"]


@pytest.mark.parametrize("case", MAPPER_CASES)
def test_mappers_and_bins_bit_equal(case):
    X, cats, params = _mapper_rows(case)
    y = (np.arange(X.shape[0]) % 3 == 0).astype(np.float32)
    params = {**params, "enable_bundle": False}
    jd = TpuDataset(JConfig().set(dict(params))).construct_from_matrix(
        X, JMeta(label=y), categorical=cats)
    td = BinnedDataset(TConfig().set(dict(params)), "cpu") \
        .construct_from_matrix(X, Metadata(label=y), categorical=cats)
    assert list(td.used_feature_map) == list(jd.used_feature_map)
    assert td.max_bin_global == jd.max_bin_global
    for jm, tm in zip(jd.mappers, td.mappers):
        for k in MAPPER_FIELDS:
            assert getattr(tm, k) == getattr(jm, k), k
        np.testing.assert_array_equal(tm.bin_upper_bound, jm.bin_upper_bound)
        assert tm.categorical_2_bin == jm.categorical_2_bin
        for b in range(tm.num_bin - 1):
            assert tm.bin_to_value(b) == jm.bin_to_value(b)
    assert td.feature_infos() == jd.feature_infos()
    for a, b in zip(td.feature_meta(), jd.feature_meta()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(td.bins_t.numpy(),
                                  np.asarray(jd.host_bins()).T)
    cm = td.mappers[td.real_to_inner[cats[0]]]
    assert cm.bin_type == 1
    if case == "zero_most_frequent":
        assert cm.bin_2_categorical[0] != 0 and cm.bin_2_categorical[1] == 0
    if case == "many_categories":
        assert cm.num_bin <= 63 < len(np.unique(X[:, 0]))
    # the mapper carried over from the JAX package's state is the same
    for jm, tm in zip(jd.mappers, td.mappers):
        cv = mapper_from_dict(jm.to_dict())
        for k in MAPPER_FIELDS:
            assert getattr(cv, k) == getattr(tm, k), k
        assert cv.categorical_2_bin == tm.categorical_2_bin


def test_device_bins_of_unseen_and_odd_values():
    """Values without a bin, negative, NaN, infinite or beyond int64 go
    to the last bin; fractions truncate toward zero, as
    ``BinMapper.value_to_bin``."""
    X, cats, params = _mapper_rows("many_categories")
    td = BinnedDataset(TConfig().set(params), "cpu").construct_from_matrix(
        X, Metadata(label=np.zeros(len(X))), categorical=cats)
    m = td.mappers[0]
    odd = np.array([0.0, -0.0, -0.7, 2.9, 399.0, 1e4, -1.0, np.nan, np.inf,
                    -np.inf, 1e30, -1e30, float(m.bin_2_categorical[3]) + 0.5])
    from lightgbm_tpu_torch.io.dataset import category_bins
    got = category_bins(torch.from_numpy(odd), m).numpy()
    np.testing.assert_array_equal(got, m.value_to_bin(odd))
    assert got[1] == got[0] == got[2] and got[6] == m.num_bin - 1


@pytest.mark.parametrize("B", [16, 32, 37, 64, 256])
def test_xla_cumsum_bit_equal(B):
    """The categorical scan's order of addition: XLA's CPU cumsum is a
    two-level scan over 16-wide blocks, which neither a sequential nor
    ``torch.cumsum``'s order gives."""
    r = np.random.default_rng(B)
    x = (r.normal(size=(3, 5, B)) * r.random((3, 5, B)) * 1e3) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(
        jnp.asarray(x)))
    got = ts.xla_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if B > 16:
        seq = np.add.accumulate(x, axis=-1, dtype=np.float32)
        assert (seq != want).any()


def _meta(nb, mt, is_cat):
    F = len(nb)
    return dict(num_bin=np.asarray(nb, np.int32),
                missing_type=np.asarray(mt, np.int32),
                default_bin=np.zeros(F, np.int32),
                monotone=np.zeros(F, np.int32),
                penalty=np.ones(F, np.float32),
                is_cat=np.asarray(is_cat, np.int32))


def _hists(r, M, nb, B, scale=60):
    F = len(nb)
    hist = np.zeros((M, F, B, 3), np.float32)
    for m in range(M):
        for f in range(F):
            c = r.integers(0, scale, nb[f]).astype(np.float32)
            hist[m, f, :nb[f], 2] = c
            hist[m, f, :nb[f], 0] = (r.normal(size=nb[f]) * c * 0.3) \
                .astype(np.float32)
            hist[m, f, :nb[f], 1] = (c * r.uniform(0.1, 0.25, nb[f])) \
                .astype(np.float32)
    return hist


SPLIT_CASES = {
    # one-hot features (num_bin <= max_cat_to_onehot) beside sorted ones
    "onehot": ([4, 3, 12], [0, 2, 0], [1, 1, 1], 32,
               {"min_data_in_leaf": 5.0, "lambda_l2": 0.5}),
    "sorted": ([40, 20, 9], [0, 2, 0], [1, 1, 1], 64,
               {"min_data_in_leaf": 5.0, "min_data_per_group": 10.0,
                "cat_smooth": 5.0}),
    "max_cat_threshold": ([60, 33], [0, 0], [1, 1], 64,
                          {"min_data_in_leaf": 2.0, "max_cat_threshold": 3,
                           "min_data_per_group": 1.0, "cat_smooth": 1.0}),
    "min_data_per_group": ([30, 25], [2, 0], [1, 1], 32,
                           {"min_data_in_leaf": 5.0,
                            "min_data_per_group": 150.0}),
    "mixed": ([64, 12, 50, 3, 200], [2, 0, 1, 0, 0], [0, 1, 0, 1, 1], 256,
              {"min_data_in_leaf": 10.0, "lambda_l1": 0.2, "cat_l2": 3.0,
               "max_cat_to_onehot": 3}),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_find_best_split_bit_equal(case):
    nb, mt, ic, B, hp = SPLIT_CASES[case]
    r = np.random.default_rng(len(case))
    M, F = 8, len(nb)
    hist = _hists(r, M, nb, B)
    sg, sh, nd = [hist[:, 0, :, k].sum(1) for k in range(3)]
    fmask = np.ones(F, bool)
    can = np.ones(M, bool)
    can[-1] = False
    meta = _meta(nb, mt, ic)
    jm = js.FeatureMeta(**{k: jnp.asarray(v) for k, v in meta.items()})
    jhp = js.SplitParams(**hp, has_cat=True)

    def one(h, a, b, c, cs):
        return js.find_best_split(h, a, b, c, jnp.asarray(fmask), jm, jhp,
                                  cs)
    want = jax.jit(jax.vmap(one))(jnp.asarray(hist), sg, sh, nd,
                                  jnp.asarray(can))
    got = ts.find_best_split(
        torch.from_numpy(hist), torch.from_numpy(sg), torch.from_numpy(sh),
        torch.from_numpy(nd), torch.from_numpy(fmask),
        ts.FeatureMeta(**meta).to("cpu"), ts.SplitParams(**hp, has_cat=True),
        torch.from_numpy(can))
    for k in ts.SplitResult._fields:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        if k == "gain":
            fin = np.isfinite(b)
            assert (np.isfinite(a) == fin).all()
            np.testing.assert_array_less(
                np.abs(a[fin] - b[fin]), 4 * np.spacing(np.abs(b[fin])) + 1e-30)
            continue
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert np.asarray(want.is_cat).any()


@pytest.mark.parametrize("B", [32, 256])
def test_categorical_prefix_sums_follow_xla(B):
    """The sorted scans' side sums against ``_categorical_tables``'
    ``lg_p``, ``lh_p``, ``lg_m``, ``lh_m`` over the positions a
    candidate can take (below max_cat_threshold): bit for bit."""
    r = np.random.default_rng(B)
    nb = [B, B // 2, 20]
    hist = _hists(r, 1, nb, B, scale=400)[0]
    meta = _meta(nb, [0, 2, 0], [1, 1, 1])
    hp = {"min_data_in_leaf": 5.0, "cat_smooth": 1.0,
          "max_cat_threshold": 64}
    sg, sh, nd = [np.float32(hist[0, :, k].sum()) for k in range(3)]
    jm = js.FeatureMeta(**{k: jnp.asarray(v) for k, v in meta.items()})
    jhp = js.SplitParams(**hp, has_cat=True)

    @jax.jit
    def tables(h):
        _, _, mgs, ctx = js._candidate_tables(
            h, sg, sh, nd, jnp.ones(3, bool), jm, jhp, True)
        c = js._categorical_tables(h, ctx["sum_g"], ctx["sum_h2"],
                                   ctx["num_data"], jnp.ones(3, bool), jm,
                                   jhp, True, mgs)[2]
        return c["lg_p"], c["lh_p"], c["lg_m"], c["lh_m"], c["used"]
    want = [np.asarray(v) for v in tables(jnp.asarray(hist))]
    sh2 = torch.tensor([[[sh]]]) + ts._f32(2 * ts.KEPSILON)
    ctx = ts._categorical_tables(
        torch.from_numpy(hist)[None], torch.tensor([[[sg]]]), sh2,
        torch.tensor([[[nd]]]), torch.ones(1, 3, 1, dtype=torch.bool),
        ts.FeatureMeta(**meta).to("cpu"), ts.SplitParams(**hp, has_cat=True),
        ts.leaf_split_gain(torch.tensor([[[sg]]]), sh2, 0.0, 0.0, 0.0))[2]
    P = ctx["P"]
    assert P == min(B, 64) and want[4].max() > 16
    for d, (g_want, h_want) in enumerate(((want[0], want[1]),
                                          (want[2], want[3]))):
        np.testing.assert_array_equal(ctx["lg"][d, 0].numpy(),
                                      g_want[:, :P])
        np.testing.assert_array_equal(ctx["lh"][d, 0].numpy(),
                                      h_want[:, :P])


# -- K1 with categorical slots -----------------------------------------------

def _cat_table(r, F, B, W, leaf_hi, active, nb, iscat):
    """A wave's split table (parents distinct leaves below ``leaf_hi``,
    ``active`` slots live) whose categorical slots carry random left
    sets over their feature's bins."""
    wl = np.full(W, -1, np.int32)
    wl[:active] = r.choice(leaf_hi, active, replace=False)
    new_ids = np.where(wl >= 0, leaf_hi + np.arange(W), -1).astype(np.int32)
    feat = r.integers(0, F, W).astype(np.int32)
    small = np.where(r.random(W) < 0.5, wl, new_ids).astype(np.int32)
    small[active:] = -1
    words = r.integers(-2 ** 31, 2 ** 31, (W, 8)).astype(np.int32)
    is_cat = iscat[feat].astype(np.int32)
    words[is_cat == 0] = 0
    return dict(wl=wl, new_ids=new_ids, feat=feat,
                tbin=r.integers(0, B - 1, W).astype(np.int32),
                dleft=r.integers(0, 2, W).astype(np.int32),
                miss=r.integers(0, 3, W).astype(np.int32),
                defb=r.integers(0, B, W).astype(np.int32),
                nb=nb[feat].astype(np.int32), small=small, iscat=is_cat,
                catw=words)


def _tbl(t):
    return torch.from_numpy(np.concatenate([np.stack([
        t[k] for k in ("wl", "new_ids", "feat", "tbin", "dleft", "miss",
                       "defb", "nb", "small", "iscat")]), t["catw"].T])
        .astype(np.int32))


@pytest.mark.parametrize("tier", ["f32", "int8", "f32_packed4",
                                  "proxy_packed4"])
def test_fused_partition_histogram_categorical_plain_bit_equal(tier):
    F, n, W = 5, 900, 12
    B = 16 if tier.endswith("packed4") else 64
    r = np.random.default_rng(len(tier))
    nb = np.full(F, B, np.int32)
    iscat = np.array([1, 0, 1, 0, 1])
    bins = r.integers(0, B, (F, n)).astype(np.uint8)
    mask = (r.random(n) < 0.8).astype(np.float32)
    leaf = r.integers(0, 2 * W + 2, n).astype(np.int32)
    int8 = not tier.startswith("f32")
    proxy = tier.startswith("proxy")
    if int8:
        g = (r.integers(-127, 128, n) * mask).astype(np.float32)
        h = (r.integers(0, 128, n) * mask).astype(np.float32)
        scale = (np.float32(3e-3), np.float32(4e-4))
    else:
        g = (r.normal(size=n) * mask).astype(np.float32)
        h = (r.random(n) * 0.25 * mask).astype(np.float32)
        scale = None
    t = _cat_table(r, F, B, W, 2 * W + 2, W - 3, nb, iscat)
    assert t["iscat"].any() and not t["iscat"].all()
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    want = jhw.fused_partition_histogram_xla(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(mask),
        jnp.asarray(leaf), jt["wl"], jt["new_ids"], jt["feat"], jt["tbin"],
        jt["dleft"] != 0, jt["iscat"] != 0, jt["catw"], jt["small"],
        jt["miss"], jt["defb"], jt["nb"], num_bins=B, count_proxy=proxy,
        gh_scale=scale)
    packed = tier.endswith("packed4")
    tb = torch.from_numpy(bins)
    tb = hw.pack4(tb) if packed else tb
    kw = dict(precision="int8" if int8 else "f32", count_proxy=proxy,
              packed4=packed, num_features=F, any_cat=True,
              gh_scale=None if scale is None
              else tuple(torch.tensor(s) for s in scale))
    gd = torch.int8 if int8 else torch.float32
    got = hw.fused_partition_histogram(
        tb, torch.from_numpy(g).to(gd), torch.from_numpy(h).to(gd),
        torch.from_numpy(mask), torch.from_numpy(leaf), _tbl(t), B, **kw)
    C = 2 if proxy else 3
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(want[1])[..., :C])
    if proxy:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # categorical slots moved rows by their bitsets
    moved = got[0].numpy() != leaf
    cat_parents = t["wl"][(t["iscat"] == 1) & (t["wl"] >= 0)]
    assert moved[np.isin(leaf, cat_parents)].any()
    # the Pallas kernel in interpret mode (its table padded to 24 rows)
    if tier in ("f32", "f32_packed4"):
        return        # the hi/lo exact tier is held by its own tests
    ptbl = jnp.concatenate([jnp.asarray(_tbl(t).numpy()),
                            jnp.zeros((6, W), jnp.int32)])
    pout = jhw.fused_partition_histogram_pallas(
        jnp.asarray(tb.numpy()), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(mask), jnp.asarray(leaf), ptbl, num_bins=B, chunk=256,
        interpret=True, precision="int8", gh_scale=scale, any_cat=True,
        count_proxy=proxy, packed4=packed,
        num_features=F if packed else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(pout[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(pout[1]))


def test_cat_bit_left_matches_jax():
    """The left-set test of one categorical split, bins past the 256-bit
    set included (they go right, as in the JAX package)."""
    from lightgbm_tpu.ops.partition import row_goes_right as j_right
    from lightgbm_tpu_torch.ops.partition import row_goes_right as t_right
    r = np.random.default_rng(2)
    bins = r.integers(0, 300, 2000).astype(np.int32)
    words = r.integers(-2 ** 31, 2 ** 31, 8).astype(np.int32)
    want = np.asarray(j_right(jnp.asarray(bins), 5, True, 2, 0, 300,
                              is_cat=True, cat_words=jnp.asarray(words)))
    got = t_right(torch.from_numpy(bins), 5, True, 2, 0, 300, True,
                  torch.from_numpy(words))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[bins >= 256].all() and not want.all()


def test_categorical_rows_read_only_with_any_cat():
    """Without ``any_cat`` the categorical rows are not read (the JAX
    kernel's static flag): a 9-row table gives what an 18-row one does."""
    F, n, W, B = 4, 700, 6, 32
    r = np.random.default_rng(9)
    t = _cat_table(r, F, B, W, 2 * W + 2, W, np.full(F, B, np.int32),
                   np.array([1, 1, 0, 0]))
    args = [torch.from_numpy(a) for a in (
        r.integers(0, B, (F, n)).astype(np.uint8),
        r.normal(size=n).astype(np.float32),
        r.random(n).astype(np.float32), np.ones(n, np.float32),
        r.integers(0, 2 * W + 2, n).astype(np.int32))]
    full = _tbl(t)
    a = hw.fused_partition_histogram(*args, full, B)
    b = hw.fused_partition_histogram(*args, full[:hw.TBL_ROWS_NUM], B)
    c = hw.fused_partition_histogram(*args, full, B, any_cat=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    with pytest.raises(lgt.LightGBMError):
        hw.fused_partition_histogram(*args, full[:hw.TBL_ROWS_NUM], B,
                                     any_cat=True)


# -- the grower -----------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_grower_record_bit_equal(precision):
    X, y = _catbin()
    jd = TpuDataset(JConfig().set({"max_bin": 63, "min_data_in_bin": 3})) \
        .construct_from_matrix(X, JMeta(label=y), categorical=[0, 2])
    bins = np.ascontiguousarray(np.asarray(jd.host_bins()).T)
    fm = jd.feature_meta()
    meta = {k: np.asarray(getattr(fm, k)) for k in (
        "num_bin", "missing_type", "default_bin", "monotone", "penalty",
        "is_cat")}
    F, n = bins.shape
    hp = {"min_data_in_leaf": 10.0, "min_data_per_group": 5.0,
          "lambda_l2": 0.3}
    kw = dict(num_leaves=15, num_bins=64, wave_size=8, precision=precision)
    jg = jwg.make_wave_grower(
        jwg.WaveGrowerConfig(**{**kw, "precision": (
            "int8" if precision == "int8" else "highest")},
            hp=js.SplitParams(**hp, has_cat=True)), js.FeatureMeta(**meta))
    tg = twg.WaveGrower(twg.WaveGrowerConfig(
        **kw, hp=ts.SplitParams(**hp, has_cat=True)),
        ts.FeatureMeta(**meta), CPU)
    r = np.random.default_rng(1)
    cats = 0
    for _ in range(3):
        g = (r.normal(size=n) * 0.5).astype(np.float32)
        h = r.uniform(0.1, 0.25, n).astype(np.float32)
        mask = (r.random(n) < 0.9).astype(np.float32)
        fmask = np.ones(F, bool)
        jrec, jleaf = jg(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                         jnp.asarray(mask), jnp.asarray(fmask))
        trec, tleaf = tg.grow(*[torch.from_numpy(a) for a in (
            bins, g, h, mask, fmask)])
        np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
        tn = trec.to_numpy()
        for k in twg.TreeRecord._fields:
            np.testing.assert_array_equal(np.asarray(tn[k]),
                                          np.asarray(getattr(jrec, k)),
                                          err_msg=k)
        cats += int(tn["split_is_cat"].sum())
        np.testing.assert_array_equal(
            replay_partition(trec, torch.from_numpy(bins), tg.meta).numpy(),
            tleaf.numpy())
    assert cats > 0


# -- training end to end ------------------------------------------------------

def _check_models(jtext, ttext, X, y):
    """Trees equal (structure, counts, leaf and internal values,
    categorical bitsets); the texts equal but for split gains within 4
    ulp; AUC within 4e-4; each package reads the other's text."""
    jm = JaxGBDT().load_model_from_string(jtext)
    tm = TorchGBDT(device="cpu").load_model_from_string(ttext)
    assert len(jm.models) == len(tm.models)
    assert tree_diff(jm.models, tm.models) is None
    assert sum(t.num_cat for t in tm.models) > 0
    for a, b in zip(jm.models, tm.models):
        assert (b.cat_boundaries, b.cat_threshold) == \
            (a.cat_boundaries, a.cat_threshold)
        np.testing.assert_array_equal(b.leaf_value, a.leaf_value)
        np.testing.assert_array_equal(b.internal_value, a.internal_value)
        ga = np.asarray(a.split_gain, np.float32)
        gb = np.asarray(b.split_gain, np.float32)
        np.testing.assert_array_less(np.abs(ga - gb),
                                     4 * np.spacing(np.abs(ga)) + 1e-30)

    def body(text):
        return [ln for ln in text.split("end of trees")[0].splitlines()
                if not ln.startswith(("split_gain=", "tree_sizes="))]
    assert body(ttext) == body(jtext)
    pj, pt = jm.predict(X), tm.predict(X)
    assert abs(auc_np(y, pj) - auc_np(y, pt)) <= AUC_TOL
    for text, own in ((ttext, pt), (jtext, pj)):
        np.testing.assert_allclose(
            JaxGBDT().load_model_from_string(text).predict(X), own,
            atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(
            lgt.Booster(model_str=text, device="cpu").predict(X), own,
            atol=1e-5, rtol=1e-6)


TIERS = {"exact": {}, "int8": {"tpu_quantized_hist": True},
         "packed4": {"max_bin": 15}}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_train_catbin_matches_jax(tier):
    X, y = _catbin()
    params = {**CATBIN_PARAMS, **TIERS[tier]}
    jb = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=[0, 2]),
                   num_boost_round=15)
    tb = lgt.train(params, lgt.Dataset(X, label=y, categorical_feature=[0, 2]),
                   num_boost_round=15, device="cpu")
    cfg = tb._gbdt._grower_cfg
    assert cfg.hp.has_cat and not cfg.count_proxy
    assert cfg.packed4 == (tier == "packed4")
    assert cfg.precision == ("int8" if tier == "int8" else "f32")
    _check_models(jb.model_to_string(), tb.model_to_string(), X, y)


def test_capi_catbin_matches_jax():
    X, y = _catbin()
    params = " ".join(f"{k}={v}" for k, v in CATBIN_PARAMS.items()) \
        + " categorical_feature=0,2 num_iterations=15 metric=auc" \
        " is_provide_training_metric=true"
    out = {}
    for name, capi, kw in (("jax", jcapi, {}),
                           ("port", tcapi, {"device": "cpu"})):
        ds = capi.LGBM_DatasetCreateFromMat(X, parameters=params, **kw)
        capi.LGBM_DatasetSetField(ds, "label", y)
        bst = capi.LGBM_BoosterCreate(ds, params)
        for _ in range(15):
            if capi.LGBM_BoosterUpdateOneIter(bst):
                break
        out[name] = (dict(capi.LGBM_BoosterGetEval(bst, 0)),
                     capi.LGBM_BoosterSaveModelToString(bst),
                     np.asarray(capi.LGBM_BoosterPredictForMat(bst, X)))
    assert abs(out["port"][0]["auc"] - out["jax"][0]["auc"]) <= AUC_TOL
    _check_models(out["jax"][1], out["port"][1], X, y)
    np.testing.assert_allclose(out["port"][2], out["jax"][2], atol=1e-5)


def test_pandas_category_columns_are_categorical():
    """Under ``categorical_feature="auto"`` a DataFrame's category
    columns are categorical, as in the JAX package."""
    pd = pytest.importorskip("pandas")
    X, y = _cat_problem(600)
    df = pd.DataFrame({"c": pd.Categorical(X[:, 0].astype(int)),
                       "x": X[:, 1]})
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    jb = lgb.train(params, lgb.Dataset(df, label=y), num_boost_round=5)
    tb = lgt.train(params, lgt.Dataset(df, label=y), num_boost_round=5,
                   device="cpu")
    inner = tb.train_set._inner
    assert inner.mappers[0].bin_type == 1
    assert inner.feature_names == ["c", "x"]
    _check_models(jb.model_to_string(), tb.model_to_string(), X, y)
    np.testing.assert_allclose(tb.predict(df), jb.predict(df), atol=1e-5)


@pytest.mark.parametrize("extra", [
    {}, {"tpu_quantized_hist": True},
    {"tpu_quantized_hist": True, "tpu_count_proxy": 1},
    {"tpu_quantized_hist": True, "tpu_count_proxy": 0, "tpu_wave_size": 64},
    {"max_bin": 15}, {"max_bin": 15, "tpu_quantized_hist": True}])
def test_tier_resolution_with_categorical_matches_jax(extra):
    X, y = _catbin()
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
              **extra}
    logs = {}
    for name, mod, log in (("jax", lgb, jlog), ("port", lgt, tlog)):
        lines = []
        level = log.get_level()
        log.set_callback(lines.append)
        try:
            kw = {"device": "cpu"} if name == "port" else {}
            ds = mod.Dataset(X, label=y, categorical_feature=[0, 2])
            log.set_level(log.LogLevel.INFO)
            bst = mod.Booster(params, ds, **kw)
        finally:
            log.set_callback(None)
            log.set_level(level)
        logs[name] = [ln for ln in lines
                      if "tpu_" in ln or "lane cap" in ln or "4-bit" in ln
                      or "categorical" in ln]
        logs[name + "_cfg"] = bst._gbdt._grower_cfg
    j, t = logs["jax_cfg"], logs["port_cfg"]
    assert j.hp.has_cat and t.hp.has_cat
    assert t.wave_size == j.wave_size
    assert t.precision == {"int8": "int8"}.get(j.precision, "f32")
    assert (t.count_proxy, t.packed4, t.hp.count_lb) == \
        (j.count_proxy, j.packed4, j.hp.count_lb) == \
        (False, j.packed4, False)
    for k in ("max_cat_to_onehot", "max_cat_threshold", "cat_l2",
              "cat_smooth", "min_data_per_group"):
        assert getattr(t.hp, k) == getattr(j.hp, k)
    assert logs["port"] == logs["jax"]
    if extra.get("tpu_count_proxy") == 1:
        assert any("no categorical features" in ln for ln in logs["port"])


# -- the kernel: only on a CUDA card ----------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.parametrize("tier", ["f32", "int8", "f32_packed4"])
def test_categorical_kernel_equals_plain(cuda, tier):
    """K1 with categorical slots: leaf ids equal to the plain version;
    int8 sums bit for bit, f32 sums equal to the plain version run on the
    CPU in the kernels' order (hist_wave.plain_in_kernel_order); two
    launches bit-identical."""
    F, n, W = 6, 300_000, 24
    B = 16 if tier.endswith("packed4") else 256
    r = np.random.default_rng(5)
    iscat = np.array([1, 0, 1, 0, 1, 1])
    t = _cat_table(r, F, B, W, 2 * W + 2, 20, np.full(F, B, np.int32),
                   iscat)
    int8 = tier == "int8"
    bins = torch.from_numpy(r.integers(0, B, (F, n)).astype(np.uint8))
    mask = torch.from_numpy((r.random(n) < 0.8).astype(np.float32))
    if int8:
        g = torch.from_numpy(r.integers(-127, 128, n).astype(np.int8))
        h = torch.from_numpy(r.integers(0, 128, n).astype(np.int8))
    else:
        g = torch.from_numpy(r.normal(size=n).astype(np.float32))
        h = torch.from_numpy(r.random(n).astype(np.float32))
    g, h = g * mask.to(g.dtype), h * mask.to(h.dtype)
    leaf = torch.from_numpy(r.integers(0, 2 * W + 2, n).astype(np.int32))
    packed = tier.endswith("packed4")
    kw = dict(precision="int8" if int8 else "f32", packed4=packed,
              num_features=F, any_cat=True)
    bt = hw.pack4(bins) if packed else bins
    args = [a.to(cuda) for a in (bt, g, h, mask, leaf, _tbl(t))]
    k1 = hw.fused_partition_histogram(*args, B, **kw)
    k2 = hw.fused_partition_histogram(*args, B, **kw)
    pkw = {k: kw[k] for k in ("packed4", "num_features", "any_cat")}
    if int8:
        want = hw.fused_partition_histogram_plain(*args, B, **pkw)
    else:
        want = hw.plain_in_kernel_order(hw.fused_partition_histogram_plain,
                                        *args, B, **pkw)
    for a, b, c in zip(k1, k2, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert hw.k1_cat_launches.value >= 2
