"""Port parity: the binary objective's gradients, the shape-stable root
sum, the wave grower and the TreeRecord converter against the JAX
package.

Bars: the gradients within 2 ulp and the hessians within 2 ulp plus 2
ulp of the sigmoid. XLA's f32 exp on the CPU is not correctly rounded
(about 9% of inputs off by 1 ulp) and PyTorch's is nearly so (about 1%);
the division passes a 1-ulp exp difference on as up to 2 ulp of g, and
h = |g| (sigmoid - |g|) loses the rest to the cancellation where |g|
nears the sigmoid. Boost-from-average and the root sum bit for bit. On
the same bins, g, h, bagging mask and feature mask, with the wave width
W pinned and at the JAX package's bucketed histogram widths: every row's
leaf id and every TreeRecord field bit for bit, except split_gain within
4 ulp (with L1 or L2 regularization XLA fuses the gain expression into
other roundings than PyTorch's one op at a time, as in
test_torch_split.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.models.tree import tree_from_record as j_tree_from_record
from lightgbm_tpu.objectives import create_objective as j_create_objective
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops import wave_grower as jwg
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import mapper_from_dict, tree_record_from_numpy
from lightgbm_tpu_torch.io.binning import BinMapper
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.models.tree import tree_from_record
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.ops import wave_grower as twg
from lightgbm_tpu_torch.ops.predict import replay_partition

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

CPU = torch.device("cpu")


def _within_ulps(got, want, ulps, extra=0.0) -> bool:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = ulps * np.spacing(np.abs(want)) + extra
    return bool((np.abs(got - want) <= tol).all())


@pytest.mark.parametrize("params,weighted", [
    ({}, False), ({"sigmoid": 0.7}, False), ({"is_unbalance": True}, True),
    ({"scale_pos_weight": 3.0}, False)])
def test_binary_gradients_within_two_ulp(params, weighted):
    r = np.random.default_rng(len(params) + weighted)
    n = 5000
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
    sig = np.float32(full.get("sigmoid", 1.0))
    scale = max(float(to.label_weight.max()), 1.0)
    assert _within_ulps(tg.numpy(), jg, 2)
    assert _within_ulps(th.numpy(), jh, 2,
                        2 * scale * float(sig) * float(np.spacing(sig)))
    assert to.boost_from_score(0) == jo.boost_from_score(0)


@pytest.mark.parametrize("n", [1, 100, 8192, 8193, 50_000, 123_457])
def test_stable_sum_bit_equal(n):
    v = (np.random.default_rng(n).normal(size=n)
         * np.random.default_rng(n + 1).random(n)).astype(np.float32)
    want = float(np.asarray(jwg._stable_sum(jnp.asarray(v))))
    assert float(twg._stable_sum(torch.from_numpy(v))) == want


def _case(F, n, B, seed, nan_feature=True):
    r = np.random.default_rng(seed)
    nb = r.integers(4, B + 1, F).astype(np.int32)
    nb[0] = B
    mt = r.integers(0, 3, F).astype(np.int32)
    if not nan_feature:
        mt[:] = 0
    db = np.array([r.integers(0, b) for b in nb], np.int32)
    bins = np.stack([r.integers(0, nb[f], n) for f in range(F)]) \
        .astype(np.uint8)
    g = r.normal(size=n).astype(np.float32)
    h = r.uniform(0.05, 0.25, n).astype(np.float32)
    meta = dict(num_bin=nb, missing_type=mt, default_bin=db,
                monotone=np.zeros(F, np.int32),
                penalty=np.ones(F, np.float32))
    return r, bins, g, h, meta


def _grow_both(bins, g, h, mask, fmask, meta, L, B, W, hp, max_depth=-1):
    jg = jwg.make_wave_grower(
        jwg.WaveGrowerConfig(num_leaves=L, num_bins=B, wave_size=W,
                             max_depth=max_depth,
                             hp=js.SplitParams(**hp, has_cat=False)),
        js.FeatureMeta(**meta))
    jrec, jleaf = jg(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                     jnp.asarray(mask), jnp.asarray(fmask))
    tg = twg.WaveGrower(
        twg.WaveGrowerConfig(num_leaves=L, num_bins=B, wave_size=W,
                             max_depth=max_depth, hp=ts.SplitParams(**hp)),
        ts.FeatureMeta(**meta), CPU)
    trec, tleaf = tg.grow(torch.from_numpy(bins), torch.from_numpy(g),
                          torch.from_numpy(h), torch.from_numpy(mask),
                          torch.from_numpy(fmask))
    return jrec, np.asarray(jleaf), trec, tleaf.numpy(), tg


@pytest.mark.parametrize("F,n,B,L,W,hp,max_depth", [
    (6, 4000, 64, 15, 4, {"min_data_in_leaf": 20.0}, -1),
    (6, 4000, 64, 15, 1, {"min_data_in_leaf": 20.0}, -1),
    (8, 3000, 256, 31, 30, {"min_data_in_leaf": 50.0,
                            "min_sum_hessian_in_leaf": 5.0}, -1),
    (5, 3000, 64, 31, 8, {"min_data_in_leaf": 10.0, "lambda_l1": 0.3,
                          "lambda_l2": 1.0}, 4),
    (7, 2500, 128, 63, 32, {"min_data_in_leaf": 5.0,
                            "min_gain_to_split": 0.05}, -1)])
def test_grower_record_bit_equal(F, n, B, L, W, hp, max_depth):
    r, bins, g, h, meta = _case(F, n, B, seed=F * n + W)
    mask = (r.random(n) < 0.8).astype(np.float32)
    fmask = r.random(F) < 0.85
    fmask[0] = True
    jrec, jleaf, trec, tleaf, tg = _grow_both(bins, g, h, mask, fmask, meta,
                                              L, B, W, hp, max_depth)
    np.testing.assert_array_equal(tleaf, jleaf)
    tn = trec.to_numpy()
    assert tn["num_leaves"] == int(jrec.num_leaves) > 1
    for k in twg.TreeRecord._fields:
        want = np.asarray(getattr(jrec, k))
        if k == "split_gain":
            np.testing.assert_array_less(
                np.abs(tn[k] - want), 4 * np.spacing(np.abs(want)) + 1e-30)
            continue
        np.testing.assert_array_equal(np.asarray(tn[k]), want, err_msg=k)
    # replaying the record's splits reaches the grower's leaf ids
    np.testing.assert_array_equal(
        replay_partition(trec, torch.from_numpy(bins), tg.meta).numpy(),
        tleaf)


def test_unsplittable_root():
    r, bins, g, h, meta = _case(3, 500, 64, seed=1)
    mask = np.ones(500, np.float32)
    fmask = np.ones(3, bool)
    jrec, jleaf, trec, tleaf, _ = _grow_both(
        bins, g, h, mask, fmask, meta, 15, 64, 4,
        {"min_data_in_leaf": 400.0})
    assert trec.num_leaves == int(jrec.num_leaves) == 1
    np.testing.assert_array_equal(tleaf, jleaf)


def test_tree_record_converter():
    """A JAX TreeRecord, carried over, builds the same host tree."""
    r, bins, g, h, meta = _case(5, 3000, 64, seed=3)
    mask = np.ones(3000, np.float32)
    jrec, _, trec, _, _ = _grow_both(bins, g, h, mask, np.ones(5, bool),
                                     meta, 15, 64, 4,
                                     {"min_data_in_leaf": 20.0})
    conv = tree_record_from_numpy(
        {k: np.asarray(v) for k, v in jrec._asdict().items()}, device="cpu")
    for k in twg.TreeRecord._fields:
        np.testing.assert_array_equal(np.asarray(conv.to_numpy()[k]),
                                      np.asarray(trec.to_numpy()[k]))
    # host trees from the record: the same model text in both packages
    mappers = []
    for f in range(5):
        m = BinMapper()
        m.find_bin(np.linspace(-3, 3, 400) + f, 500, 63, 3, 0)
        mappers.append(m)
    used = np.arange(5)
    jtree = j_tree_from_record(
        {k: np.asarray(v) for k, v in jrec._asdict().items()},
        [_jax_mapper(m) for m in mappers], used, 1.0, 15)
    ttree = tree_from_record(conv.to_numpy(), mappers, used, 15)
    assert ttree.to_string() == jtree.to_string()


def _jax_mapper(m):
    from lightgbm_tpu.io.binning import BinMapper as JBinMapper
    d = {"num_bin": m.num_bin, "missing_type": m.missing_type,
         "bin_type": 0, "is_trivial": m.is_trivial,
         "sparse_rate": m.sparse_rate,
         "bin_upper_bound": m.bin_upper_bound.tolist(),
         "bin_2_categorical": [], "min_val": m.min_val,
         "max_val": m.max_val, "default_bin": m.default_bin}
    assert mapper_from_dict(d).num_bin == m.num_bin
    return JBinMapper.from_dict(d)
