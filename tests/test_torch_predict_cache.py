"""The port's predict registry and incremental stack
(lightgbm_tpu_torch/ops/predict_cache.py, ``StackedModel.extend``,
``GBDT._stacked_model``) and K4 from rows, against the JAX package on
the CPU.

Bars: the registry's counter deltas (hits, misses, stacks, extends)
equal the JAX package's over the cases of tests/test_serving.py (a
retrained model of the same geometry hits, ``tpu_predict_cache=0``
counts nothing, continued training extends, a rollback reuses the stack
and a later append rebuilds it, ``SetLeafValue`` drops it); an extended
stack's tables equal a full rebuild's, and its raw scores equal the JAX
package's within 1e-5 (the golden corpus's bar); f32 rows through the C
API give the f64 rows' bits; K4 from rows on the CPU is its plain
version, ``codes_from_x`` then the plain walk. The kernel itself runs
only on a card (``-k card``).
"""
import numpy as np
import pytest
import torch

try:
    from conftest import TEST_PARAMS, fit_gbdt, make_binary
    from lightgbm_tpu import capi as jcapi
    from lightgbm_tpu.ops import predict_cache as jpc
except ImportError:
    # a machine with a card and no JAX runs the card tests alone:
    # pytest --noconftest tests/test_torch_predict_cache.py -k card
    jpc = None

import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.ops import forest as forest_ops
from lightgbm_tpu_torch.ops import predict_cache as tpc
from lightgbm_tpu_torch.ops import stacked_predict as tsp
from lightgbm_tpu_torch.testing import random_model_text

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

KEYS = ("hits", "misses", "stacks", "extends")


def _delta(a, b):
    return tuple(b[k] - a[k] for k in KEYS)


def _port_fit(X, y, params, num_round):
    return lgbt.train(dict(TEST_PARAMS, **params), lgbt.Dataset(X, label=y),
                      num_round, device="cpu")._gbdt


def _jax_fit(X, y, params, num_round):
    return fit_gbdt(X, y, params, num_round=num_round)


def _both(case):
    """The case run in each package from an empty registry (both are
    process-wide: earlier tests' geometries would turn misses into
    hits): its list of counter deltas."""
    out = []
    for fit, pc in ((_jax_fit, jpc), (_port_fit, tpc)):
        pc.clear()
        out.append(case(fit, pc))
    return out


def _retrain(fit, pc):
    params = dict(objective="binary")
    X, y = make_binary(n=1500, f=6, seed=13)
    Xt = np.random.default_rng(5).normal(size=(64, 6))
    g1 = fit(X, y, params, 10)
    s = [pc.stats()]
    g1.predict_raw(Xt)
    s.append(pc.stats())
    X2, y2 = make_binary(n=1500, f=6, seed=14)
    g2 = fit(X2, y2, params, 10)
    g2.predict_raw(Xt)
    s.append(pc.stats())
    g2.predict_raw(Xt[:32])
    s.append(pc.stats())
    return [_delta(a, b) for a, b in zip(s, s[1:])]


def _disabled(fit, pc):
    params = dict(objective="binary", tpu_predict_cache=0)
    X, y = make_binary(n=1200, f=6, seed=17)
    g = fit(X, y, params, 8)
    Xt = np.random.default_rng(6).normal(size=(100, 6))
    s0 = pc.stats()
    full = g.predict_raw(Xt)
    parts = [g.predict_raw(Xt[i:i + 7]) for i in range(0, 100, 7)]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    return [_delta(s0, pc.stats())[:2]]


def _extend(fit, pc):
    X, y = make_binary(n=1500, f=6, seed=19)
    g = fit(X, y, dict(objective="binary"), 10)
    Xt = np.random.default_rng(7).normal(size=(300, 6))
    g.predict_raw(Xt)
    s0 = pc.stats()
    for _ in range(5):
        g.train_one_iter()
    g.predict_raw(Xt)
    return [_delta(s0, pc.stats())[2:]]


def _rollback(fit, pc):
    X, y = make_binary(n=1500, f=6, seed=23)
    g = fit(X, y, dict(objective="binary"), 12)
    Xt = np.random.default_rng(8).normal(size=(200, 6))
    g.predict_raw(Xt)
    s = [pc.stats()]
    g.rollback_one_iter()
    g.predict_raw(Xt)
    s.append(pc.stats())
    g.train_one_iter()
    g.predict_raw(Xt)
    s.append(pc.stats())
    return [_delta(a, b)[2:] for a, b in zip(s, s[1:])]


@pytest.mark.parametrize("case", [_retrain, _disabled, _extend, _rollback],
                         ids=["retrain_hit", "disabled", "extend",
                              "rollback"])
def test_registry_counters_follow_jax(case):
    """tests/test_serving.py's registry cases, run in both packages on the
    same data: the same counter deltas at every step."""
    jax_seq, port_seq = _both(case)
    assert port_seq == jax_seq


def test_set_leaf_value_drops_the_stack():
    """SetLeafValue edits a tree in place: the next predict stacks anew
    (both packages count one stack) and scores the new leaf."""
    X, y = make_binary(n=800, f=5, seed=29)
    params = "objective=binary num_leaves=15 min_data_in_leaf=20"
    outs = []
    for capi, pc, kw in ((jcapi, jpc, {}), (tcapi, tpc, {"device": "cpu"})):
        ds = capi.LGBM_DatasetCreateFromMat(X, parameters=params, **kw)
        capi.LGBM_DatasetSetField(ds, "label", y)
        bst = capi.LGBM_BoosterCreate(ds, params)
        for _ in range(6):
            capi.LGBM_BoosterUpdateOneIter(bst)
        before = np.asarray(capi.LGBM_BoosterPredictForMat(
            bst, X[:64], predict_type=capi.C_API_PREDICT_RAW_SCORE))
        s0 = pc.stats()
        old = capi.LGBM_BoosterGetLeafValue(bst, 0, 0)
        capi.LGBM_BoosterSetLeafValue(bst, 0, 0, old + 5.0)
        after = np.asarray(capi.LGBM_BoosterPredictForMat(
            bst, X[:64], predict_type=capi.C_API_PREDICT_RAW_SCORE))
        leaf0 = np.asarray(capi.LGBM_BoosterPredictForMat(
            bst, X[:64], predict_type=capi.C_API_PREDICT_LEAF_INDEX))[:, 0]
        hit = leaf0 == 0
        assert hit.any() and not hit.all()
        np.testing.assert_allclose(after[hit], before[hit] + 5.0, atol=1e-5)
        np.testing.assert_allclose(after[~hit], before[~hit], atol=1e-6)
        outs.append((_delta(s0, pc.stats())[2:], after))
    assert outs[0][0] == outs[1][0] == (1, 0)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=0, atol=1e-5)


def test_extend_tables_equal_a_full_rebuild_and_jax_scores():
    """Continued training extends a clone of the stack: its decision rows
    and every compact table equal a stack built from scratch over all the
    trees, its scores are that stack's bits and the JAX package's within
    1e-5, and the published stack before the append is untouched."""
    X, y = make_binary(n=1500, f=6, seed=31)
    Xt = np.random.default_rng(9).normal(size=(500, 6))
    Xt[::11, 2] = np.nan
    g = _port_fit(X, y, dict(objective="binary"), 8)
    j = _jax_fit(X, y, dict(objective="binary"), 8)
    g.predict_raw(Xt)
    old = g._stacked_model()
    old_rec = old.forest.walk.rec.clone()
    for _ in range(6):
        g.train_one_iter()
        j.train_one_iter()
    got = g.predict_raw(Xt)
    sm = g._stacked_model()
    assert sm is not old and torch.equal(old.forest.walk.rec, old_rec)
    fresh = tsp.StackedModel(g.models, g.max_feature_idx + 1, 1,
                             torch.device("cpu"))
    np.testing.assert_array_equal(sm._dec, fresh._dec)
    for name in forest_ops.Walk._fields[:6]:
        assert torch.equal(getattr(sm.forest.walk, name),
                           getattr(fresh.forest.walk, name)), name
    np.testing.assert_array_equal(got, fresh.predict(Xt)[0])
    np.testing.assert_array_equal(
        g.predict_leaf_index(Xt), fresh.predict(Xt, pred_leaf=True))
    np.testing.assert_allclose(got, j.predict_raw(Xt), rtol=0, atol=1e-5)


def test_f32_rows_through_the_c_api_keep_the_f64_bits():
    """C_API_DTYPE_FLOAT32 rows reach the stacker as they are: the same
    scores and leaf indices as the same values in float64, and K4 from
    rows on the CPU is codes_from_x then the plain walk."""
    rng = np.random.default_rng(33)
    X = rng.normal(size=(700, 8)).astype(np.float32)
    X[::13, 3] = np.nan
    text = random_model_text(X.astype(np.float64), 40, 15, 7)
    h = tcapi.LGBM_BoosterLoadModelFromString(text, device="cpu")
    for ptype in (tcapi.C_API_PREDICT_RAW_SCORE,
                  tcapi.C_API_PREDICT_LEAF_INDEX):
        a = np.asarray(tcapi.LGBM_BoosterPredictForMat(
            h, X.astype(np.float64), predict_type=ptype))
        b = np.asarray(tcapi.LGBM_BoosterPredictForMat(
            h, X, data_type=tcapi.C_API_DTYPE_FLOAT32, predict_type=ptype))
        np.testing.assert_array_equal(a, b)
    sm = h.gbdt._stacked_model()
    x = torch.from_numpy(X)
    T = sm.num_trees
    before = forest_ops.launches.value
    for leaf in (False, True):
        got = forest_ops.forest_predict_from_x(x, sm.edges, sm.forest, 0, T,
                                               leaf_mode=leaf)
        want = forest_ops.forest_predict_plain(
            tsp.codes_from_x(x, *sm.edges), sm.forest, 0, T, leaf)
        assert torch.equal(got, want)
    assert forest_ops.launches.value == before   # the plain version


class _Rerun:
    """A stand-in CUDA graph: each replay runs the captured work again."""

    def __init__(self, fn, dev):
        self.fn = fn

    def replay(self):
        self.fn()


class _Passed:
    def record(self):
        pass

    def synchronize(self):
        pass


def test_serving_graphs_keep_their_tree_range(monkeypatch):
    """A serving graph bakes its tree range in, and ranges that span the
    same 32-tree chunks share one plan and registry entry: a 100-tree
    model scored at num_iteration 40, then 50, then a rollback's 99, and
    a start_iteration, each through ``_replay`` (its staging on the CPU,
    the graph a re-run of the recorded work), equal the eager scores of
    their own trees; a model keeps at most MAX_GRAPHS ranges."""
    monkeypatch.setattr(tsp, "capture_graph", _Rerun)
    tpc.clear()
    rng = np.random.default_rng(37)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    bst = lgbt.Booster(model_str=random_model_text(
        X.astype(np.float64), 100, 7, 11), device="cpu")
    sm = bst._gbdt._stacked_model()
    K, chunk = sm.num_class, 512
    f32 = torch.float32
    ranges = [(0, 40), (0, 50), (0, 99), (10, 50), (0, 40)] + \
        [(0, n) for n in range(60, 70)]
    entries = set()
    for first, ntree in ranges:
        memo = sm._dispatch(first, ntree, chunk, False, True)
        entry = memo[0]
        entries.add(id(entry))
        if entry._staging is None:
            x_host = torch.zeros((chunk, X.shape[1]), dtype=f32)
            out_host = torch.zeros((chunk, K), dtype=f32)
            entry._staging = tsp._Staging(
                x_host=x_host, x_np=x_host.numpy(),
                x_dev=torch.zeros_like(x_host),
                out_dev=torch.zeros_like(out_host), out_host=out_host,
                out_np=out_host.numpy(), done=_Passed())
        got = sm._replay(memo, X, first, ntree)
        want = sm.predict(X, first, ntree)
        np.testing.assert_array_equal(got.T.astype(np.float64), want)
        assert len(memo[1]) <= tsp.MAX_GRAPHS
    # 40, 50 and 99 trees span the same count of 32-tree chunks as
    # some other range here: fewer entries than ranges
    assert len(entries) < len(set(ranges))
    tpc.clear()


class _Sized:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def test_the_registry_is_bounded_by_bytes(monkeypatch):
    """Entries carry their staging's bytes; a new entry evicts the ones
    used least recently until the bytes fit MAX_BYTES, and a hit moves
    an entry to the back of the queue."""
    monkeypatch.setattr(tpc, "MAX_BYTES", 100)
    tpc.clear()
    s0 = tpc.stats()
    for k in "abc":
        tpc.get((k,), lambda: _Sized(40))
    assert tpc.held_bytes() == 80          # "a" went to make room
    tpc.get(("b",), lambda: _Sized(40))    # a hit: "c" is now the oldest
    tpc.get(("d",), lambda: _Sized(60))
    s1 = tpc.stats()
    assert tpc.held_bytes() == 100 and s1["entries"] == 2
    assert (s1["evictions"] - s0["evictions"], s1["hits"] - s0["hits"]) \
        == (2, 1)
    assert tpc.get(("b",), lambda: _Sized(1)).nbytes == 40
    tpc.clear()
    assert tpc.held_bytes() == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 from rows has no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.parametrize("leaves,trees", [(15, 40), (255, 33)])
def test_from_rows_kernel_bit_equal_on_card(cuda, leaves, trees):
    """K4 from rows against its plain version and the two launches it
    replaces, on the card, at 1-byte and 2-byte codes and N = 1, 64 and
    5,000; and a serving call's graph replay against the eager launch."""
    rng = np.random.default_rng(leaves)
    X = rng.normal(size=(5000, 12)).astype(np.float32)
    X[::17, 4] = np.nan
    text = random_model_text(X.astype(np.float64), trees, leaves, 3)
    bst = lgbt.Booster(model_str=text)
    sm = bst._gbdt._stacked_model()
    fc = sm.forest
    fcd = fc.to(cuda)
    T = sm.num_trees
    for n in (1, 64, 5000):
        x = torch.from_numpy(X[:n]).to(cuda)
        codes = tsp.codes_from_x(x, *sm.edges)
        for leaf in (False, True):
            got = forest_ops.forest_predict_from_x(x, sm.edges, fc, 0, T,
                                                   leaf_mode=leaf)
            assert torch.equal(got, forest_ops.forest_predict(
                codes, fc, 0, T, leaf))
            assert torch.equal(got, forest_ops.forest_predict_plain(
                codes, fcd, 0, T, leaf))
    want = lgbt.Booster(model_str=text, device="cpu").predict(X[:64])
    for _ in range(3):          # eager and capture, then two replays
        np.testing.assert_array_equal(bst.predict(X[:64]), want)


def test_graph_replay_per_tree_range_on_card(cuda):
    """A booster trained on the card, scored at several num_iteration
    and start_iteration values and after a rollback (each a replayed
    serving graph after its first call): the scores of a CPU booster of
    the same model text, which walks the same trees eagerly."""
    rng = np.random.default_rng(41)
    X = rng.normal(size=(3000, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float64)
    bst = lgbt.train({"objective": "binary", "num_leaves": 7,
                      "verbose": -1}, lgbt.Dataset(X, label=y), 70)
    Xt = X[:64].astype(np.float32).astype(np.float64)
    cpu = lgbt.Booster(model_str=bst.model_to_string(), device="cpu")
    for kw in ({"num_iteration": 40}, {"num_iteration": 50},
               {"num_iteration": 40, "start_iteration": 10}, {}):
        want = cpu.predict(Xt, raw_score=True, **kw)
        for _ in range(2):          # eager and capture, then a replay
            np.testing.assert_array_equal(
                bst.predict(Xt, raw_score=True, **kw), want)
    bst.rollback_one_iter()
    want = cpu.predict(Xt, raw_score=True, num_iteration=69)
    for _ in range(2):
        np.testing.assert_array_equal(bst.predict(Xt, raw_score=True), want)
