"""The port's training-step registry (lightgbm_tpu_torch/ops/step_cache.py)
and the grower's static state (ops/wave_grower.py ``WaveState``) against
the JAX package on the CPU.

Bars: the bucket functions equal the JAX package's over a sweep of sizes
and policies; the model text with ``tpu_step_cache`` -1 (the trees grown
on the cached state, the rows padded to the bucket as uncounted columns)
equals the text with 0 byte for byte but for that parameter, and equals
the JAX package's, on the exact tier, the int8 tier, categorical
features and with a valid set's passenger rows; two boosters of one
geometry trained in turns give the texts each gives alone, and the
second looks up a hit; the cases the cache does not take (forced splits,
the sparse tier, EFB bundles, the feature learner, ``tpu_step_cache=0``)
lease no state. On a card the waves replay CUDA graphs; chip_smoke.py's
phase 28 holds those runs to the same bar.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

try:
    import lightgbm_tpu as lgb
    from conftest import TEST_PARAMS, make_binary
    from lightgbm_tpu.ops import step_cache as jsc
except ImportError:
    # a machine with a card and no JAX runs the card tests alone:
    # pytest --noconftest tests/test_torch_step_cache.py -k card
    jsc = None

import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops import step_cache as tsc
from lightgbm_tpu_torch.ops import wave_grower as twg

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

DATA = os.path.join(os.path.dirname(__file__), "data", "golden2")


@pytest.fixture(autouse=True)
def _default_policy():
    """Both modules' process defaults back to auto after each test."""
    yield
    if jsc is not None:
        jsc.configure(-1, -1)
    tsc.configure(-1, -1)


SIZES = [0, 1, 7, 255, 256, 257, 1000, 4096, 16383, 16384, 16385, 20000,
         65537, 1_000_000, 10_999_999, 11_000_000]


@pytest.mark.parametrize("policy", [-1, 0, 1, 100, 4096])
def test_bucket_functions_equal_jax(policy):
    for n in SIZES:
        for align in (1, 3, 8, 64):
            assert tsc.bucket_rows(n, align, policy) == \
                jsc.bucket_rows(n, align, policy), (n, align)
        assert tsc.bucket_entries(n, policy) == jsc.bucket_entries(n, policy)
        for floor in (1, 16, 256, 1024):
            assert tsc.pow2_bucket(n, floor) == jsc.pow2_bucket(n, floor)
        for D, kchunk in ((1, 1024), (4, 256), (8, 8192)):
            assert tsc.shard_align_unit(n, D, kchunk) == \
                jsc.shard_align_unit(n, D, kchunk)
    for b in (1, 2, 15, 16, 17, 63, 64, 200, 255, 256):
        assert tsc.bucket_bins(b, policy) == jsc.bucket_bins(b, policy)
    # the process default as the policy
    tsc.configure(-1, policy)
    jsc.configure(-1, policy)
    assert [tsc.bucket_rows(n) for n in SIZES] == \
        [jsc.bucket_rows(n) for n in SIZES]


def test_aux_signature_equals_jax():
    aux = {"obj": {"label": np.zeros(7, np.float32), "w": None},
           "renew": None, "q": np.zeros((3, 2), np.int32)}
    assert tsc.aux_signature(aux) == jsc.aux_signature(aux)
    assert tsc.aux_signature(None) == jsc.aux_signature(None)


def _body(text):
    """Model text but the step-cache parameter line."""
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("[tpu_step_cache:"))


def _text(pkg, X, y, params, rounds, valid=None, cats=None):
    """(model text, its GBDT) of ``rounds`` iterations in ``pkg``."""
    ds = pkg.Dataset(X, label=y, categorical_feature=cats or "auto")
    kw = {"device": "cpu"} if pkg is lgbt else {}
    if valid is not None:
        kw["valid_sets"] = [pkg.Dataset(valid[0], label=valid[1],
                                        reference=ds)]
    b = pkg.train(dict(TEST_PARAMS, **params), ds, rounds, **kw)
    return b.model_to_string(), b._gbdt


CASES = {
    "binary": dict(objective="binary", bagging_fraction=0.8,
                   bagging_freq=2, feature_fraction=0.8),
    "int8": dict(objective="binary", tpu_quantized_hist=True,
                 tpu_count_proxy=0),
    "proxy": dict(objective="binary", tpu_quantized_hist=True),
    # tests/test_torch_categorical.py's catbin set and parameters
    "categorical": {"objective": "binary", "learning_rate": 0.1,
                    "min_data_in_leaf": 10, "min_data_per_group": 5,
                    "min_data_in_bin": 3},
    "valid": dict(objective="binary"),
}


def _case_data(name):
    X, y = make_binary(n=1500, f=6, seed=41)
    cats = None
    if name == "categorical":
        X = np.fromfile(os.path.join(DATA, "g2_catbin_X.bin"),
                        np.float64).reshape(600, 8)
        y = np.fromfile(os.path.join(DATA, "g2_catbin_y.bin"), np.float32)
        cats = [0, 2]
    valid = make_binary(n=400, f=6, seed=43) if name == "valid" else None
    return X, y, valid, cats


@pytest.mark.parametrize("name", list(CASES))
def test_text_equal_with_the_cache_on_and_off(name):
    """The trees grown on the cached state (1,500 rows padded to 2,048
    uncounted columns; catbin's 600 to 1,024) equal the eager ones and,
    but on the count-proxy tier (whose trees can part from the JAX
    package's at a near tie: tests/test_torch_quant.py), the JAX
    package's: byte for byte, categorical split gains within 4 ulp as in
    tests/test_torch_categorical.py (compared there)."""
    X, y, valid, cats = _case_data(name)
    params = CASES[name]
    on, g = _text(lgbt, X, y, dict(params, tpu_step_cache=-1), 6, valid,
                  cats)
    off, g0 = _text(lgbt, X, y, dict(params, tpu_step_cache=0), 6, valid,
                    cats)
    pool = g._step_pool()
    assert pool is not None and g0._step_pool() is None
    state = pool.lease(g._step[1])
    try:
        assert isinstance(state, twg.WaveState)
        assert state.rows == tsc.bucket_rows(g._n_total) > g._n_total
    finally:
        pool.release(state)
    assert _body(on) == _body(off)
    if name == "proxy":
        return
    jtext, _ = _text(lgb, X, y, params, 6, valid, cats)

    def trees(text):
        text = text[:text.index("\nparameters:")]
        return [ln for ln in text.splitlines()
                if not (cats and ln.startswith("split_gain="))]
    assert trees(on) == trees(jtext)


def test_two_boosters_in_turns_give_their_own_texts():
    """Two boosters of one geometry alive at once, trained an iteration
    each in turn: each text equals the one it gives alone; the second
    booster's lookup is a hit, and each reloads its bins when it takes
    the state after the other."""
    params = dict(TEST_PARAMS, objective="binary", bagging_fraction=0.7,
                  bagging_freq=1)
    data = [make_binary(n=1500, f=6, seed=s) for s in (51, 52)]
    alone = [lgbt.train(params, lgbt.Dataset(X, label=y), 5,
                        device="cpu").model_to_string() for X, y in data]
    s0 = tsc.stats()
    bs = [lgbt.Booster(params, lgbt.Dataset(X, label=y), device="cpu")
          for X, y in data]
    for _ in range(5):
        for b in bs:
            b.update()
    s1 = tsc.stats()
    assert s1["hits"] - s0["hits"] == 2 and s1["misses"] == s0["misses"]
    assert [b.model_to_string() for b in bs] == alone


def test_a_later_booster_hits_and_the_record_says_so():
    """A fresh booster of the same geometry (the next LRB window) is a
    hit; the registry's stats carry the JAX package's keys."""
    params = dict(TEST_PARAMS, objective="binary")
    X, y = make_binary(n=1000, f=6, seed=61)
    lgbt.train(params, lgbt.Dataset(X, label=y), 2, device="cpu")
    s0 = tsc.stats()
    X2, y2 = make_binary(n=1000, f=6, seed=62)
    lgbt.train(params, lgbt.Dataset(X2, label=y2), 2, device="cpu")
    s1 = tsc.stats()
    assert s1["hits"] - s0["hits"] == 1 and s1["misses"] == s0["misses"]
    assert set(s1) == set(jsc.stats())
    assert s1["compile_s"] == 0.0    # no graph is captured on the CPU


def test_feature_counts_of_one_bucket_share_a_pool():
    """Two sets of 40 columns, one with 6 constant columns (34 features
    kept), the other with 40: F pads to 40 with trivial features in both
    geometries (the JAX package's pad), so the second booster's lookup is
    a hit on the first's pool, and each text equals its
    ``tpu_step_cache=0`` text but for that parameter."""
    params = dict(TEST_PARAMS, objective="binary", feature_fraction=0.8)
    r = np.random.default_rng(65)
    X1 = r.normal(size=(1000, 40))
    X1[:, [3, 9, 17, 22, 30, 38]] = 1.0
    y1 = (X1[:, 0] + X1[:, 1] > 0).astype(np.float32)
    X2 = r.normal(size=(1000, 40))
    y2 = (X2[:, 2] - X2[:, 5] > 0).astype(np.float32)
    tsc.clear()
    lookups, counts = [], []
    for X, y in ((X1, y1), (X2, y2)):
        s0 = tsc.stats()
        on = lgbt.train(dict(params, tpu_step_cache=-1),
                        lgbt.Dataset(X, label=y), 4, device="cpu")
        s1 = tsc.stats()
        off = lgbt.train(dict(params, tpu_step_cache=0),
                         lgbt.Dataset(X, label=y), 4, device="cpu")
        assert _body(on.model_to_string()) == _body(off.model_to_string())
        g = on._gbdt
        counts.append(g.train_data.num_features)
        pool = g._step_pool()
        state = pool.lease(g._step[1])
        try:
            assert state.features == 40
            assert tuple(state.meta.num_bin.shape) == (40,)
        finally:
            pool.release(state)
        lookups.append((s1["hits"] - s0["hits"],
                        s1["misses"] - s0["misses"]))
    assert counts == [34, 40]
    assert lookups == [(0, 1), (1, 0)]
    tsc.clear()


def test_the_registry_is_bounded_by_bytes(monkeypatch):
    """A state's bytes are its static tensors (the padded bins among
    them); once a booster releases its state, the registry evicts the
    pools used least recently until it holds MAX_BYTES at most, never
    the pool just released, and a booster that holds an evicted pool
    trains on as before."""
    params = dict(TEST_PARAMS, objective="binary")
    tsc.clear()
    X, y = make_binary(n=1000, f=6, seed=63)
    a = lgbt.train(dict(params, num_leaves=7), lgbt.Dataset(X, label=y), 2,
                   device="cpu")
    pool_a = a._gbdt._step_pool()
    held = tsc.held_bytes()
    # the bins, grad, hess, mask and leaf ids at the padded rows, and
    # the [L, F, B, 3] histogram pool, at least
    bins = a._gbdt._grower_bins()
    assert held == pool_a.nbytes() > bins.numel() * bins.element_size()
    monkeypatch.setattr(tsc, "MAX_BYTES", held)
    s0 = tsc.stats()
    b = lgbt.train(dict(params, num_leaves=5), lgbt.Dataset(X, label=y), 2,
                   device="cpu")
    s1 = tsc.stats()
    assert s1["evictions"] - s0["evictions"] == 1 and s1["entries"] == 1
    assert tsc.held_bytes() == b._gbdt._step_pool().nbytes()
    a.update()          # on its evicted pool
    alone = lgbt.train(dict(params, num_leaves=7), lgbt.Dataset(X, label=y),
                       3, device="cpu")
    assert a.model_to_string() == alone.model_to_string()
    tsc.clear()


@pytest.mark.parametrize("extra", [
    dict(tpu_step_cache=0), dict(tree_learner="feature"),
    dict(forcedsplits_filename="FORCED"), dict(enable_bundle=True),
    dict(tpu_sparse=1)], ids=["off", "feature", "forced", "efb", "sparse"])
def test_uncached_cases_lease_no_state(extra, tmp_path):
    """The JAX package's exclusions (off, feature/voting learners, EFB)
    and the port's own (forced splits, the sparse tier): no pool, and
    the trees are the eager route's."""
    X, y = make_binary(n=1200, f=6, seed=71)
    params = dict(TEST_PARAMS, objective="binary", **extra)
    if "forcedsplits_filename" in extra:
        path = tmp_path / "forced.json"
        path.write_text('{"feature": 0, "threshold": 0.0}')
        params["forcedsplits_filename"] = str(path)
    if extra.get("enable_bundle") or extra.get("tpu_sparse"):
        r = np.random.default_rng(72)
        onehot = np.eye(8)[r.integers(0, 8, size=X.shape[0])]
        X = sps.csr_matrix(np.hstack([X, onehot]))
    b = lgbt.train(params, lgbt.Dataset(X, label=y), 2, device="cpu")
    assert b._gbdt._step_pool() is None


HP = tsplit.SplitParams(min_data_in_leaf=20.0, min_data_per_group=100.0,
                        max_cat_threshold=32, lambda_l1=0.5, cat_l2=10.0,
                        max_delta_step=0.7, has_cat=True)


def _gains_input(P, M, F, seed, B=64):
    """The categorical tables' inputs as the split search makes them:
    the leaves' histograms, each (direction, leaf, feature) row's sorted
    g, h and counts of its used bins (zeros past them), the leaves'
    totals, the per-feature masks."""
    r = np.random.default_rng(seed)
    hist = np.zeros((M, F, B, 3), np.float32)
    hist[..., 0] = r.normal(size=(M, F, B))
    hist[..., 1] = r.uniform(0.01, 2.0, size=(M, F, B))
    hist[..., 2] = r.integers(0, 200, size=(M, F, B))
    used = r.integers(0, P + 1, (M, F, 1))
    srt = np.zeros((2, M, F, P, 3), np.float32)
    for d, m, f in np.ndindex(2, M, F):
        u = used[m, f, 0]
        srt[d, m, f, :u] = hist[m, f, r.permutation(B)[:u]]
    tot = hist[:, 0].sum(axis=1) + r.uniform(0, 50, (M, 3))
    leaf = [torch.from_numpy(tot[:, c].astype(np.float32))[:, None, None]
            for c in range(3)]
    shift = torch.full((M, 1, 1), -1e30)
    sorted_ok = torch.from_numpy(r.random((M, F, 1)) < 0.9)
    used_bin = torch.from_numpy(r.integers(1, B + 1, (1, F, 1)))
    onehot_ok = torch.from_numpy(r.random((M, F, 1)) < 0.9)
    return (torch.from_numpy(hist), torch.from_numpy(srt), leaf[0], leaf[1],
            leaf[2], shift, torch.from_numpy(used), sorted_ok, used_bin,
            onehot_ok)


def _leaf_gain64(g, h, l2):
    t = np.sign(g) * max(abs(g) - HP.lambda_l1, 0.0)
    out = np.clip(-t / (h + l2), -HP.max_delta_step, HP.max_delta_step)
    return -(2 * t * out + (h + l2) * out * out)


def test_categorical_gains_plain_against_float64():
    """On the CPU the tables are their plain version, which keeps the
    reference's candidates (min_data_per_group's chunking restarting at
    each emitted candidate, the right side's failure ending the scan,
    half the used bins at most; one-hot bins below the used bin with
    both sides over their floors) and their gains, checked against the
    same rules in float64."""
    args = _gains_input(32, 4, 3, 81)
    cum, gain, gain_o = tsplit.categorical_gains(*args, HP)
    assert tsplit.gains_launches.value == 0
    hist, srt, sg, sh, nd, _, used, ok, ub, ook = [a.numpy() for a in args]
    l2 = HP.lambda_l2 + HP.cat_l2
    for d, m, f in np.ndindex(2, 4, 3):
        x = srt[d, m, f].astype(np.float64)
        c = np.cumsum(x, axis=0)
        np.testing.assert_allclose(cum[d, m, f].numpy(), c, rtol=1e-5,
                                   atol=1e-4)
        cnt, right, u = 0.0, True, used[m, f, 0]
        for p in range(32):
            lg, lh, lc = c[p, 0], c[p, 1] + 1e-15, c[p, 2]
            rg, rh, rc = sg[m, 0, 0] - lg, sh[m, 0, 0] - lh, nd[m, 0, 0] - lc
            right = right and rc >= 20 and rc >= 100 and rh >= 1e-3
            cnt += x[p, 2]
            emit = lc >= 20 and lh >= 1e-3 and cnt >= 100
            cnt = 0.0 if emit else cnt
            want = (emit and right and p < u and p < min((u + 1) // 2, 32)
                    and ok[m, f, 0])
            got = gain[d, m, f, p].item()
            assert np.isfinite(got) == want, (d, m, f, p)
            if want:
                assert got == pytest.approx(
                    _leaf_gain64(lg, lh, l2) + _leaf_gain64(rg, rh, l2),
                    rel=1e-4)
    for m, f, b in np.ndindex(4, 3, 64):
        g, h, c = hist[m, f, b].astype(np.float64)
        lh, rg = h + 1e-15, sg[m, 0, 0] - g
        rh, rc = sh[m, 0, 0] - lh, nd[m, 0, 0] - c
        want = (b < ub[0, f, 0] and c >= 20 and h >= 1e-3 and rc >= 20
                and rh >= 1e-3 and ook[m, f, 0])
        got = gain_o[m, f, b].item()
        assert np.isfinite(got) == want, (m, f, b)
        if want:
            assert got == pytest.approx(_leaf_gain64(g, lh, HP.lambda_l2)
                                        + _leaf_gain64(rg, rh, HP.lambda_l2),
                                        rel=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the categorical kernel has no CPU "
                    "mode")
    return torch.device("cuda:0")


@pytest.mark.parametrize("P,B", [(1, 16), (5, 16), (16, 64), (32, 64),
                                 (200, 256), (256, 256)])
def test_categorical_gains_kernel_bit_equal_on_card(cuda, P, B):
    """csrc/categorical.cu against its plain version on the card: the
    prefix sums bit for bit in XLA's block order and the same k-vs-rest
    and one-hot gains, -inf where a position or bin is no candidate,
    under max_delta_step and without."""
    args = [a.to(cuda) for a in _gains_input(P, 24, 4, P, B)]
    for hp in (HP, HP._replace(max_delta_step=0.0, lambda_l1=0.0)):
        before = tsplit.gains_launches.value
        got = tsplit.categorical_gains(*args, hp)
        want = tsplit.categorical_gains_plain(*args, hp)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert tsplit.gains_launches.value == before + 1
