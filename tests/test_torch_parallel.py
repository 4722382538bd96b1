"""Port parity for the distributed learners (lightgbm_tpu_torch/parallel):
D gloo ranks on the CPU against the JAX package's learners on its
8-device virtual mesh (``tree_learner=<mode>, num_machines=D``), on the
same inputs and params.

One world of 2 ranks runs every D = 2 mode in sequence (the module's
``world2``), one of 4 ranks an uneven row count with bagging and a valid
set (``world4``); the texts and results are compared here. The bars:
- every run's model text is the same on every rank;
- feature learner: the text byte-equal to the JAX feature learner's and
  to the port's own serial text; on the int8 tier (exact counts, as the
  JAX package's feature learner takes) and over EFB bundles, to the
  port's serial text of the same tier (each rank histograms only its
  slice of the columns, in the whole matrix's order of addition);
- data learner, int8 with the int32 wire (``tpu_quantized_psum=1``):
  byte-equal to the port's serial int8 text (the global scales, the
  global row index in the rounding hash and the integer sums make the
  world size drop out), and to the JAX data learner's but for fault E's
  1-2 ulp split gains (compared within 4 ulp, as test_torch_quant.py);
- the narrow int16 wire (127 * N < 2^15: 250 rows) and the slots
  (``tpu_async_psum``): bit-identical to the int32 wire; the int8 wire
  (127 * N < 2^7, which no training set meets) as the collective alone
  on the ranks' group, every wire and slot count equal to the exact sum;
- data learner, f32: byte-equal to the JAX data learner's at D = 2 and
  D = 4 (with bagging): the port sums the ranks' f32 histograms as an
  all-gather added in rank order, which is the order XLA's CPU psum
  takes at these D; and the same text on every run. The JAX data
  learner shards a valid set's rows with the train rows, so its trees
  move with a valid set; the port's valid rows ride every rank whole, so
  its D = 4 text with a valid set is held to the JAX text without one,
  and its valid AUC to that model's on the valid rows (within 1e-6);
- voting learner: the elected features equal the JAX voting learner's
  at every search of the first two trees (root and waves, the active
  slots' children), and the text meets the f32 data bar against JAX's
  voting text: every line equal but split_gain, those within 1e-5
  relative (its final search runs over F with the unelected features
  masked, where the JAX package's vmaps over the 2k elected ones; XLA
  contracts the two differently), predictions within 1e-5;
- ``LGBM_NetworkInitWithFunctions``: a counting reducer sees every
  histogram site and leaves the text as it was, a replacing reducer
  changes it, ``LGBM_NetworkFree`` clears them;
- a two-rank data booster declines the step cache: a miss, no hit, and
  refuses a checkpoint (each rank holds only its rows' scores);
- the objectives, refit included, on a rank's rows: every path of
  ``OTHER`` byte-equal to serial, its refit trees too;
- a one-rank world trains the serial learner with the warning;
- distributed loading: every rank's mappers' ``feature_info`` strings
  are identical, and equal to the JAX ``DistributedLoader``'s with the
  same ``world=`` and ``rank=``.
"""
import os

import numpy as np
import pytest

from conftest import fit_gbdt

from lightgbm_tpu_torch.parallel import elastic

pytestmark = pytest.mark.torch_port

BASE = {"objective": "binary", "metric": "auc", "num_leaves": 15,
        "max_bin": 63, "min_data_in_leaf": 5, "tpu_quantized_hist": False}
ITERS = 6
TOP_K = 3
RANK_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
SETUP = "lightgbm_tpu_torch.testing:parallel_setup"
HOOK = "lightgbm_tpu_torch.testing:parallel_probe"


def _data(n, seed, valid=0):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n + valid, 10))
    X[:, 3] = np.round(X[:, 3] * 3)
    y = ((X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * r.normal(size=n + valid))
         > 0).astype(np.float32)
    return X[:n], y[:n], X[n:], y[n:]


def trees(text):
    return text.split("\nparameters:")[0]


def _gains_close(a, b, rel=None, ulps=4):
    """Texts equal line for line but split_gain (within ``ulps`` ulp, or
    ``rel`` relative) and tree_sizes (which count the gains' digits)."""
    la, lb = trees(a).splitlines(), trees(b).splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x == y or x.startswith("tree_sizes="):
            continue
        assert x.startswith("split_gain=") and y.startswith("split_gain=")
        ga = np.array(x.split("=")[1].split(), np.float32)
        gb = np.array(y.split("=")[1].split(), np.float32)
        if rel is not None:
            np.testing.assert_allclose(ga, gb, rtol=rel)
        else:
            assert np.all(np.abs(ga.view(np.int32).astype(np.int64)
                                 - gb.view(np.int32)) <= ulps)


# objectives and a sampler whose row-sharded paths differ from binary's:
# the L1 family's renewal and GOSS read the rows gathered to every rank,
# multiclass and one-vs-all ([K, N] per-row arrays) grow K trees an
# iteration from a view of the objective on the rank's rows
OTHER = {"l1": {"objective": "regression_l1", "metric": "l1"},
         "multiclass": {"objective": "multiclass", "num_class": 2,
                        "metric": "multi_logloss"},
         "multiclassova": {"objective": "multiclassova", "num_class": 2,
                           "metric": "multi_logloss"},
         "goss": {"boosting": "goss", "learning_rate": 0.5}}
EXACT_Q = {"tpu_quantized_hist": True, "tpu_count_proxy": 0}

RUNS2 = [
    {"name": "serial", "params": {"tree_learner": "serial"}},
    {"name": "data", "params": {"tree_learner": "data"},
     "checkpoint": True},
    {"name": "data_again", "params": {"tree_learner": "data"}},
    {"name": "feature", "params": {"tree_learner": "feature"}},
    {"name": "serial_qx", "params": {**EXACT_Q, "tree_learner": "serial"}},
    {"name": "feature_q", "params": {**EXACT_Q, "tree_learner": "feature"}},
    {"name": "efb_serial", "data": "efb",
     "params": {"tree_learner": "serial"}},
    {"name": "efb_feature", "data": "efb",
     "params": {"tree_learner": "feature"}},
    {"name": "voting", "params": {"tree_learner": "voting", "top_k": TOP_K,
                                  "num_iterations": 2}, "elections": 100},
    {"name": "serial_q", "params": {"tree_learner": "serial",
                                    "tpu_quantized_hist": True}},
    {"name": "data_q", "params": {"tree_learner": "data",
                                  "tpu_quantized_hist": True,
                                  "tpu_quantized_psum": 1}},
    {"name": "serial_q250", "rows": 250,
     "params": {"tree_learner": "serial", "tpu_quantized_hist": True}},
    {"name": "data_q250_int32", "rows": 250,
     "params": {"tree_learner": "data", "tpu_quantized_hist": True,
                "tpu_quantized_psum": 1, "tpu_psum_wire": 0,
                "tpu_async_psum": 0}},
    {"name": "data_q250_int16", "rows": 250, "wires": True,
     "params": {"tree_learner": "data", "tpu_quantized_hist": True,
                "tpu_quantized_psum": 1, "tpu_psum_wire": 1,
                "tpu_async_psum": 0}},
    {"name": "data_q250_int16_slots", "rows": 250,
     "params": {"tree_learner": "data", "tpu_quantized_hist": True,
                "tpu_quantized_psum": 1, "tpu_psum_wire": 1,
                "tpu_async_psum": 1}},
    {"name": "net_count", "params": {"tree_learner": "data"},
     "network": "count"},
    {"name": "net_replace", "params": {"tree_learner": "data"},
     "network": "replace"},
    {"name": "report", "driver": "train",
     "params": {"tree_learner": "data", "tpu_step_cache": 1}},
    {"name": "load", "kind": "load"},
] + [
    {"name": f"{tag}_{mode}", "refit": True, "params": {
        **extra, "tree_learner": mode, "tpu_quantized_hist": True,
        "tpu_quantized_psum": 1}}
    for tag, extra in OTHER.items() for mode in ("serial", "data")]


def _efb_data(n, seed):
    """Dense columns and four mutually exclusive sparse ones, which EFB
    bundles."""
    X, y, _, _ = _data(n, seed)
    r = np.random.default_rng(seed + 1)
    which = r.integers(0, 8, size=n)
    sparse = np.stack([np.where(which == j, r.normal(size=n) + 2, 0.0)
                       for j in range(4)], axis=1)
    y = ((X[:, 0] + sparse[:, 1] > 0.5) != (r.random(n) < 0.1)).astype(
        np.float32)
    return np.hstack([X[:, :6], sparse]), y


@pytest.fixture(scope="module")
def data2(tmp_path_factory):
    X, y, _, _ = _data(2000, 3)
    d = tmp_path_factory.mktemp("world2")
    np.savez(d / "d.npz", X=X, y=y)
    return X, y, d


@pytest.fixture(scope="module")
def world2(data2):
    X, y, d = data2
    Xe, ye = _efb_data(2000, 7)
    np.savez(d / "efb.npz", X=Xe, y=ye)
    runs = [dict(r) for r in RUNS2]
    for r in runs:
        if r["name"] == "report":
            r["params"] = dict(r["params"],
                               tpu_run_report=str(d / "report.json"))
        if r.get("data") == "efb":
            r["data"] = str(d / "efb.npz")
    out = elastic.run_world(str(d), {
        "data": str(d / "d.npz"), "device": "cpu",
        "params": {**BASE, "num_iterations": ITERS}, "runs": runs,
        "setup": SETUP, "hook": HOOK}, 2, env=RANK_ENV, timeout_s=400)
    assert out["codes"] == [0, 0], out["logs"]
    out["by_name"] = [{r["name"]: r for r in res["runs"]}
                      for res in out["results"]]
    return out


@pytest.fixture(scope="module")
def jax2(data2):
    """The JAX package's texts at D = 2 (and its serial text)."""
    X, y, _ = data2
    p = {k: v for k, v in BASE.items()}
    out = {}
    for name, extra in [
            ("serial", {}), ("data", {"tree_learner": "data"}),
            ("feature", {"tree_learner": "feature"}),
            ("data_q", {"tree_learner": "data", "tpu_quantized_hist": True,
                        "tpu_quantized_psum": 1})]:
        if extra:
            extra = dict(extra, num_machines=2)
        g = fit_gbdt(X, y, {**p, **extra}, num_round=ITERS)
        out[name] = g.model_to_string()
    return out


@pytest.mark.parametrize("name", [r["name"] for r in RUNS2
                                  if r.get("kind") != "load"
                                  and r.get("network") != "replace"])
def test_every_rank_trains_the_same_model(world2, name):
    texts = world2["texts"][name]
    assert texts[0] is not None and texts[0] == texts[1]
    ranks = world2["by_name"]
    assert ranks[0][name]["evals"] == ranks[1][name]["evals"]


def test_learner_modes_and_row_blocks(world2):
    r0, r1 = world2["by_name"]
    assert r0["serial"]["learner_mode"] == "serial"
    for mode in ("data", "feature", "voting"):
        assert r0[mode]["learner_mode"] == mode
        assert r0[mode]["num_devices"] == 2
    # data: contiguous blocks tiling the rows; feature: every row
    assert r0["data"]["row_block"] == [0, 1000]
    assert r1["data"]["row_block"] == [1000, 2000]
    assert r1["feature"]["row_block"] == [0, 2000]
    assert r0["data"]["comm_bytes_per_iter"] > 0
    assert r0["serial"]["comm_bytes_per_iter"] == 0


def test_feature_text_equals_serial_and_jax(world2, jax2):
    t = world2["texts"]
    assert trees(t["feature"][0]) == trees(t["serial"][0])
    assert trees(t["feature"][0]) == trees(jax2["feature"])
    assert trees(t["serial"][0]) == trees(jax2["serial"])


@pytest.mark.parametrize("tier", ["q", "efb"])
def test_feature_slices_equal_serial_on_other_tiers(world2, tier):
    """int8 with exact counts, and EFB bundles (each rank histograms its
    slice of the bundle columns): byte-equal to serial; the only
    collective is the best splits' gather."""
    t, r0 = world2["texts"], world2["by_name"][0]
    serial, feature = {"q": ("serial_qx", "feature_q"),
                       "efb": ("efb_serial", "efb_feature")}[tier]
    assert r0[feature]["learner_mode"] == "feature"
    assert r0[feature]["bundled"] == (tier == "efb")
    assert trees(t[feature][0]) == trees(t[serial][0])
    assert r0[feature]["collective_calls_per_iter"] > 0


def test_feature_slice_histogram_adds_in_the_whole_order(monkeypatch):
    """A slice of the features, given the whole width, adds every cell
    as the whole matrix's f32 pass does (its row ranges are the whole
    width's, which differ from the slice's own at this shape)."""
    import functools
    import torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    n, F, W, B = 20_000, 12, 15, 64
    assert hw.row_ranges(n, F, W, B) != hw.row_ranges(n, F // 2, W, B)
    monkeypatch.setattr(hw, "wave_histogram_plain", functools.partial(
        hw.wave_histogram_plain, kernel_order=True))
    r = np.random.default_rng(4)
    bins = torch.from_numpy(r.integers(0, B, size=(F, n)).astype(np.uint8))
    g = torch.from_numpy(r.normal(size=n).astype(np.float32))
    h = torch.from_numpy(r.random(n).astype(np.float32))
    ids = torch.from_numpy(r.integers(-1, W, size=n).astype(np.int32))
    wl = torch.arange(W, dtype=torch.int32)
    whole = hw.wave_histogram(bins, g, h, ids, wl, B)
    for lo, hi in ((0, F // 2), (F // 2, F)):
        part = hw.wave_histogram(bins[lo:hi], g, h, ids, wl, B,
                                 num_features=hi - lo, order_features=F)
        assert torch.equal(part, whole[:, lo:hi])


def test_data_int8_int32_wire_equals_serial_int8(world2, jax2):
    t = world2["texts"]
    assert world2["by_name"][0]["data_q"]["psum_wire"] == "int32"
    assert trees(t["data_q"][0]) == trees(t["serial_q"][0])
    _gains_close(t["data_q"][0], jax2["data_q"])


@pytest.mark.parametrize("tag", list(OTHER))
def test_data_int8_equals_serial_int8_for_other_paths(world2, tag):
    t = world2["texts"]
    assert world2["by_name"][0][f"{tag}_data"]["learner_mode"] == "data"
    assert trees(t[f"{tag}_data"][0]) == trees(t[f"{tag}_serial"][0])
    for r in world2["by_name"]:
        refit = r[f"{tag}_data"]["refit_trees"]
        assert refit == r[f"{tag}_serial"]["refit_trees"]
        assert refit != trees(t[f"{tag}_data"][0])


def test_narrow_wire_and_slots_equal_int32_wire(world2):
    t, r0 = world2["texts"], world2["by_name"][0]
    assert r0["data_q250_int32"]["psum_wire"] == "int32"
    assert r0["data_q250_int16"]["psum_wire"] == "int16"
    assert r0["data_q250_int16"]["psum_slots"] == 1
    assert r0["data_q250_int16_slots"]["psum_slots"] == 2
    ref = trees(t["data_q250_int32"][0])
    assert ref == trees(t["serial_q250"][0])
    assert trees(t["data_q250_int16"][0]) == ref
    assert trees(t["data_q250_int16_slots"][0]) == ref


def test_every_wire_sums_exactly_on_two_ranks(world2):
    """The int8 wire needs 127 N < 2^7, which no training set meets: the
    collective itself, on the two ranks' group, at every wire and slot
    count, against the exact sum (testing.py ``_wire_sums``)."""
    for r in world2["by_name"]:
        wires = r["data_q250_int16"]["wires"]
        assert len(wires) == 6 and all(wires.values()), wires
        # ops/autotune.py measure_psum_s times 1 and 2 slots on the group
        assert all(s > 0 for s in r["data_q250_int16"]["psum_s"])


def test_data_f32_equals_jax_and_repeats(world2, jax2):
    t = world2["texts"]
    assert trees(t["data"][0]) == trees(jax2["data"])
    assert t["data_again"][0] == t["data"][0]


def _jax_voting_elections(X, y, params, D, k2):
    """The JAX voting learner's elected features [M, 2k] of each search
    on device 0, recorded by a debug callback at its election's
    ``top_k`` (the only 2-D ``top_k`` of width 2k in its program)."""
    import jax
    rec = []
    orig = jax.lax.top_k

    def top_k(x, k):
        vals, idx = orig(x, k)
        if x.ndim == 2 and k == k2:
            jax.debug.callback(
                lambda i, d: rec.append(np.asarray(i)) if int(d) == 0
                else None, idx, jax.lax.axis_index("workers"))
        return vals, idx

    jax.lax.top_k = top_k
    try:
        g = fit_gbdt(X, y, params, num_round=2)
    finally:
        jax.lax.top_k = orig
    return g, rec


def test_voting_elections_and_text_meet_jax(world2, data2):
    X, y, _ = data2
    r0 = world2["by_name"][0]["voting"]
    F = X.shape[1]
    k2 = min(2 * TOP_K, F)
    g, jrec = _jax_voting_elections(
        X, y, {**BASE, "tree_learner": "voting", "num_machines": 2,
               "top_k": TOP_K}, 2, k2)
    ported = [np.asarray(e) for e in r0["elected"]]
    assert len(ported) == len(jrec) and len(ported) >= 4
    W = min(int(g._grower_cfg.wave_size), BASE["num_leaves"] - 1)
    for p, j in zip(ported, jrec):
        if p.shape[0] == 1:              # the root's search
            np.testing.assert_array_equal(p, j[:1])
            continue
        k = p.shape[0] // 2              # the wave's active slots
        np.testing.assert_array_equal(p[:k], j[:k])
        np.testing.assert_array_equal(p[k:], j[W:W + k])
    # the text: the f32 data bar against the JAX voting learner's
    text = world2["texts"]["voting"][0]
    _gains_close(text, g.model_to_string(), rel=1e-5)
    import lightgbm_tpu_torch as lgt
    pt = lgt.Booster(model_str=text, device="cpu").predict(X[:300],
                                                           raw_score=True)
    np.testing.assert_allclose(pt, g.predict_raw(X[:300]).reshape(-1),
                               atol=1e-5)


def test_network_functions_count_replace_and_free(world2):
    t, ranks = world2["texts"], world2["by_name"]
    for r in ranks:
        calls = r["net_count"]["network_calls"]
        # every histogram site and scalar sum: several per wave
        assert calls["reduce_scatter"] >= 3 * ITERS
        assert r["net_count"]["overrides_cleared"]
        assert r["net_replace"]["overrides_cleared"]
    assert t["net_count"][0] == t["data"][0]
    assert trees(t["net_replace"][0]) != trees(t["data"][0])


def test_step_cache_declined_on_two_ranks(world2):
    for r in world2["by_name"]:
        res = r["report"]
        assert not res["step_pool"]
        assert res["step_cache"]["hits"] == 0
        assert res["step_cache"]["misses"] >= 1


def test_checkpoint_refused_on_two_data_ranks(world2):
    for r in world2["by_name"]:
        assert r["data"]["checkpoint_refused"]


def test_run_report_carries_world_and_comm(world2, data2):
    import json
    d = data2[2]
    for rank in (0, 1):
        with open(os.path.join(d, f"report.r{rank}.json")) as fh:
            rep = json.load(fh)
        assert rep["meta"]["mesh_devices"] == 2
        assert rep["meta"]["tree_learner"] == "data"
        its = rep["iterations"]
        assert len(its) == ITERS
        assert all(it["comm_bytes"] > 0 for it in its)


def test_distributed_loading_agrees_with_jax(world2, data2):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Metadata as JMeta
    from lightgbm_tpu.io.distributed import DistributedLoader as JLoader
    X, y, _ = data2
    infos = [r["load"]["feature_info"] for r in world2["by_name"]]
    assert infos[0] == infos[1]
    cfg = JConfig().set(dict(BASE, tree_learner="data", num_iterations=ITERS))
    for rank in (0, 1):
        ds = JLoader(cfg, world=2, rank=rank).load_rank_matrix(
            X, JMeta(label=y))
        assert [m.feature_info() for m in ds.mappers] == infos[rank]
        assert ds.num_data == world2["by_name"][rank]["load"]["num_data"]


# -- four ranks: an uneven row count, bagging and a valid set ---------------

RUNS4 = [
    {"name": "serial", "params": {"tree_learner": "serial"}},
    {"name": "data", "params": {"tree_learner": "data"}},
    {"name": "serial_q", "params": {"tree_learner": "serial",
                                    "tpu_quantized_hist": True}},
    {"name": "data_q", "params": {"tree_learner": "data",
                                  "tpu_quantized_hist": True,
                                  "tpu_quantized_psum": 1}},
    {"name": "feature", "params": {"tree_learner": "feature"}},
]
BAG = {"bagging_fraction": 0.8, "bagging_freq": 2}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    X, y, Xv, yv = _data(2003, 11, valid=400)
    d = tmp_path_factory.mktemp("world4")
    np.savez(d / "d.npz", X=X, y=y, Xv=Xv, yv=yv)
    out = elastic.run_world(str(d), {
        "data": str(d / "d.npz"), "device": "cpu",
        "params": {**BASE, **BAG, "num_iterations": ITERS},
        "runs": RUNS4}, 4, env=RANK_ENV, timeout_s=400)
    assert out["codes"] == [0] * 4, out["logs"]
    return out, (X, y, Xv, yv)


def test_four_ranks_uneven_rows_bagging_valid(world4):
    out, (X, y, Xv, yv) = world4
    t = out["texts"]
    for name in t:
        assert all(x == t[name][0] for x in t[name]), name
    blocks = [r["runs"][1]["row_block"] for r in out["results"]]
    assert blocks == [[0, 501], [501, 1002], [1002, 1503], [1503, 2003]]
    evals = [r["runs"][1]["evals"] for r in out["results"]]
    assert all(e == evals[0] for e in evals)
    assert trees(t["data_q"][0]) == trees(t["serial_q"][0])
    assert trees(t["feature"][0]) == trees(t["serial"][0])
    # the JAX data learner shards its valid rows with the train rows, so
    # its trees move with a valid set; the port's valid rows ride every
    # rank whole and never move them: its text is held to the JAX text
    # trained without the valid set, its valid AUC to that model's
    g = fit_gbdt(X, y, {**BASE, **BAG, "tree_learner": "data",
                        "num_machines": 4}, num_round=ITERS)
    assert trees(t["data"][0]) == trees(g.model_to_string())
    from chip_smoke import auc_np
    jv = auc_np(yv, g.predict_raw(Xv).reshape(-1))
    assert evals[0]["valid_1/auc"] == pytest.approx(jv, abs=1e-6)


# -- in one process ------------------------------------------------------------


def test_one_rank_world_trains_serial_with_the_warning(capsys):
    import lightgbm_tpu_torch as lgt
    X, y, _, _ = _data(600, 5)
    params = {**BASE, "num_iterations": 3}
    a = lgt.train(dict(params, tree_learner="data"), lgt.Dataset(X, label=y),
                  device="cpu")
    assert "needs several devices" in capsys.readouterr().err
    b = lgt.train(params, lgt.Dataset(X, label=y), device="cpu")
    assert a._gbdt.learner_mode == "serial" and a._gbdt.num_devices == 1
    assert trees(a.model_to_string()) == trees(b.model_to_string())


def _fake_two_ranks():
    """The sum of two identical ranks in one process: a doubling."""
    from lightgbm_tpu_torch.parallel import learners
    learners.set_network_functions(
        reduce_scatter_fn=lambda x, default: x + x)


def test_hist_reduce_wires_and_slots_bit_identical():
    import torch
    from lightgbm_tpu_torch.ops.wave_grower import WaveGrowerConfig
    from lightgbm_tpu_torch.parallel import learners
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.integers(-60, 60, size=(4, 7, 16, 3)).astype(
        np.int32))
    _fake_two_ranks()
    try:
        outs = {}
        for wire in ("int8", "int16", "int32"):
            for slots in (1, 2, 3):
                cfg = WaveGrowerConfig(15, 16, quant_psum=True,
                                       psum_wire=wire, psum_slots=slots)
                y = learners.make_hist_reduce(cfg)(x)
                assert y.dtype == torch.int32
                outs[wire, slots] = y
        for y in outs.values():
            assert torch.equal(y, 2 * x)
    finally:
        learners.set_network_functions()


def test_sync_best_splits_ties_to_the_lowest_rank():
    import torch
    from lightgbm_tpu_torch.ops.split import SplitResult
    from lightgbm_tpu_torch.parallel import learners
    M = 3

    def res(feature):
        z = torch.zeros(M)
        return SplitResult(
            gain=torch.tensor([1.0, 2.0, float("-inf")]),
            feature=torch.full((M,), feature, dtype=torch.int32),
            threshold_bin=torch.zeros(M, dtype=torch.int32),
            default_left=torch.zeros(M, dtype=torch.bool),
            left_output=z, right_output=z, left_count=z, right_count=z,
            left_sum_g=z, left_sum_h=z, right_sum_g=z, right_sum_h=z,
            is_cat=torch.zeros(M, dtype=torch.bool),
            cat_words=torch.zeros((M, 8), dtype=torch.int32))

    def gather(r, default):
        other = res(7)
        return SplitResult(*[torch.stack([a, b]) for a, b in zip(r, other)])
    learners.set_network_functions(allgather_fn=gather)
    try:
        out = learners.sync_best_splits(res(4))
    finally:
        learners.set_network_functions()
    # equal gains on both ranks: rank 0's feature wins, as jnp.argmax
    assert out.feature.tolist() == [4, 4, 4]
