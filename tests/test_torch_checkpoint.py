"""Port parity: resumable checkpoints (lightgbm_tpu_torch/utils/
checkpoint.py) against the JAX package's (lightgbm_tpu/utils/
checkpoint.py), on the CPU.

Bars: a run broken at iteration k and resumed from its bundle writes the
uninterrupted run's model text byte for byte (the parameters block but
its ``tpu_resume_from`` line included), and that text is the JAX
package's uninterrupted text for the same params: binary with bagging
and feature_fraction and DART through ``engine.train``, and early
stopping across the break through the CLI driver (``GBDT.train``, whose
early-stopping bookkeeping the bundle carries). A bundle the JAX package
wrote resumes in the port to the JAX package's uninterrupted text: the
two packages keep one bundle format, one config fingerprint (the same
Config fields and VOLATILE_KNOBS) and one mapper fingerprint. The
refusals mirror tests/test_faults.py's: one-line loader errors, config
and mapper mismatches, a missing sidecar (a directory skips to the
newest valid bundle), the volatile knobs, and a bundle written by more
than one process (the re-shard is ROADMAP item 19).
"""
import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.utils import checkpoint as jckpt
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.models.boosting import create_boosting
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.utils import checkpoint as ckpt
from lightgbm_tpu_torch.utils import faults

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

PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
          "min_data_in_leaf": 5, "num_iterations": 12,
          "bagging_freq": 3, "bagging_fraction": 0.7,
          "feature_fraction": 0.8, "verbose": -1}
DART = {**PARAMS, "boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.2,
        "bagging_freq": 0, "bagging_fraction": 1.0}


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.clear()


def make_binary(seed=0, n=400, f=6):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return X, y


def without_resume(text: str) -> str:
    """The model text minus its ``[tpu_resume_from: ...]`` line, the one
    line a resumed call's parameters add."""
    return "\n".join(ln for ln in text.split("\n")
                     if not ln.startswith("[tpu_resume_from:"))


def build_booster(params, seed=0):
    """A port GBDT on the CPU, ``init``-ed on make_binary's rows."""
    cfg = Config().set(dict(params))
    X, y = make_binary(seed)
    ds = BinnedDataset(cfg, "cpu").construct_from_matrix(
        X, Metadata(label=y))
    obj = create_objective(cfg.objective, cfg)
    obj.init(ds.metadata, ds.num_data)
    return create_boosting(cfg.boosting_type(), "cpu").init(cfg, ds, obj)


def port_train(params, rounds=12, **kw):
    X, y = make_binary()
    return lgt.train(params, lgt.Dataset(X, label=y), rounds,
                     device="cpu", **kw).model_to_string()


def jax_train(params, rounds=12):
    X, y = make_binary()
    return jlgb.train(params, jlgb.Dataset(X, label=y),
                      rounds).model_to_string()


@pytest.mark.parametrize("name,params,k", [
    ("bagging_feature_fraction", PARAMS, 6), ("dart", DART, 4)])
def test_engine_resume_byte_equal_port_and_jax(tmp_path, name, params, k):
    """engine.train broken at iteration k (its bundle there) and resumed
    with the same call: the uninterrupted port text, which is the JAX
    package's."""
    ck = dict(params, tpu_checkpoint_dir=str(tmp_path),
              tpu_checkpoint_freq=2, tpu_snapshot_keep=100)
    jtext = jax_train(ck)
    full = port_train(ck)            # its bundles replace the JAX run's
    assert full == jtext
    assert os.path.isfile(tmp_path / f"ckpt_iter_{k}.json")
    resumed = port_train(dict(ck, tpu_resume_from=str(
        tmp_path / f"ckpt_iter_{k}.json")))
    assert without_resume(resumed) == without_resume(full)


def _cli_run(pkg, params, resume_from=""):
    """The CLI driver (GBDT.train) of ``pkg`` with a valid set; returns
    the model text."""
    X, y = make_binary(0, n=600)
    Xv, yv = make_binary(5, n=300)
    kw = {"device": "cpu"} if pkg is lgt else {}
    train = pkg.Dataset(X, label=y)
    bst = pkg.Booster(params=dict(params), train_set=train, **kw)
    bst.add_valid(pkg.Dataset(Xv, label=yv, reference=train), "v")
    bst._gbdt.train(-1, "", resume_from=resume_from)
    return bst._gbdt.model_to_string()


def test_cli_early_stopping_across_the_break(tmp_path):
    """The CLI driver with early stopping: a bundle taken before the
    stop carries the best-score bookkeeping, and the resumed run stops
    where the uninterrupted one did, with the same model (the JAX
    package's)."""
    params = dict(PARAMS, num_iterations=80, early_stopping_round=3,
                  learning_rate=0.5, metric="binary_logloss",
                  tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=2,
                  tpu_snapshot_keep=100)
    full = _cli_run(lgt, params)
    assert full == _cli_run(jlgb, params)
    its = sorted(i for i, _ in ckpt.list_checkpoints(str(tmp_path)))
    best = full.count("Tree=")          # the kept trees: the best round
    # a bundle between the best round and the stop (best + 3): the
    # resumed run stops where the uninterrupted one did only if the
    # bundle carries the best round
    k = max(i for i in its if best < i < best + 3)
    bundle = json.loads((tmp_path / f"ckpt_iter_{k}.json").read_text())
    assert bundle["state"]["best_iter"][0][0] == best
    resumed = _cli_run(lgt, params, str(tmp_path / f"ckpt_iter_{k}.json"))
    assert resumed == full


def test_jax_bundle_resumes_in_the_port(tmp_path):
    """A bundle the JAX package wrote (its engine.train, bagging and
    feature_fraction) resumes in the port to the JAX package's
    uninterrupted text; the bundle's fingerprints are the port's."""
    ck = dict(PARAMS, tpu_checkpoint_dir=str(tmp_path),
              tpu_checkpoint_freq=4)
    jfull = jax_train(ck)
    bundle = ckpt.resolve_resume(str(tmp_path / "ckpt_iter_8.json"))
    g = build_booster(ck)
    assert bundle["config_hash"] == ckpt.config_fingerprint(g.config)
    assert bundle["mappers"]["hash"] == \
        ckpt.mapper_fingerprint(g.train_data.mappers)
    resumed = port_train(dict(ck, tpu_resume_from=str(
        tmp_path / "ckpt_iter_8.json")))
    assert without_resume(resumed) == without_resume(jfull)


def test_port_bundle_loads_in_jax(tmp_path):
    """The port's bundle passes the JAX package's reader: the same
    schema, version and keys."""
    g = build_booster(PARAMS)
    for _ in range(4):
        g.train_one_iter()
    path = ckpt.save_checkpoint(g, str(tmp_path))
    jb = jckpt.load_checkpoint(path)
    pb = ckpt.load_checkpoint(path)
    assert jb["iteration"] == pb["iteration"] == 4
    assert set(jb) == set(pb)
    with open(path) as fh:
        keys = set(json.load(fh))
    assert {"schema", "version", "iteration", "config_hash", "parameters",
            "geometry", "world", "state", "mappers", "scores_file",
            "model", "identity"} <= keys


def test_checkpoint_loader_one_line_refusals(tmp_path):
    p = tmp_path / "ckpt_iter_3.json"
    p.write_text('{"schema": "lightgbm-tpu/checkpoint", "version')
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        ckpt.load_checkpoint(str(p))
    p.write_text('{"schema": "something-else"}')
    with pytest.raises(ValueError, match="not a checkpoint bundle"):
        ckpt.load_checkpoint(str(p))
    p.write_text(json.dumps({"schema": ckpt.CHECKPOINT_SCHEMA,
                             "version": 999}))
    with pytest.raises(ValueError, match="version 999"):
        ckpt.load_checkpoint(str(p))
    p.write_text(json.dumps({"schema": ckpt.CHECKPOINT_SCHEMA,
                             "version": ckpt.CHECKPOINT_VERSION}))
    with pytest.raises(ValueError, match="missing 'iteration'"):
        ckpt.load_checkpoint(str(p))
    d = tmp_path / "empty"
    d.mkdir()
    with pytest.raises(ValueError, match="no ckpt_iter_"):
        ckpt.resolve_resume(str(d))


def test_checkpoint_config_mismatch_is_actionable(tmp_path):
    g = build_booster(PARAMS)
    for _ in range(4):
        g.train_one_iter()
    ckpt.save_checkpoint(g, str(tmp_path))
    other = build_booster(dict(PARAMS, learning_rate=0.3))
    bundle = ckpt.resolve_resume(str(tmp_path))
    with pytest.raises(ValueError, match="different training config"):
        ckpt.restore(other, bundle)


def test_checkpoint_missing_sidecar_refused_and_dir_skips(tmp_path):
    g = build_booster(PARAMS)
    for _ in range(6):
        g.train_one_iter()
    ckpt.save_checkpoint(g, str(tmp_path))          # iteration 6 (valid)
    newer = tmp_path / "ckpt_iter_9.json"
    bundle = json.loads((tmp_path / "ckpt_iter_6.json").read_text())
    bundle["iteration"] = 9
    bundle["scores_file"] = "ckpt_iter_9.scores.npz"
    newer.write_text(json.dumps(bundle))
    with pytest.raises(ValueError, match="sidecar"):
        ckpt.load_checkpoint(str(newer))
    assert ckpt.resolve_resume(str(tmp_path))["iteration"] == 6


def test_checkpoint_volatile_knobs_do_not_change_fingerprint():
    a = Config().set(dict(PARAMS))
    b = Config().set(dict(PARAMS, tpu_checkpoint_dir="/tmp/x",
                          tpu_run_report="/tmp/r.json",
                          tpu_profile_dir="/tmp/p", tpu_faults="x@1",
                          tpu_resume_from="/tmp/x", num_iterations=500))
    c = Config().set(dict(PARAMS, learning_rate=0.31))
    assert ckpt.config_fingerprint(a) == ckpt.config_fingerprint(b)
    assert ckpt.config_fingerprint(a) != ckpt.config_fingerprint(c)
    assert ckpt.VOLATILE_KNOBS == jckpt.VOLATILE_KNOBS
    from lightgbm_tpu.config import Config as JConfig
    for params in (PARAMS, DART):
        assert ckpt.config_fingerprint(Config().set(dict(params))) == \
            jckpt.config_fingerprint(JConfig().set(dict(params)))


def test_checkpoint_multiprocess_bundle_refused(tmp_path):
    """A bundle written by more than one process is refused with a
    message that names item 19, never resumed approximately."""
    g = build_booster(PARAMS)
    for _ in range(4):
        g.train_one_iter()
    path = ckpt.save_checkpoint(g, str(tmp_path))
    bundle = json.loads(open(path).read())
    assert bundle["world"]["processes"] == 1
    bundle["world"].update(processes=2, devices=2)
    open(path, "w").write(json.dumps(bundle))
    with pytest.raises(ValueError, match="2-process run.*item 19"):
        ckpt.restore(build_booster(PARAMS), ckpt.resolve_resume(path))


def test_checkpoint_score_shape_mismatch_refused(tmp_path):
    """Scores of other rows are refused; a wider buffer of the same real
    rows (the JAX package's bucket padding) is cut to them."""
    g = build_booster(PARAMS)
    for _ in range(4):
        g.train_one_iter()
    path = ckpt.save_checkpoint(g, str(tmp_path))
    with np.load(ckpt.scores_path(path)) as z:
        saved = z["scores"]
    wider = np.pad(saved, ((0, 0), (0, 64)), constant_values=7.0)
    with open(ckpt.scores_path(path), "wb") as fh:
        np.savez_compressed(fh, scores=wider)
    fresh = build_booster(PARAMS)
    assert ckpt.restore(fresh, ckpt.resolve_resume(path)) == 4
    np.testing.assert_array_equal(fresh.train_scores().numpy(), saved)
    fresh.train_one_iter()
    bundle = json.loads(open(path).read())
    bundle["world"]["n_real"] = 640
    open(path, "w").write(json.dumps(bundle))
    with pytest.raises(ValueError, match="score shape"):
        ckpt.restore(build_booster(PARAMS), ckpt.resolve_resume(path))


def test_checkpoint_mapper_mismatch_refused(tmp_path):
    g = build_booster(PARAMS)
    for _ in range(3):
        g.train_one_iter()
    ckpt.save_checkpoint(g, str(tmp_path))
    bundle = ckpt.resolve_resume(str(tmp_path))
    other = build_booster(PARAMS, seed=99)
    with pytest.raises(ValueError, match="different bin mappers"):
        ckpt.restore(other, bundle)
    # the bundle's mappers reconstruct the original binning exactly
    full = ckpt.mappers_from_bundle(bundle)
    assert len(full) == g.train_data.num_total_features
    X, y = make_binary()
    ds3 = BinnedDataset(Config().set(dict(PARAMS)), "cpu") \
        .construct_from_matrix(X, Metadata(label=y), mappers=full)
    assert ckpt.mapper_fingerprint(ds3.mappers) == \
        bundle["mappers"]["hash"]


def test_checkpoint_write_failure_warns_and_never_corrupts(tmp_path):
    """An injected ``checkpoint.write`` fault warns and counts; training
    goes on, and the newest complete bundle is the one before it."""
    from lightgbm_tpu_torch.obs import registry as obs
    fails0 = obs.counter("checkpoint/write_failures").value
    faults.configure("checkpoint.write@3")
    g = build_booster(dict(PARAMS, tpu_checkpoint_dir=str(tmp_path),
                           tpu_checkpoint_freq=2, tpu_ckpt_async=0))
    g.train(-1, "")
    assert obs.counter("checkpoint/write_failures").value - fails0 == 1
    its = sorted(i for i, _ in ckpt.list_checkpoints(str(tmp_path)))
    assert 6 not in its and its[-1] == 12
    assert ckpt.resolve_resume(str(tmp_path))["iteration"] == 12


def test_async_writer_commits_in_order_and_drains(tmp_path):
    g = build_booster(PARAMS)
    w = ckpt.new_writer(maxsize=8)
    try:
        for _ in range(3):
            g.train_one_iter()
            ckpt.save_checkpoint(g, str(tmp_path), keep=10, writer=w)
        assert w.drain(timeout=30)
        assert [i for i, _ in ckpt.list_checkpoints(str(tmp_path))] == \
            [3, 2, 1]
        assert w.failures == 0
    finally:
        w.close()


def test_booster_save_checkpoint_and_cli_resume(tmp_path):
    """``Booster.save_checkpoint`` writes a bundle the CLI driver's
    ``tpu_resume_from`` continues to the uninterrupted text."""
    X, y = make_binary()
    params = dict(PARAMS, tpu_ckpt_async=0)
    bst = lgt.Booster(params=params, train_set=lgt.Dataset(X, label=y),
                      device="cpu")
    for _ in range(5):
        bst.update()
    path = bst.save_checkpoint(str(tmp_path))
    assert path.endswith("ckpt_iter_5.json")
    full = build_booster(params)
    full.train(-1, "")
    again = build_booster(params)
    again.train(-1, "", resume_from=path)
    assert again.model_to_string() == full.model_to_string()
