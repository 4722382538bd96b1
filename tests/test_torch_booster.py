"""The port's scoring slice end to end: lightgbm_tpu_torch.Booster and
capi against the reference LightGBM's golden predictions and against the
JAX package on the same models, all with ``device="cpu"`` (the plain
PyTorch path; the CUDA kernel is held against it by chip_smoke.py).

Bars: the golden corpus at its existing atol 1e-5 (1e-6 for the
reverse-only tiers); raw scores against the JAX package at atol 1e-5,
rtol 1e-6 (JAX sums a tree chunk through a dot, the port tree by tree);
probabilities at atol 1e-6 (JAX's sigmoid runs in f32, the port's in
f64); model text byte for byte.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import lightgbm_tpu as jlgb
from lightgbm_tpu import capi as jcapi
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import capi as tcapi
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "golden2")
CASES = ["binary", "regl2", "regl1", "multic", "catbin",
         "dart", "goss", "contin", "rank", "wbin"]
REVERSE_ONLY = ["proxy", "pkd4"]


def _X(name):
    src = "proxy" if name in REVERSE_ONLY else name
    return np.fromfile(os.path.join(DATA, f"g2_{src}_X.bin"),
                       np.float64).reshape(600, 8)


def _path(name, ours=False):
    return os.path.join(DATA, f"g2_{name}_{'ours_' if ours else ''}"
                              "model.txt")


@pytest.mark.parametrize("name", CASES)
def test_forward_golden(name):
    ref = np.fromfile(os.path.join(DATA, f"g2_{name}_pred.bin"), np.float64)
    bst = tlgb.Booster(model_file=_path(name), device="cpu")
    np.testing.assert_allclose(bst.predict(_X(name)).reshape(-1), ref,
                               atol=1e-5)


@pytest.mark.parametrize("name", CASES + REVERSE_ONLY)
def test_reverse_golden(name):
    ref = np.fromfile(os.path.join(DATA, f"g2_{name}_ours_refpred.bin"),
                      np.float64)
    bst = tlgb.Booster(model_file=_path(name, ours=True), device="cpu")
    atol = 1e-6 if name in REVERSE_ONLY else 1e-5
    np.testing.assert_allclose(bst.predict(_X(name)).reshape(-1), ref,
                               atol=atol)


@pytest.mark.parametrize("name", ["binary", "multic", "catbin", "rank"])
def test_predictions_match_jax_booster(name):
    X = _X(name)
    jb = jlgb.Booster(model_file=_path(name))
    tb = tlgb.Booster(model_file=_path(name), device="cpu")
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), atol=1e-6)
    np.testing.assert_array_equal(tb.predict(X, pred_leaf=True),
                                  jb.predict(X, pred_leaf=True))
    for num_iteration in (0, 1, 3):
        np.testing.assert_allclose(
            tb.predict(X, num_iteration=num_iteration, raw_score=True),
            jb.predict(X, num_iteration=num_iteration, raw_score=True),
            atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_model_text_matches_jax(name, tmp_path):
    jb = jlgb.Booster(model_file=_path(name))
    tb = tlgb.Booster(model_file=_path(name), device="cpu")
    assert tb.model_to_string() == jb.model_to_string()
    for num_iteration, start_iteration in ((2, 0), (1, 3), (5, 99)):
        assert tb.model_to_string(num_iteration, start_iteration) == \
            jb.model_to_string(num_iteration, start_iteration)
    assert tb.num_trees() == jb.num_trees()
    tb.save_model(str(tmp_path / "m.txt"))
    again = tlgb.Booster(model_file=str(tmp_path / "m.txt"), device="cpu")
    np.testing.assert_array_equal(again.predict(_X(name)),
                                  tb.predict(_X(name)))


def test_capi_matches_jax_capi():
    X = _X("multic")
    with open(_path("multic")) as fh:
        text = fh.read()
    jh = jcapi.LGBM_BoosterLoadModelFromString(text)
    th = tcapi.LGBM_BoosterLoadModelFromString(text, device="cpu")
    fh = tcapi.LGBM_BoosterCreateFromModelfile(_path("multic"),
                                               device="cpu")
    assert tcapi.LGBM_BoosterGetNumClasses(th) == \
        jcapi.LGBM_BoosterGetNumClasses(jh) == 3
    for ptype in (tcapi.C_API_PREDICT_NORMAL, tcapi.C_API_PREDICT_RAW_SCORE,
                  tcapi.C_API_PREDICT_LEAF_INDEX):
        for num_iteration in (-1, 2):
            want = np.asarray(jcapi.LGBM_BoosterPredictForMat(
                jh, X, predict_type=ptype, num_iteration=num_iteration))
            for h in (th, fh):
                got = np.asarray(tcapi.LGBM_BoosterPredictForMat(
                    h, X, predict_type=ptype, num_iteration=num_iteration))
                assert got.shape == want.shape
                if ptype == tcapi.C_API_PREDICT_LEAF_INDEX:
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want, atol=1e-5,
                                               rtol=1e-6)
            assert tcapi.LGBM_BoosterCalcNumPredict(
                th, len(X), ptype, num_iteration) == \
                jcapi.LGBM_BoosterCalcNumPredict(jh, len(X), ptype,
                                                 num_iteration)
    flat = tcapi.LGBM_BoosterPredictForMat(
        th, X.T.reshape(-1), nrow=len(X), ncol=8, is_row_major=0)
    np.testing.assert_array_equal(flat, tcapi.LGBM_BoosterPredictForMat(
        th, X))
    assert tcapi.LGBM_BoosterSaveModelToString(th) == \
        jcapi.LGBM_BoosterSaveModelToString(jh)
    assert tcapi.LGBM_BoosterFree(th) == 0 and th.gbdt is None


def test_early_stop_and_average_output_match_jax():
    """pred_early_stop runs the float64 host walk in both packages;
    average_output divides by the iterations predicted."""
    X = _X("binary")
    jb = jlgb.Booster(model_file=_path("binary"))
    tb = tlgb.Booster(model_file=_path("binary"), device="cpu")
    kw = dict(pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=1.5)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True, **kw),
                                  jb.predict(X, raw_score=True, **kw))
    with open(_path("regl2")) as fh:
        text = fh.read().replace("feature_names=",
                                 "average_output\nfeature_names=", 1)
    for num_iteration in (-1, 4):
        np.testing.assert_allclose(
            tlgb.Booster(model_str=text, device="cpu").predict(
                X, num_iteration=num_iteration),
            jlgb.Booster(model_str=text).predict(
                X, num_iteration=num_iteration), atol=1e-6, rtol=1e-6)


def test_generated_model_scores_alike_in_both_packages():
    """The random model generator (lightgbm_tpu_torch.testing, which
    chip_smoke.py drives at full size) at a small size: its text
    loads in both packages, device binning (f32-exact rows) and host
    binning (float64 rows) both match the JAX package."""
    X, _ = chip_smoke.make_higgs_like(3000, seed=1)
    text = random_model_text(X, 6, 40, seed=2)
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, device="cpu")
    assert tb.model_to_string() == jb.model_to_string()
    X64 = X[:500].astype(np.float64) + 1e-9
    for rows in (X[:500], X64):
        np.testing.assert_allclose(tb.predict(rows, raw_score=True),
                                   jb.predict(rows, raw_score=True),
                                   atol=1e-5, rtol=1e-6)
    Xl = chip_smoke.make_lrb_rows(400)
    ltext = random_model_text(Xl, 4, 31, seed=3)
    np.testing.assert_allclose(
        tlgb.Booster(model_str=ltext, device="cpu").predict(Xl),
        jlgb.Booster(model_str=ltext).predict(Xl), atol=1e-6)


def test_unstackable_model_takes_the_host_walk():
    """A feature used both numerically and categorically cannot be
    stacked (as in the JAX package): the port logs, counts a fallback
    and scores with the float64 host walk."""
    with open(_path("catbin")) as fh:
        text = fh.read()
    tree = text.split("Tree=1\n")[1].split("\n\n")[0]
    feats = re.search(r"split_feature=(.*)", tree).group(1).split()
    dts = re.search(r"decision_type=(.*)", tree).group(1).split()
    cat_feat = next(f for f, d in zip(feats, dts) if int(d) & 1)
    num_tree = ("Tree=1\nnum_leaves=2\nnum_cat=0\n"
                f"split_feature={cat_feat}\nsplit_gain=1\nthreshold=0.5\n"
                "decision_type=2\nleft_child=-1\nright_child=-2\n"
                "leaf_value=0.1 -0.1\nleaf_count=1 1\ninternal_value=0\n"
                "internal_count=2\nshrinkage=1\n\n\n")
    head, rest = text.split("Tree=1\n", 1)
    mixed = head + num_tree + "Tree=1\n" + rest
    before = tsp.fallbacks.value
    tb = tlgb.Booster(model_str=mixed, device="cpu")
    jb = jlgb.Booster(model_str=mixed)
    X = _X("catbin")
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), atol=1e-12)
    assert tsp.fallbacks.value == before + 1


def test_pandas_input():
    pd = pytest.importorskip("pandas")
    X = _X("binary")
    df = pd.DataFrame(X, columns=[f"c{i}" for i in range(8)])
    tb = tlgb.Booster(model_file=_path("binary"), device="cpu")
    np.testing.assert_array_equal(tb.predict(df), tb.predict(X))


def test_default_device_is_cuda():
    """With no device argument the Booster predicts on the card; where
    there is none it raises instead of running on the CPU."""
    tb = tlgb.Booster(model_file=_path("binary"))
    if torch.cuda.is_available():
        from lightgbm_tpu_torch.ops import forest as forest_ops
        before = forest_ops.launches.value
        tb.predict(_X("binary"))
        assert forest_ops.launches.value > before
    else:
        with pytest.raises(tlgb.LightGBMError, match="CUDA"):
            tb.predict(_X("binary"))


def test_import_hygiene():
    """The port loads neither jax nor the JAX package, and its sources
    name neither."""
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.capi, "
            "lightgbm_tpu_torch.convert, lightgbm_tpu_torch.lrb, "
            "lightgbm_tpu_torch.obs.identity, "
            "lightgbm_tpu_torch.obs.registry, "
            "lightgbm_tpu_torch.obs.reqlog, lightgbm_tpu_torch.obs.trace, "
            "lightgbm_tpu_torch.analysis.lockorder, "
            "lightgbm_tpu_torch.ops.predict_cache, "
            "lightgbm_tpu_torch.utils.faults, "
            "lightgbm_tpu_torch.utils.retry, "
            "lightgbm_tpu_torch.utils.fileio, "
            "lightgbm_tpu_torch.serve, lightgbm_tpu_torch.serve.daemon, "
            "lightgbm_tpu_torch.obs.slo; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'lightgbm_tpu.')) "
            "or m == 'lightgbm_tpu']; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pkg = os.path.join(ROOT, "lightgbm_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert not re.search(r"^\s*(import jax|from jax)", src,
                                     re.M), f
                assert not re.search(
                    r"^\s*(import|from) lightgbm_tpu(\.|\s|$)", src,
                    re.M), f
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert not re.search(r"^\s*(import|from) (jax|lightgbm_tpu\b(?!_))",
                         smoke, re.M)
