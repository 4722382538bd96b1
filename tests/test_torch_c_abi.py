"""The port's linkable C ABI (lightgbm_tpu_torch/csrc/c_api_embed.cpp
over lightgbm_tpu_torch/c_embed.py) against the JAX package's
(native/c_api_embed.cpp over lightgbm_tpu/c_embed.py) on the CPU.

Bars: tests/test_c_abi.py's fork driver (reference src/test.cpp:243-298:
DatasetCreateFromCSR -> SetField -> BoosterCreate -> UpdateOneIter ->
PredictForCSR -> SaveModel -> CreateFromModelfile -> Merge), linked
against each library with ``LGBM_TPU_PLATFORM=cpu``, writes byte-equal
model files and predictions within 1e-6 (the driver's own round-trip
bar: the JAX package converts raw scores to probabilities in f32, the
port in float64, an f32 ulp apart); the JAX library's model file loads
through the port's ``LGBM_BoosterCreateFromModelfile`` and predicts the
port's own predictions bit for bit; the glue driven with raw pointers
(Mat, file, refit, eval) and the plain-C ``...C`` exports through ctypes
agree with the port's ``capi``;
freeing a handle frees its booster and set; an unset
``LGBM_TPU_PLATFORM`` without a card fails the first call with the
port's LightGBMError through ``LGBM_GetLastError``, and trains nothing
on the CPU.
"""
import gc
import os
import shutil
import site
import subprocess
import sys
import sysconfig
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import c_embed as ce
from lightgbm_tpu_torch import capi
from lightgbm_tpu_torch.utils import cuda_build
from lightgbm_tpu_torch.utils.log import LightGBMError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_c_abi import DRIVER  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

pytestmark = [pytest.mark.torch_port,
              pytest.mark.skipif(shutil.which("g++") is None,
                                 reason="needs g++")]

# the fork driver, also writing its predictions (17 digits) beside the
# model file
PRED_DRIVER = DRIVER.replace(
    '  printf("C-ABI-OK',
    '  FILE* pf = fopen((std::string(argv[1]) + "/preds.txt").c_str(), '
    '"w");\n'
    '  for (int i = 0; i < n; i++) fprintf(pf, "%.17g\\n", preds[i]);\n'
    '  fclose(pf);\n'
    '  printf("C-ABI-OK')
assert PRED_DRIVER != DRIVER

# loads argv[1] and predicts the fork driver's rows into argv[2]
LOAD_DRIVER = DRIVER[:DRIVER.index("int main(")] + r"""
int main(int argc, char** argv) {
  const int n = 600, f = 4;
  std::vector<int32_t> indptr(n + 1);
  std::vector<int32_t> indices;
  std::vector<double> data;
  unsigned s = 12345;
  for (int i = 0; i < n; i++) {
    indptr[i] = (int32_t)indices.size();
    for (int j = 0; j < f; j++) {
      s = s * 1103515245u + 12345u;
      indices.push_back(j);
      data.push_back(((s >> 8) % 2000) / 1000.0 - 1.0);
    }
  }
  indptr[n] = (int32_t)indices.size();
  std::unordered_map<std::string, std::string> params;
  int iters = 0;
  BoosterHandle bst = nullptr;
  CHECK(LGBM_BoosterCreateFromModelfile(argv[1], &iters, &bst));
  int64_t len = 0;
  CHECK(LGBM_BoosterCalcNumPredict(bst, n, 0, -1, &len));
  std::vector<double> preds(len);
  CHECK(LGBM_BoosterPredictForCSR(bst, indptr.data(), 2, indices.data(),
                                  data.data(), 1, n + 1,
                                  (int64_t)data.size(), f, 0, -1,
                                  params, &len, preds.data()));
  FILE* pf = fopen(argv[2], "w");
  for (int i = 0; i < n; i++) fprintf(pf, "%.17g\n", preds[i]);
  fclose(pf);
  CHECK(LGBM_BoosterFree(bst));
  printf("LOAD-OK iters=%d\n", iters);
  return 0;
}
"""


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{"port": dir of liblightgbm_tpu_torch.so, "jax": dir of
    liblightgbm_tpu.so}: the port's built by utils/cuda_build.py, the
    JAX package's as tests/test_c_abi.py builds it."""
    port = Path(cuda_build.capi_library())
    assert port.name == "liblightgbm_tpu_torch.so"
    jdir = tmp_path_factory.mktemp("jax_cabi")
    libdir = sysconfig.get_config_var("LIBDIR")
    pyver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    r = subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++14",
         str(REPO / "native" / "c_api_embed.cpp"), "-o",
         str(jdir / "liblightgbm_tpu.so"),
         f"-I{sysconfig.get_path('include')}", f"-L{libdir}", f"-l{pyver}",
         "-ldl", "-lm", f"-Wl,-rpath,{libdir}"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return {"port": (port.parent, "lightgbm_tpu_torch"),
            "jax": (jdir, "lightgbm_tpu")}


def _link(src, lib, out):
    d, name = lib
    cpp = out.with_suffix(".cpp")
    cpp.write_text(src)
    r = subprocess.run(["g++", "-O1", "-std=c++14", str(cpp), "-o",
                        str(out), f"-L{d}", f"-l{name}",
                        f"-Wl,-rpath,{d}"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return out


def _env(platform="cpu"):
    env = {"PYTHONPATH": ":".join([str(REPO)] + site.getsitepackages()),
           "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "HOME": os.environ.get("HOME", "/tmp"),
           "CUDA_VISIBLE_DEVICES": ""}
    if platform is not None:
        env["LGBM_TPU_PLATFORM"] = platform
    return env


def _run(exe, *args, platform="cpu"):
    return subprocess.run([str(exe), *map(str, args)], env=_env(platform),
                          capture_output=True, text=True, timeout=560)


@pytest.fixture(scope="module")
def driven(libs, tmp_path_factory):
    """Each library's fork-driver run: {pkg: output directory}."""
    out = {}
    for pkg, lib in libs.items():
        d = tmp_path_factory.mktemp(f"drv_{pkg}")
        exe = _link(PRED_DRIVER, lib, d / "driver")
        r = _run(exe, d)
        assert "C-ABI-OK" in r.stdout, (pkg, r.stdout, r.stderr)
        out[pkg] = d
    return out


def test_fork_driver_model_and_predictions_equal_jax(driven):
    port, jax = driven["port"], driven["jax"]
    assert (port / "model.txt").read_bytes() == \
        (jax / "model.txt").read_bytes()
    preds = np.loadtxt(port / "preds.txt")
    np.testing.assert_allclose(preds, np.loadtxt(jax / "preds.txt"),
                               rtol=0, atol=1e-6)
    assert preds.shape == (600,) and ((preds > 0) & (preds < 1)).all()


def test_jax_model_file_loads_through_the_port(libs, driven, tmp_path):
    exe = _link(LOAD_DRIVER, libs["port"], tmp_path / "load")
    r = _run(exe, driven["jax"] / "model.txt", tmp_path / "p.txt")
    assert "LOAD-OK iters=8" in r.stdout, (r.stdout, r.stderr)
    assert (tmp_path / "p.txt").read_text() == \
        (driven["port"] / "preds.txt").read_text()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "p.txt"),
                               np.loadtxt(driven["jax"] / "preds.txt"),
                               rtol=0, atol=1e-6)


def test_unset_platform_without_a_card_raises(libs, tmp_path):
    """No ``LGBM_TPU_PLATFORM`` means cuda:0: without a card the first
    call fails with the port's error and nothing trains."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda:0 is a valid device here")
    exe = _link(PRED_DRIVER, libs["port"], tmp_path / "driver")
    r = _run(exe, tmp_path, platform=None)
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert r.stdout.startswith("FAIL LGBM_DatasetCreateFromCSR"), r.stdout
    assert "no CUDA device is available" in r.stdout
    assert not (tmp_path / "model.txt").exists()
    r = _run(exe, tmp_path, platform="tpu")
    assert "LGBM_TPU_PLATFORM='tpu'" in r.stdout, r.stdout


def test_platform_names(monkeypatch):
    monkeypatch.setenv(ce.PLATFORM_ENV, "cpu")
    assert ce.device() == torch.device("cpu")
    monkeypatch.setenv(ce.PLATFORM_ENV, "bogus")
    with pytest.raises(LightGBMError, match="bogus"):
        ce.device()
    if not torch.cuda.is_available():
        for name in ("", "gpu", "CUDA"):
            monkeypatch.setenv(ce.PLATFORM_ENV, name)
            with pytest.raises(LightGBMError, match="no CUDA device"):
                ce.device()


def _mk(n=300, f=4):
    r = np.random.default_rng(3)
    X = np.ascontiguousarray(r.normal(size=(n, f)))
    y = (X[:, 0] > 0).astype(np.float32)
    return X, np.ascontiguousarray(y)


PARAMS = "objective=binary num_leaves=7 metric=auc " \
         "is_provide_training_metric=true"


def test_glue_mat_train_eval_refit_save(monkeypatch, tmp_path):
    """tests/test_c_abi.py's ``TestEmbedGlue`` flow through the port's
    glue, against the same calls on the port's ``capi``; freeing the
    handles frees the booster and the set."""
    monkeypatch.setenv(ce.PLATFORM_ENV, "cpu")
    X, y = _mk()
    n, f = X.shape
    ds = ce.dataset_from_mat(X.ctypes.data, 1, n, f, 1, PARAMS, 0)
    ce.dataset_set_field(ds, "label", y.ctypes.data, n, 0)
    assert ce.dataset_num_data(ds) == n
    assert ce.dataset_num_feature(ds) == f
    bst = ce.booster_create(ds, PARAMS)
    fin = np.zeros(1, np.int32)
    for _ in range(6):
        ce.booster_update(bst, fin.ctypes.data)
    # the same calls on the port's capi
    rds = capi.LGBM_DatasetCreateFromMat(X, parameters=PARAMS,
                                         device="cpu")
    capi.LGBM_DatasetSetField(rds, "label", y)
    ref = capi.LGBM_BoosterCreate(rds, PARAMS)
    for _ in range(6):
        capi.LGBM_BoosterUpdateOneIter(ref)
    assert capi.LGBM_BoosterSaveModelToString(ce._get(bst)) == \
        capi.LGBM_BoosterSaveModelToString(ref)
    evals = np.zeros(4, np.float64)
    ne = ce.booster_get_eval(bst, 0, evals.ctypes.data)
    assert ne == 1 and evals[0] == capi.LGBM_BoosterGetEval(ref, 0)[0][1]
    ln2 = ce.booster_calc_num_predict(bst, n, 2, -1)
    leaves = np.zeros(ln2, np.float64)
    ce.booster_predict_mat(bst, X.ctypes.data, 1, n, f, 1, 2, -1, "",
                           leaves.ctypes.data)
    lp = np.ascontiguousarray(leaves.reshape(n, -1).astype(np.int32))
    ce.booster_refit(bst, lp.ctypes.data, n, lp.shape[1])
    capi.LGBM_BoosterRefit(ref, lp)
    ln = ce.booster_calc_num_predict(bst, n, 0, -1)
    out = np.zeros(ln, np.float64)
    assert ce.booster_predict_mat(bst, X.ctypes.data, 1, n, f, 1, 0, -1,
                                  "", out.ctypes.data) == n
    np.testing.assert_array_equal(
        out, np.asarray(capi.LGBM_BoosterPredictForMat(ref, X)).ravel())
    assert ((out > 0.5) == y).mean() > 0.85
    mf = str(tmp_path / "m.txt")
    ce.booster_save_model(bst, 0, -1, mf)
    iters = np.zeros(1, np.int32)
    b2 = ce.booster_from_modelfile(mf, iters.ctypes.data)
    assert iters[0] == 6
    out2 = np.zeros(ln, np.float64)
    ce.booster_predict_mat(b2, X.ctypes.data, 1, n, f, 1, 0, -1, "",
                           out2.ctypes.data)
    np.testing.assert_array_equal(out, out2)
    ce.booster_merge(bst, b2)
    handles = [ce._get(h) for h in (bst, b2, ds)]
    gone = weakref.ref(handles[0].gbdt)
    for h in (bst, b2, ds):
        ce.free_handle(h)
    gc.collect()
    assert gone() is None
    assert handles[0].gbdt is None and handles[2]._inner is None
    assert not any(h in ce._registry for h in (bst, b2, ds))


def test_glue_dataset_from_file(monkeypatch, tmp_path):
    monkeypatch.setenv(ce.PLATFORM_ENV, "cpu")
    X, y = _mk(200)
    fpath = tmp_path / "d.csv"
    np.savetxt(fpath, np.column_stack([y, X]), delimiter=",")
    ds = ce.dataset_from_file(str(fpath), "objective=binary", 0)
    assert ce.dataset_num_data(ds) == 200
    ce.free_handle(ds)


C_VARIANTS = r"""
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
r = np.random.default_rng(3)
X = np.ascontiguousarray(r.normal(size=(300, 4)))
y = np.ascontiguousarray((X[:, 0] > 0).astype(np.float32))
P = b"objective=binary num_leaves=7 verbose=-1"
ds, bst = ctypes.c_void_p(), ctypes.c_void_p()
ok = lib.LGBM_DatasetCreateFromMatC(
    ctypes.c_void_p(X.ctypes.data), 1, 300, 4, 1, P, None,
    ctypes.byref(ds))
assert ok == 0, lib.LGBM_GetLastError
lib.LGBM_DatasetSetField.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
assert lib.LGBM_DatasetSetField(ds, b"label", y.ctypes.data, 300, 0) == 0
assert lib.LGBM_BoosterCreateC(ds, P, ctypes.byref(bst)) == 0
fin = ctypes.c_int()
for _ in range(5):
    assert lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)) == 0
out = np.zeros(300, np.float64)
n = ctypes.c_int64()
assert lib.LGBM_BoosterPredictForMatC(
    bst, ctypes.c_void_p(X.ctypes.data), 1, 300, 4, 1, 0, -1, b"",
    ctypes.byref(n), ctypes.c_void_p(out.ctypes.data)) == 0
indptr = np.arange(0, 1201, 4, dtype=np.int32)
idx = np.tile(np.arange(4, dtype=np.int32), 300)
out2 = np.zeros(300, np.float64)
assert lib.LGBM_BoosterPredictForCSRC(
    bst, ctypes.c_void_p(indptr.ctypes.data), 2,
    ctypes.c_void_p(idx.ctypes.data), ctypes.c_void_p(X.ctypes.data), 1,
    ctypes.c_int64(301), ctypes.c_int64(1200), ctypes.c_int64(4), 0, -1,
    b"", ctypes.byref(n), ctypes.c_void_p(out2.ctypes.data)) == 0
from lightgbm_tpu_torch import capi
ref_ds = capi.LGBM_DatasetCreateFromMat(X, parameters=P.decode(),
                                        device="cpu")
capi.LGBM_DatasetSetField(ref_ds, "label", y)
ref = capi.LGBM_BoosterCreate(ref_ds, P.decode())
for _ in range(5):
    capi.LGBM_BoosterUpdateOneIter(ref)
want = np.asarray(capi.LGBM_BoosterPredictForMat(ref, X)).ravel()
assert n.value == 300 and (out == want).all() and (out2 == want).all()
assert lib.LGBM_BoosterFree(bst) == 0 and lib.LGBM_DatasetFree(ds) == 0
print("C-VARIANTS-OK")
"""


def test_plain_c_variants_through_ctypes(libs, tmp_path):
    """The ``...C`` exports (parameters as one C string) from a foreign
    FFI, against the port's ``capi`` in the same process."""
    script = tmp_path / "variants.py"
    script.write_text(C_VARIANTS)
    d, name = libs["port"]
    r = subprocess.run([sys.executable, str(script),
                        str(d / f"lib{name}.so")], env=_env("cpu"),
                       capture_output=True, text=True, timeout=300)
    assert "C-VARIANTS-OK" in r.stdout, (r.stdout, r.stderr)


def test_run_report_of_a_c_api_booster(monkeypatch, tmp_path):
    """``tpu_run_report`` in a C caller's parameters: the booster records
    each ``UpdateOneIter`` and writes the report when freed, naming its
    device and the kernels launched (on the CPU the plain versions, which
    launch none)."""
    from lightgbm_tpu_torch.obs.recorder import load_run_report
    monkeypatch.setenv(ce.PLATFORM_ENV, "cpu")
    X, y = _mk()
    n, f = X.shape
    path = tmp_path / "report.json"
    params = f"objective=binary num_leaves=7 tpu_run_report={path}"
    ds = ce.dataset_from_mat(X.ctypes.data, 1, n, f, 1, params, 0)
    ce.dataset_set_field(ds, "label", y.ctypes.data, n, 0)
    bst = ce.booster_create(ds, params)
    fin = np.zeros(1, np.int32)
    for _ in range(4):
        ce.booster_update(bst, fin.ctypes.data)
    out = np.zeros(n, np.float64)
    ce.booster_predict_mat(bst, X.ctypes.data, 1, n, f, 1, 0, -1, "",
                           out.ctypes.data)
    assert not path.exists()            # written when the booster is freed
    ce.free_handle(bst)
    ce.free_handle(ds)
    rep = load_run_report(str(path))
    assert rep["meta"]["driver"] == "capi"
    assert rep["meta"]["device"] == "cpu"
    assert rep["meta"]["device_name"] is None
    assert [r["it"] for r in rep["iterations"]] == [1, 2, 3, 4]
    assert all(r["wall_s"] > 0 for r in rep["iterations"])
    assert rep["extra"]["trained_iterations"] == 4
    assert rep["extra"]["kernel_launches"] == {
        "K1": 0, "K2": 0, "K3": 0, "K4": 0, "K4_from_rows": 0}
    assert "step_cache" in rep["meta"]
