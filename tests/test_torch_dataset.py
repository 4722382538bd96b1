"""Port parity: lightgbm_tpu_torch.io (binning, the binned dataset) and
convert.dataset_from_numpy against lightgbm_tpu.io.

Bars: every mapper field, the feature infos, the FeatureMeta and the
[F, N] bin matrix bit-equal, on LRB-shaped and HIGGS-shaped rows with
NaN, -0.0, +-1e-36, infinities, an all-zero and a constant column.
"""
import numpy as np
import pytest
import torch

from chip_smoke import make_higgs_like, make_lrb_rows
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.io.dataset import TpuDataset
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import dataset_from_numpy, mapper_from_dict
from lightgbm_tpu_torch.io.dataset import BinnedDataset, Metadata

pytestmark = pytest.mark.torch_port

MAPPER_FIELDS = ("num_bin", "missing_type", "default_bin", "is_trivial",
                 "sparse_rate", "min_val", "max_val")


def _rows(kind: str, n: int = 2500, seed: int = 0) -> np.ndarray:
    r = np.random.default_rng(seed)
    if kind == "lrb":
        X = make_lrb_rows(n, seed=seed)
    else:
        X = make_higgs_like(n, seed=seed)[0].astype(np.float64)
    X[r.random(n) < 0.07, 1] = np.nan
    X[::13, 2] = -0.0
    X[::17, 3] = 1e-36
    X[::19, 4] = -1e-36
    X[::23, 5] = np.inf
    X[::29, 5] = -np.inf
    X[:, 6] = 0.0
    X[:, 7] = 3.5
    return X


def _pair(X, params):
    y = (np.arange(X.shape[0]) % 3 == 0).astype(np.float32)
    jd = TpuDataset(JConfig().set(dict(params))).construct_from_matrix(
        X, JMeta(label=y))
    td = BinnedDataset(TConfig().set(dict(params)), "cpu") \
        .construct_from_matrix(X, Metadata(label=y))
    return jd, td


def _assert_same(jd, td):
    assert jd.bundles is None
    assert list(td.used_feature_map) == list(jd.used_feature_map)
    assert td.max_bin_global == jd.max_bin_global
    for jm, tm in zip(jd.mappers, td.mappers):
        for k in MAPPER_FIELDS:
            assert getattr(tm, k) == getattr(jm, k), k
        np.testing.assert_array_equal(tm.bin_upper_bound, jm.bin_upper_bound)
    assert td.feature_infos() == jd.feature_infos()
    for a, b in zip(td.feature_meta(), jd.feature_meta()[:5]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want = np.asarray(jd.host_bins()).T
    got = td.bins_t.numpy()
    assert got.dtype == np.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["lrb", "higgs"])
@pytest.mark.parametrize("params", [
    {"max_bin": 255}, {"max_bin": 63}, {"max_bin": 15, "min_data_in_bin": 1},
    {"max_bin": 63, "zero_as_missing": True},
    {"max_bin": 63, "use_missing": False},
    {"max_bin": 63, "min_data_in_leaf": 200}])
def test_mappers_and_bins_bit_equal(kind, params):
    X = _rows(kind)
    jd, td = _pair(X, {**params, "enable_bundle": False})
    _assert_same(jd, td)
    # the trivial columns are dropped in both
    assert 6 not in td.used_feature_map and 7 not in td.used_feature_map


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sampled_rows_and_f32_input(dtype):
    """More rows than bin_construct_sample_cnt: the same PCG64 sample."""
    X = _rows("higgs", n=3000, seed=4).astype(dtype)
    jd, td = _pair(X, {"max_bin": 63, "bin_construct_sample_cnt": 700,
                       "enable_bundle": False})
    _assert_same(jd, td)


def test_value_to_bin_matches_the_device_binner():
    X = _rows("lrb", n=1500, seed=2)
    _, td = _pair(X, {"max_bin": 255})
    for i, real in enumerate(td.used_feature_map):
        np.testing.assert_array_equal(
            td.mappers[i].value_to_bin(X[:, real]),
            td.bins_t[i].numpy().astype(np.int32))


def test_all_trivial_gives_one_dummy_feature():
    X = np.zeros((200, 3))
    X[:, 1] = 7.0
    _, td = _pair(X, {})
    assert td.num_features == 0 and td.bins_t.shape == (1, 200)
    meta = td.feature_meta()
    assert list(meta.num_bin) == [1]


def test_categorical_mappers_converted():
    X = np.zeros((300, 2))
    X[:, 0] = np.arange(300) % 7
    X[:, 1] = np.arange(300) * 0.5
    jd = TpuDataset(JConfig().set({"categorical_feature": "0"})) \
        .construct_from_matrix(X, JMeta(label=np.zeros(300)),
                               categorical=[0])
    for jm in jd.mappers:
        tm = mapper_from_dict(jm.to_dict())
        for k in MAPPER_FIELDS + ("bin_type", "bin_2_categorical",
                                  "categorical_2_bin"):
            assert getattr(tm, k) == getattr(jm, k), k
        np.testing.assert_array_equal(tm.bin_upper_bound, jm.bin_upper_bound)
        assert tm.feature_info() == jm.feature_info()
        np.testing.assert_array_equal(tm.value_to_bin(X[:, 0]),
                                      jm.value_to_bin(X[:, 0]))
    assert jd.mappers[0].bin_type == 1 and jd.mappers[1].bin_type == 0


def test_dataset_from_jax_state():
    X = _rows("higgs", n=1200, seed=6)
    jd, td = _pair(X, {"max_bin": 63, "enable_bundle": False})
    cd = dataset_from_numpy(
        np.asarray(jd.host_bins()), [m.to_dict() for m in jd.mappers],
        jd.used_feature_map, jd.num_total_features,
        TConfig().set({"max_bin": 63}), label=jd.metadata.label,
        device="cpu")
    _assert_same(jd, cd)
    assert torch.equal(cd.bins_t, td.bins_t)
