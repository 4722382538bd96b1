"""Port parity: lightgbm_tpu_torch.ops.split.find_best_split against
lightgbm_tpu.ops.split.find_best_split, as the JAX grower calls it (a
jitted vmap over the leaves of a wave).

Bars: on tie-free histograms the integer fields (feature, threshold,
default direction) and the counts are equal, and the float fields are
bit-equal except the gain, which is within 4 ulp: XLA fuses the gain
expression differently from PyTorch's op-by-op rounding for some shapes
(JAX's own jitted and eager results differ there too). The histogram
widths are the JAX package's bucketed ones (powers of two >= 64 in these
tests), where XLA's prefix product adds in bin order like the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fit_gbdt
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import split as ts

pytestmark = pytest.mark.torch_port

INT_FIELDS = ("feature", "threshold_bin", "default_left", "left_count",
              "right_count")
SUM_FIELDS = ("left_output", "right_output", "left_sum_g", "left_sum_h",
              "right_sum_g", "right_sum_h")


def _meta(F, B, r):
    nb = r.integers(3, B + 1, F).astype(np.int32)
    nb[0] = B
    mt = r.integers(0, 3, F).astype(np.int32)
    db = np.array([r.integers(0, b) for b in nb], np.int32)
    return dict(num_bin=nb, missing_type=mt, default_bin=db,
                monotone=np.zeros(F, np.int32),
                penalty=np.ones(F, np.float32))


def _hists(M, F, B, meta, r):
    hist = np.zeros((M, F, B, 3), np.float32)
    for m in range(M):
        for f in range(F):
            k = meta["num_bin"][f]
            c = r.integers(0, 80, k).astype(np.float32)
            hist[m, f, :k, 2] = c
            hist[m, f, :k, 0] = (r.normal(size=k) * np.sqrt(c)).astype(
                np.float32)
            hist[m, f, :k, 1] = (c * r.uniform(0.05, 0.25, k)).astype(
                np.float32)
    return hist


def _jax_splits(hist, sg, sh, nd, fmask, can, meta, hp):
    jm = js.FeatureMeta(**{k: jnp.asarray(v) for k, v in meta.items()})
    jhp = js.SplitParams(**hp, has_cat=False)

    @jax.jit
    def run(h, a, b, c, d):
        return jax.vmap(lambda hh, x, y, z, w: js.find_best_split(
            hh, x, y, z, jnp.asarray(fmask), jm, jhp, w))(h, a, b, c, d)
    return run(hist, sg, sh, nd, can)


def _port_splits(hist, sg, sh, nd, fmask, can, meta, hp):
    return ts.find_best_split(
        torch.tensor(hist), torch.tensor(sg), torch.tensor(sh),
        torch.tensor(nd), torch.tensor(fmask),
        ts.FeatureMeta(**meta).to("cpu"), ts.SplitParams(**hp),
        torch.tensor(can))


def _compare(J, T, gain_ulps=4):
    for k in INT_FIELDS + SUM_FIELDS:
        np.testing.assert_array_equal(getattr(T, k).numpy(),
                                      np.asarray(getattr(J, k)), err_msg=k)
    jg, tg = np.asarray(J.gain), T.gain.numpy()
    fin = np.isfinite(jg)
    np.testing.assert_array_equal(np.isfinite(tg), fin)
    np.testing.assert_array_less(
        np.abs(tg[fin] - jg[fin]),
        gain_ulps * np.spacing(np.abs(jg[fin])) + 1e-30)


@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("hp", [
    {"min_data_in_leaf": 20.0, "min_sum_hessian_in_leaf": 1e-3},
    {"min_data_in_leaf": 5.0, "lambda_l1": 0.5, "lambda_l2": 1.0,
     "min_gain_to_split": 0.1},
    {"min_data_in_leaf": 50.0, "min_sum_hessian_in_leaf": 5.0,
     "max_delta_step": 0.3}])
def test_random_histograms(B, hp):
    r = np.random.default_rng(B + int(hp["min_data_in_leaf"]))
    M, F = 8, 7
    meta = _meta(F, B, r)
    hist = _hists(M, F, B, meta, r)
    sg = hist[:, 0, :, 0].sum(1, dtype=np.float32)
    sh = hist[:, 0, :, 1].sum(1, dtype=np.float32)
    nd = hist[:, 0, :, 2].sum(1, dtype=np.float32)
    fmask = r.random(F) < 0.8
    fmask[0] = True
    can = np.ones(M, bool)
    can[-1] = False                      # depth-limited: -inf gain
    J = _jax_splits(hist, sg, sh, nd, fmask, can, meta, hp)
    T = _port_splits(hist, sg, sh, nd, fmask, can, meta, hp)
    _compare(J, T)
    assert not np.isfinite(T.gain[-1].item()) and T.feature[-1].item() == -1


def test_monotone_and_penalty():
    r = np.random.default_rng(11)
    M, F, B = 6, 5, 64
    meta = _meta(F, B, r)
    meta["monotone"] = np.array([1, -1, 0, 1, 0], np.int32)
    meta["penalty"] = np.array([1.0, 0.5, 2.0, 1.0, 0.25], np.float32)
    hist = _hists(M, F, B, meta, r)
    sg = hist[:, 0, :, 0].sum(1, dtype=np.float32)
    sh = hist[:, 0, :, 1].sum(1, dtype=np.float32)
    nd = hist[:, 0, :, 2].sum(1, dtype=np.float32)
    hp = {"min_data_in_leaf": 10.0}
    args = (hist, sg, sh, nd, np.ones(F, bool), np.ones(M, bool), meta, hp)
    _compare(_jax_splits(*args), _port_splits(*args))


def test_histograms_from_a_jax_run():
    """Real histograms: the wave histograms of a JAX training run's
    first tree (its root and one wave of children)."""
    from lightgbm_tpu.ops.hist_wave import wave_histogram_xla
    r = np.random.default_rng(2)
    n = 3000
    X = r.normal(size=(n, 6))
    X[r.random(n) < 0.1, 2] = np.nan
    y = ((X[:, 0] + X[:, 1] * X[:, 3]) > 0).astype(np.float32)
    g = fit_gbdt(X, y, {"objective": "binary", "max_bin": 63,
                        "enable_bundle": False}, num_round=1)
    ds = g.train_data
    bins_t = np.ascontiguousarray(np.asarray(ds.host_bins()).T)
    s0 = np.asarray(g.train_scores()[0])
    leaf = (s0 > np.median(s0)).astype(np.int32)
    grad = (0.5 - y).astype(np.float32)
    hess = np.full(n, 0.25, np.float32)
    hist = np.asarray(wave_histogram_xla(
        jnp.asarray(bins_t), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(leaf), jnp.asarray(np.array([0, 1], np.int32)),
        num_bins=64))
    sg = hist[:, 0, :, 0].sum(1, dtype=np.float32)
    sh = hist[:, 0, :, 1].sum(1, dtype=np.float32)
    nd = hist[:, 0, :, 2].sum(1, dtype=np.float32)
    fm = ds.feature_meta()
    meta = {k: np.asarray(getattr(fm, k)) for k in ts.FeatureMeta._fields}
    args = (hist, sg, sh, nd, np.ones(hist.shape[1], bool),
            np.ones(2, bool), meta, {"min_data_in_leaf": 20.0})
    J, T = _jax_splits(*args), _port_splits(*args)
    _compare(J, T)
    assert (T.feature >= 0).all()
