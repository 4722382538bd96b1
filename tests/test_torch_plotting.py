"""The port's plotting (lightgbm_tpu_torch/plotting.py) against the JAX
package's on the CPU, with matplotlib's Agg backend.

Bars: one model trained by both packages (model texts byte-equal) gives
the same importance bars (widths, labels, annotations), the same metric
curves from each package's ``evals_result``, the same node texts, boxes
and edges of ``plot_tree``, and the same graphviz source from
``create_tree_digraph``; both raise alike on a bad tree index.
"""
import numpy as np
import pytest

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lgt  # noqa: E402

pytestmark = pytest.mark.torch_port

PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
          "min_data_in_leaf": 10, "max_bin": 31, "metric": "auc",
          "verbose": -1}


@pytest.fixture(scope="module")
def boosters():
    """(JAX booster, port booster, JAX evals_result, port evals_result)
    of one model: 6 iterations with a valid set."""
    r = np.random.default_rng(7)
    X = r.normal(size=(800, 5))
    y = (X[:, 0] - X[:, 2] + 0.6 * X[:, 1] * X[:, 3] + 0.4 * X[:, 4]
         + 0.3 * r.normal(size=800) > 0).astype(float)
    out = []
    for pkg, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        ds = pkg.Dataset(X[:600], label=y[:600])
        va = pkg.Dataset(X[600:], label=y[600:], reference=ds)
        ev = {}
        b = pkg.train(dict(PARAMS), ds, 6, valid_sets=[ds, va],
                      valid_names=["train", "valid"], evals_result=ev,
                      verbose_eval=False, **kw)
        out.append((b, ev))
    (jb, jev), (tb, tev) = out
    assert tb.model_to_string() == jb.model_to_string()
    return jb, tb, jev, tev


def _texts(ax):
    return [(t.get_text(), t.get_position()) for t in ax.texts]


@pytest.mark.parametrize("kind", ["split", "gain"])
def test_plot_importance_equal(boosters, kind):
    jb, tb = boosters[:2]
    axes = []
    for pkg, b in ((lgb, jb), (lgt, tb)):
        fig, ax = plt.subplots()
        pkg.plot_importance(b, ax=ax, importance_type=kind,
                            max_num_features=4)
        axes.append(ax)
        plt.close(fig)
    ja, ta = axes
    assert [p.get_width() for p in ta.patches] == \
        [p.get_width() for p in ja.patches]
    assert len(ta.patches) == 4       # the four most important of five
    assert [t.get_text() for t in ta.get_yticklabels()] == \
        [t.get_text() for t in ja.get_yticklabels()]
    assert _texts(ta) == _texts(ja)
    assert ta.get_title() == ja.get_title()


def test_plot_metric_equal(boosters):
    jev, tev = boosters[2:]
    axes = []
    for pkg, ev in ((lgb, jev), (lgt, tev)):
        fig, ax = plt.subplots()
        pkg.plot_metric(ev, metric="auc", ax=ax)
        axes.append(ax)
        plt.close(fig)
    ja, ta = axes
    for a, b in zip(ja.lines, ta.lines):
        np.testing.assert_allclose(b.get_ydata(), a.get_ydata(), rtol=1e-6)
        assert b.get_label() == a.get_label()
    assert len(ta.lines) == len(ja.lines) == 2
    assert ta.get_ylabel() == ja.get_ylabel() == "auc"
    with pytest.raises(lgt.LightGBMError):
        lgt.plot_metric(boosters[1])


@pytest.mark.parametrize("tree", [0, 5])
def test_plot_tree_node_texts_equal(boosters, tree):
    jb, tb = boosters[:2]
    axes = []
    for pkg, b in ((lgb, jb), (lgt, tb)):
        fig, ax = plt.subplots()
        pkg.plot_tree(b, ax=ax, tree_index=tree,
                      show_info=["internal_count", "leaf_count"])
        axes.append(ax)
        plt.close(fig)
    ja, ta = axes
    assert _texts(ta) == _texts(ja) and len(ta.texts) >= 3
    assert [ln.get_xydata().tolist() for ln in ta.lines] == \
        [ln.get_xydata().tolist() for ln in ja.lines]
    assert ta.get_title() == ja.get_title() == f"Tree {tree}"
    with pytest.raises(IndexError):
        lgt.plot_tree(tb, tree_index=6)


def test_tree_digraph_source_equal(boosters):
    pytest.importorskip("graphviz")
    jb, tb = boosters[:2]
    info = ["split_gain", "internal_value", "internal_count", "leaf_count"]
    assert lgt.create_tree_digraph(tb, 1, show_info=info).source == \
        lgb.create_tree_digraph(jb, 1, show_info=info).source
