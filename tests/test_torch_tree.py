"""Port parity: lightgbm_tpu_torch.models.tree against the JAX package's
Tree — model text byte for byte, and the float64 host walk bit for bit."""
import glob
import os

import numpy as np
import pytest

from lightgbm_tpu.models.tree import Tree as JaxTree
from lightgbm_tpu_torch.models.tree import Tree as TorchTree

pytestmark = pytest.mark.torch_port

DATA = os.path.join(os.path.dirname(__file__), "data", "golden2")
MODELS = sorted(os.path.basename(p)
                for p in glob.glob(os.path.join(DATA, "g2_*model.txt")))


def _tree_blocks(path):
    """The text of every Tree= block of a model file."""
    with open(path) as fh:
        body = fh.read().split("end of trees")[0]
    return ["\n".join(b.splitlines()[1:]) for b in body.split("Tree=")[1:]]


def _rows(seed=0):
    """Golden-shaped rows with the values trees treat specially."""
    r = np.random.default_rng(seed)
    X = np.fromfile(os.path.join(DATA, "g2_catbin_X.bin"),
                    np.float64).reshape(600, 8).copy()
    X[::7, 0] = np.nan
    X[::11, 1] = 0.0
    X[::13, 2] = -0.0
    X[::17, 3] = 1e-36
    X[::19, 4] = -np.inf
    X[::23, 5] = np.inf
    X[::29, 0] = -3.0                     # negative category
    X[::31, 6] = r.normal(size=X[::31, 6].shape) * 1e300
    return X


@pytest.mark.parametrize("model", MODELS)
def test_tree_text_roundtrip_and_host_walk(model):
    X = _rows()
    for block in _tree_blocks(os.path.join(DATA, model)):
        jt, pt = JaxTree.from_string(block), TorchTree.from_string(block)
        assert pt.to_string() == jt.to_string()
        np.testing.assert_array_equal(pt.predict(X), jt.predict(X))
        np.testing.assert_array_equal(pt.predict_leaf_index(X),
                                      jt.predict_leaf_index(X))
        for node in range(pt.num_leaves - 1):
            for v in (np.nan, 0.0, -0.0, 1e-36, 2.0, -1.0, 7.0,
                      pt.threshold[node]):
                assert pt._decision(v, node) == jt._decision(v, node)


def test_tree_split_matches_jax():
    """The grower's split bookkeeping (used by chip_smoke.py's model
    generator) writes the same tree as the JAX package's."""
    trees = [JaxTree(8), TorchTree(8)]
    r = np.random.default_rng(3)
    for _ in range(7):
        args = dict(leaf=int(r.integers(trees[0].num_leaves)),
                    feature=int(r.integers(5)), threshold_bin=0,
                    threshold_real=float(r.normal()), left_value=0.0,
                    right_value=0.0, left_count=0, right_count=0,
                    gain=1.0, missing_type=int(r.integers(3)),
                    default_left=bool(r.integers(2)))
        for t in trees:
            t.split(**args)
    assert trees[1].to_string() == trees[0].to_string()
