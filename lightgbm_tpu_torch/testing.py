"""Random models for checks of the scoring path: LightGBM v2 model text
of random trees over the columns of a sample matrix, at any number of
trees, leaves and classes."""
import numpy as np

from .config import Config
from .models.gbdt import GBDT
from .models.tree import Tree
from .objectives import parse_objective_from_model_string


def random_model_text(X: np.ndarray, n_trees: int, n_leaves: int,
                      seed: int, objective: str = "binary sigmoid:1") -> str:
    """LightGBM v2 model text of ``n_trees`` random trees: each grows by
    splitting a random leaf until it has ``n_leaves``, on a random
    feature at a threshold from that column's 255-quantile grid, with
    missing types and default directions mixed; leaf values ~ N(0,
    0.05)."""
    r = np.random.default_rng(seed)
    F = X.shape[1]
    grid = [np.unique(np.quantile(X[:, f].astype(np.float64),
                                  np.linspace(0, 1, 257)[1:-1]))
            for f in range(F)]
    g = GBDT()
    g.max_feature_idx = F - 1
    g.feature_names = [f"Column_{f}" for f in range(F)]
    g.feature_infos = ["none"] * F
    g.objective = parse_objective_from_model_string(objective, Config())
    g.num_class = g.num_tree_per_iteration = getattr(
        g.objective, "num_class", 1)
    for _ in range(n_trees):
        t = Tree(n_leaves)
        while t.num_leaves < n_leaves:
            f = int(r.integers(F))
            t.split(leaf=int(r.integers(t.num_leaves)), feature=f,
                    threshold_bin=0,
                    threshold_real=float(r.choice(grid[f])),
                    left_value=0.0, right_value=0.0, left_count=0,
                    right_count=0, gain=1.0,
                    missing_type=int(r.integers(3)),
                    default_left=bool(r.integers(2)))
        t.leaf_value = list(r.normal(0.0, 0.05, t.num_leaves))
        g.models.append(t)
    return g.model_to_string()
