"""Plotting utilities (the JAX package's ``plotting.py``).

The reference plotting module's functions (reference:
python-package/lightgbm/plotting.py:24 plot_importance, :133
plot_metric, :384 plot_tree), drawn from a booster's importances,
evaluation history and model dump. They run on the host only: nothing
here touches a device, and matplotlib (graphviz for
``create_tree_digraph``) is imported inside each function, so the
module imports without them. plot_tree renders the tree structure
directly with matplotlib instead of requiring graphviz.
"""
from __future__ import annotations

from copy import deepcopy

import numpy as np

from .basic import Booster
from .utils.log import LightGBMError


def _check_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        raise ImportError("You must install matplotlib for plotting")


def plot_importance(booster, ax=None, height=0.2, xlim=None, ylim=None,
                    title="Feature importance", xlabel="Feature importance",
                    ylabel="Features", importance_type="split",
                    max_num_features=None, ignore_zero=True, figsize=None,
                    grid=True, **kwargs):
    """Plot model's feature importances (plotting.py:24-130)."""
    plt = _check_matplotlib()
    if isinstance(booster, Booster):
        importance = booster.feature_importance(importance_type)
        feature_name = booster.feature_name()
    elif hasattr(booster, "booster_"):
        importance = booster.booster_.feature_importance(importance_type)
        feature_name = booster.booster_.feature_name()
    else:
        raise TypeError("booster must be Booster or LGBMModel")
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty")
    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples) if tuples else ((), ())

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, str(int(x)) if importance_type == "split"
                else f"{x:.2f}", va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    else:
        ax.set_ylim(-1, len(values))
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None, ax=None,
                xlim=None, ylim=None, title="Metric during training",
                xlabel="Iterations", ylabel="auto", figsize=None,
                grid=True):
    """Plot one metric's history from an evals_result dict or a Booster
    trained with record_evaluation (plotting.py:133-230)."""
    plt = _check_matplotlib()
    if isinstance(booster, dict):
        eval_results = deepcopy(booster)
    elif hasattr(booster, "evals_result_"):     # LGBMModel
        eval_results = deepcopy(booster.evals_result_)
        if not eval_results:
            raise LightGBMError("Fit the estimator with eval_set to "
                                "record metrics")
    elif isinstance(booster, Booster):
        raise LightGBMError(
            "Pass the evals_result dict from train(..., evals_result=...)")
    else:
        raise TypeError("booster must be dict of eval results or a "
                        "fitted LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty")

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    if dataset_names is None:
        dataset_names = iter(eval_results.keys())
    name = None
    num_iteration, max_result, min_result = 0, -np.inf, np.inf
    for name_ds in dataset_names:
        metrics = eval_results[name_ds]
        if metric is None:
            metric_name, results = next(iter(metrics.items()))
        else:
            metric_name, results = metric, metrics[metric]
        name = metric_name
        max_result = max(max(results), max_result)
        min_result = min(min(results), min_result)
        num_iteration = max(len(results), num_iteration)
        ax.plot(range(len(results)), results, label=name_ds)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    else:
        ax.set_xlim(0, num_iteration)
    if ylim is not None:
        ax.set_ylim(ylim)
    else:
        margin = 0.05 * (max_result - min_result + 1e-12)
        ax.set_ylim(min_result - margin, max_result + margin)
    if ylabel == "auto":
        ylabel = name
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _tree_model(booster, tree_index):
    """Shared renderer preamble: normalize Booster/LGBMModel, dump the
    model, bound-check the tree, return (tree_structure, names)."""
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    if not isinstance(booster, Booster):
        raise TypeError("booster must be Booster or LGBMModel")
    model = booster.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError("tree_index is out of range")
    return (model["tree_info"][tree_index]["tree_structure"],
            model["feature_names"])


def _split_desc(node, names, precision):
    """Shared split-node text: feature-name fallback + threshold
    rounding used by both tree renderers."""
    feat = node["split_feature"]
    fname = names[feat] if feat < len(names) else f"f{feat}"
    op = node.get("decision_type", "<=")
    return f"{fname} {op} {round(node['threshold'], precision)}"


def _leaf_desc(node, precision):
    """Shared leaf text: (index, rounded value)."""
    return (node.get("leaf_index", 0),
            round(node.get("leaf_value", 0.0), precision))


def plot_tree(booster, ax=None, tree_index=0, figsize=None,
              show_info=None, precision=3):
    """Render one tree's structure with matplotlib (plotting.py:384-449
    renders via graphviz; this draws the same node content natively).
    ``show_info``: extra node fields to annotate, from
    {'internal_count', 'internal_value', 'leaf_count'}."""
    plt = _check_matplotlib()
    tree, names = _tree_model(booster, tree_index)

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize or (12, 8))

    # layout: assign x by in-order leaf position, y by depth
    positions = {}
    leaf_x = [0]

    def layout(node, depth):
        if "leaf_index" in node or "leaf_value" in node and \
                "split_index" not in node:
            x = leaf_x[0]
            leaf_x[0] += 1
            positions[id(node)] = (x, -depth)
            return x
        lx = layout(node["left_child"], depth + 1)
        rx = layout(node["right_child"], depth + 1)
        x = (lx + rx) / 2.0
        positions[id(node)] = (x, -depth)
        return x

    layout(tree, 0)

    def draw(node):
        x, y = positions[id(node)]
        info = show_info or []
        if "split_index" in node:
            label = (f"{_split_desc(node, names, precision)}\n"
                     f"gain={round(node.get('split_gain', 0.0), precision)}")
            for key in ("internal_count", "internal_value"):
                if key in info and key in node:
                    label += f"\n{key}={round(node[key], precision)}"
            box = dict(boxstyle="round", fc="lightblue", ec="black")
            for child in (node["left_child"], node["right_child"]):
                cx, cy = positions[id(child)]
                ax.plot([x, cx], [y, cy], "k-", lw=0.8, zorder=1)
                draw(child)
        else:
            li, lv = _leaf_desc(node, precision)
            label = f"leaf {li}:\n{lv}"
            if "leaf_count" in info and "leaf_count" in node:
                label += f"\ncount={node['leaf_count']}"
            box = dict(boxstyle="round", fc="lightgreen", ec="black")
        ax.text(x, y, label, ha="center", va="center", bbox=box,
                fontsize=8, zorder=2)

    draw(tree)
    ax.set_axis_off()
    ax.set_title(f"Tree {tree_index}")
    return ax


def create_tree_digraph(booster, tree_index=0, show_info=None,
                        precision=3, name=None, comment=None, **kwargs):
    """One tree as a graphviz Digraph (reference plotting.py:311-381
    create_tree_digraph; node content matches _to_graphviz:257-308).
    ``show_info`` from {'split_gain', 'internal_value', 'internal_count',
    'leaf_count'}."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz to plot tree.")
    tree, names = _tree_model(booster, tree_index)
    info = show_info or []

    graph = Digraph(name=name, comment=comment, **kwargs)

    def add(node, parent=None, decision=None):
        if "split_index" in node:
            nid = f"split{node['split_index']}"
            label = _split_desc(node, names, precision)
            if "split_gain" in info:
                label += f"\ngain: {round(node.get('split_gain', 0.0), precision)}"
            if "internal_value" in info and "internal_value" in node:
                label += f"\nvalue: {round(node['internal_value'], precision)}"
            if "internal_count" in info and "internal_count" in node:
                label += f"\ncount: {node['internal_count']}"
            graph.node(nid, label=label)
            add(node["left_child"], nid, "yes")
            add(node["right_child"], nid, "no")
        else:
            li, lv = _leaf_desc(node, precision)
            nid = f"leaf{li}"
            label = f"leaf {li}: {lv}"
            if "leaf_count" in info and "leaf_count" in node:
                label += f"\ncount: {node['leaf_count']}"
            graph.node(nid, label=label)
        if parent is not None:
            graph.edge(parent, nid, decision)
        return nid

    add(tree)
    return graph
