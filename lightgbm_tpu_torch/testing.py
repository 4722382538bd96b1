"""Random models for checks of the scoring path: LightGBM v2 model text
of random trees over the columns of a sample matrix, at any number of
trees, leaves and classes; and the probes a distributed worker's runs
call (parallel/elastic.py ``setup`` and ``hook``): injected collectives
that count or replace, the voting learner's elections, the step cache's
counters."""
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


_net_calls = {"reduce_scatter": 0, "allgather": 0}


def parallel_setup(run: dict, rank: int) -> None:
    """Before a run: ``run["network"]`` "count" installs collectives that
    count their calls and then run the default, "replace" a sum that
    returns its input (every rank trains on its own rows), both through
    ``capi.LGBM_NetworkInitWithFunctions``; ``run["elections"]`` records
    the voting learner's elected features."""
    from . import capi
    from .parallel import learners
    _net_calls.update(reduce_scatter=0, allgather=0)
    mode = run.get("network")
    if mode == "count":
        def count(name):
            def fn(x, default):
                _net_calls[name] += 1
                return default(x)
            return fn
        capi.LGBM_NetworkInitWithFunctions(
            2, rank, reduce_scatter_fn=count("reduce_scatter"),
            allgather_fn=count("allgather"))
    elif mode == "replace":
        capi.LGBM_NetworkInitWithFunctions(
            2, rank, reduce_scatter_fn=lambda x, default: x)
    learners.election_log = [] if run.get("elections") else None


def _wire_sums(rank: int) -> dict:
    """The data learner's histogram collective on the group at every
    wire (int8, int16, int32) and slot count (1, 2): each rank's
    [4, 7, 16, 3] int32 sums drawn from its rank's seed in [-60, 60], so
    two ranks' totals fit int8. Whether each equals the exact sum."""
    import torch
    import torch.distributed as dist
    from .ops.wave_grower import WaveGrowerConfig
    from .parallel import learners

    def part(r):
        g = torch.Generator().manual_seed(r)
        return torch.randint(-60, 61, (4, 7, 16, 3), generator=g,
                             dtype=torch.int32)
    want = sum(part(r) for r in range(dist.get_world_size()))
    return {f"{wire}/{slots}": bool(torch.equal(
        learners.make_hist_reduce(WaveGrowerConfig(
            15, 16, quant_psum=True, psum_wire=wire,
            psum_slots=slots))(part(rank)), want))
        for wire in ("int8", "int16", "int32") for slots in (1, 2)}


def parallel_probe(booster, run: dict, spec: dict, rank: int) -> dict:
    """After a run: the injected collectives' calls (then
    ``LGBM_NetworkFree`` and whether it cleared them), the elections of
    the run's first ``run["elections"]`` searches, with ``run["wires"]``
    the histogram collective at every wire and its seconds in 1 and 2
    slots, with ``run["checkpoint"]`` whether a checkpoint is refused,
    with ``run["refit"]`` the trees refit at decay 0.5, the step cache's
    counters and pool, and whether the set was bundled."""
    from . import capi
    from .ops import step_cache
    from .ops.autotune import measure_psum_s
    from .parallel import learners
    from .utils.log import LightGBMError
    out = {"step_cache": step_cache.stats(),
           "step_pool": booster._step_pool() is not None,
           "bundled": booster.train_data.bundles is not None}
    if run.get("network"):
        out["network_calls"] = dict(_net_calls)
        capi.LGBM_NetworkFree()
        out["overrides_cleared"] = not learners._collective_overrides
    if run.get("wires"):
        out["wires"] = _wire_sums(rank)
        import torch
        out["psum_s"] = [measure_psum_s((4, 7, 16, 3), torch.int32,
                                        repeats=3, slots=s) for s in (1, 2)]
    if run.get("checkpoint"):
        import tempfile
        try:
            with tempfile.TemporaryDirectory() as d:
                booster.write_checkpoint(d)
            out["checkpoint_refused"] = False
        except LightGBMError:
            out["checkpoint_refused"] = True
    if run.get("refit"):
        booster.refit_existing(0.5)
        out["refit_trees"] = booster.model_to_string().split(
            "\nparameters:")[0]
    if learners.election_log is not None:
        out["elected"] = [e.tolist() for e in
                          learners.election_log[:int(run["elections"])]]
        learners.election_log = None
    return out
