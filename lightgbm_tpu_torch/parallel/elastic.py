"""Multi-process training: the worker and its launcher.

The JAX package's ``parallel/elastic.py``, its first half (:91-466):

**Worker** (``python -m lightgbm_tpu_torch.parallel.elastic --spec
s.json``): one rank. It reads a spec, joins the process group
(parallel/cluster.py; the topology from the ``LGBM_TPU_NUM_MACHINES``,
``LGBM_TPU_MACHINE_RANK`` and ``LGBM_TPU_COORDINATOR`` environment the
launcher sets), loads the spec's data, and trains each of the spec's
runs in turn in the same world: under data and voting through the
sharded ingest (only the rank's row block is binned onto its device,
io/ingest.py ``bin_matrix_sharded``; every rank finds the same mappers
on the whole matrix), under feature the whole set. Each run's model text
goes to ``<dump_dir>/<run>.rank<r>.txt`` and the rank's results (ms an
iteration, the collectives' bytes and seconds an iteration, train and
valid metrics) to ``<out>.rank<r>``. The ``train.iter`` fault point sits
at the top of each iteration, under the no-hang ``DeadlineGuard``; a
peer that dies (a collective fails or stalls) ends the survivor with one
warning line naming the rank and ``EXIT_PEER_LOST``.

Ranks pick their device from the spec: ``"cpu"``, ``"cuda:0"`` (ranks
sharing one card, gloo) or ``"cuda"`` (a card a rank, NCCL); the default
is the card, as every entry point's is. A run's ``data`` (an .npz)
replaces the spec's for that run; its ``rows`` trains on the data's
first rows only. A spec's ``setup`` (``"module:function"``) is
called before each run as ``fn(run, rank)``, its ``hook`` after each as
``fn(booster, run, spec, rank)``, whose dict joins the run's results
(chip_smoke.py reads its kernels there; lightgbm_tpu_torch/testing.py
has the tests' probes). A run of ``"kind": "load"`` trains nothing: it
loads the rank's set through ``io/distributed.DistributedLoader`` and
reports its mappers' ``feature_info`` strings; a run with ``"driver":
"train"`` trains through ``GBDT.train`` (its run report, ``tpu_run_report``,
then carries the world's ``mesh_devices`` and each iteration's
``comm_bytes``).

**Launcher** (``launch_workers``): ``world`` OS processes on a fresh
localhost port, each started by ``subprocess`` (a new interpreter:
never a fork of a process that has touched CUDA), the fault spec armed
on one rank only. The kernels must be built before the launch
(``utils/cuda_build.build_all``; a rank that finds them missing builds
under a file lock). ``run_two_process`` is the smoke: two ranks, one
world, the texts compared.

Left for the next slice: ``run_drill`` (kill and resume onto another
world size), the autoscale drill and the scaling bench (:485-939).
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..utils import log
from . import cluster

DRILL_N = 4096
DRILL_F = 8

DRILL_PARAMS: Dict = {
    "objective": "binary",
    "metric": "auc",
    "num_leaves": 15,
    "max_bin": 63,
    "min_data_in_leaf": 5,
    "learning_rate": 0.1,
    "tree_learner": "data",
    # the int8 tier's integer wire and shard-invariant rounding make the
    # model independent of the world size
    "tpu_quantized_hist": True,
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _synth_data(spec: Dict):
    import numpy as np
    r = np.random.default_rng(int(spec.get("seed", 0)))
    n = int(spec.get("n", DRILL_N))
    f = int(spec.get("f", DRILL_F))
    X = r.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return {"X": X, "y": y}


def _load_data(spec: Dict) -> Dict:
    """The spec's data: made by its ``maker`` (``"module:function"``,
    called with the spec, returning a dict of X, y and optionally weight,
    Xv, yv), or an ``.npz`` (``data``) of them that every rank reads
    whole, else the synthetic drill set of ``seed``, ``n``, ``f``."""
    if spec.get("maker"):
        return _hook(spec, "maker")(spec)
    path = spec.get("data")
    if not path:
        return _synth_data(spec)
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _write_json(path: str, payload: Dict) -> None:
    from ..utils.fileio import atomic_write
    with atomic_write(path) as fh:
        json.dump(payload, fh, indent=1)


def _params(spec: Dict, run: Optional[Dict] = None) -> Dict:
    """A run's parameters: the spec's over its run's, over
    ``DRILL_PARAMS`` for the synthetic drill set only."""
    drill = not (spec.get("maker") or spec.get("data"))
    return {**(DRILL_PARAMS if drill else {}), **spec.get("params", {}),
            **((run or {}).get("params", {}))}


def _hook(spec: Dict, key: str = "hook"):
    name = spec.get(key)
    if not name:
        return None
    import importlib
    mod, fn = name.split(":")
    return getattr(importlib.import_module(mod), fn)


def _train_run(spec: Dict, run: Dict, data: Dict, device) -> tuple:
    """One run in this world: (booster, results)."""
    import numpy as np
    import torch

    from ..config import Config
    from ..io.dataset import BinnedDataset, Metadata
    from ..metrics.metric import create_metrics
    from ..models.boosting import create_boosting
    from ..objectives import create_objective
    from ..utils import faults
    from . import learners

    cfg = Config().set(_params(spec, run))
    rows = int(run.get("rows") or data["X"].shape[0])
    X, y = data["X"][:rows], data["y"][:rows]
    n = X.shape[0]
    w = data.get("weight")
    meta = Metadata(label=y, weight=None if w is None else w[:rows])
    t0 = time.perf_counter()
    block = None
    if (cluster.is_multiprocess() and cfg.tree_learner in ("data", "voting")
            and spec.get("sharded_ingest", True)):
        block = learners.learner_block(n, cluster.world(), cluster.rank())
    ds = BinnedDataset(cfg, device).construct_from_matrix(
        X, meta, row_block=block)
    ingest_s = time.perf_counter() - t0
    obj = create_objective(cfg.objective, cfg)
    obj.init(ds.metadata, ds.num_data)
    names = cfg.metric or [cfg.objective]
    mets = create_metrics(names, cfg, ds.metadata, ds.num_data)
    g = create_boosting(cfg.boosting_type(), device)
    g.init(cfg, ds, obj, mets)
    if "Xv" in data:
        vd = ds.create_valid(data["Xv"], Metadata(label=data["yv"]))
        g.add_valid_data(vd, create_metrics(names, cfg, vd.metadata,
                                            vd.num_data), "valid_1")
    on_card = torch.device(device).type == "cuda"
    walls, comm = [], []
    if run.get("driver") == "train":
        # the CLI driver's loop, with its run report (tpu_run_report)
        g.train()
        comm = list(g._comm)
    for it in range(0 if run.get("driver") == "train"
                    else cfg.num_iterations):
        faults.check("train.iter", context=it + 1)
        t1 = time.perf_counter()
        stop = g.train_one_iter()
        if on_card:
            torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t1)
        if g._comm:
            comm.append(g._comm[-1])
        if stop:
            break
    text = g.model_to_string()
    dump = spec.get("dump_dir") or os.path.dirname(str(spec.get("out", "")))
    name = run.get("name", "run")
    if dump:
        from ..utils.fileio import atomic_write
        with atomic_write(os.path.join(
                dump, f"{name}.rank{cluster.rank()}.txt")) as fh:
            fh.write(text)
    evals = {f"training/{m}": v for m, v, _ in g.get_eval_at(0)}
    for i in range(len(g.valid_sets)):
        evals.update({f"valid_{i + 1}/{m}": v
                      for m, v, _ in g.get_eval_at(i + 1)})
    res = {
        "name": name,
        "learner_mode": g.learner_mode,
        "num_devices": g.num_devices,
        "iterations": int(g.current_iteration),
        "row_block": list(g._row_block),
        "ingest_s": ingest_s,
        "ms_per_iter": 1e3 * float(np.mean(walls)) if walls else None,
        "ms_per_iter_after_first": (1e3 * float(np.mean(walls[1:]))
                                    if len(walls) > 1 else None),
        "comm_bytes_per_iter": (float(np.mean([c["bytes"] for c in comm]))
                                if comm else 0.0),
        "collective_ms_per_iter": (1e3 * float(np.mean(
            [c["seconds"] for c in comm])) if comm else 0.0),
        "collective_calls_per_iter": (float(np.mean(
            [c["calls"] for c in comm])) if comm else 0.0),
        "evals": evals,
        "model_sha": hashlib.sha256(text.encode()).hexdigest(),
        "psum_wire": g._grower_cfg.psum_wire if g._grower_cfg.quant_psum
        else "f32",
        "psum_slots": g._grower_cfg.psum_slots,
    }
    return g, res


def _load_run(spec: Dict, run: Dict, data: Dict, device) -> Dict:
    """A ``load`` run: this rank's set through the distributed loader
    (round-robin rows, mappers agreed over the group)."""
    from ..config import Config
    from ..io.dataset import Metadata
    from ..io.distributed import DistributedLoader
    cfg = Config().set(_params(spec, run))
    ds = DistributedLoader(cfg, device=device).load_rank_matrix(
        data["X"], Metadata(label=data["y"]),
        contiguous=bool(run.get("contiguous")))
    return {"name": run.get("name", "load"), "num_data": ds.num_data,
            "feature_info": [m.feature_info() for m in ds.mappers]}


def run_worker(spec: Dict) -> Dict:
    """One rank's whole life: join, then each run of the spec (one by
    default), the results written to ``spec['out'] + '.rank<r>'``."""
    import torch

    from ..config import Config
    t0 = time.monotonic()
    base = Config().set(_params(spec))
    device = spec.get("device", "cuda")
    multi = cluster.initialize_from_config(base, device)
    device = cluster.rank_device(device, cluster.rank())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    data = _load_data(spec)
    hook, setup = _hook(spec), _hook(spec, "setup")
    out = str(spec.get("out", "") or "")
    my_out = f"{out}.rank{cluster.rank()}" if out else ""
    results = {"rank": cluster.rank(), "world": cluster.world(),
               "backend": cluster.backend(), "device": str(device),
               "peer_lost": False, "runs": []}

    def survivor_exit(err: cluster.PeerLostError):
        log.warning("%s", err)
        if my_out:
            _write_json(my_out, {**results, "peer_lost": True,
                                 "dead_ranks": err.ranks, "error": str(err),
                                 "wall_s": time.monotonic() - t0})
        cluster.exit_peer_lost(err, "training")

    try:
        with cluster.DeadlineGuard(what="distributed training step",
                                   on_stall=survivor_exit):
            for run in spec.get("runs") or [{"name": "run"}]:
                run_data = (_load_data({"data": run["data"]})
                            if run.get("data") else data)
                if run.get("kind") == "load":
                    results["runs"].append(_load_run(spec, run, run_data,
                                                     device))
                    continue
                if setup is not None:
                    setup(run, cluster.rank())
                g, res = _train_run(spec, run, run_data, device)
                if hook is not None:
                    res.update(hook(g, run, spec, cluster.rank()) or {})
                results["runs"].append(res)
                del g
                cluster.tick(f"after run {res['name']}")
                cluster.barrier(f"run-{res['name']}")
    except BaseException as e:          # noqa: BLE001 — classified below
        named = cluster.explain_collective_error(e, what="training")
        if named is not None:
            survivor_exit(named)
        raise
    results["wall_s"] = time.monotonic() - t0
    if device.type == "cuda":
        results["peak_device_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    if my_out:
        _write_json(my_out, results)
    cluster.barrier("elastic-train-done")
    if multi:
        cluster.shutdown()
    return results


def worker_main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="distributed worker (one rank)")
    ap.add_argument("--spec", required=True, help="spec JSON path")
    args = ap.parse_args(argv)
    with open(args.spec) as fh:
        spec = json.load(fh)
    run_worker(spec)
    return 0


# -- the launcher -------------------------------------------------------------


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def launch_workers(spec_path: str, world: int, *, port: Optional[int] = None,
                   fault_rank: Optional[int] = None, faults: str = "",
                   log_dir: str = "", env: Optional[Dict] = None
                   ) -> List[subprocess.Popen]:
    """Start ``world`` worker processes over a fresh localhost
    coordinator port, each in a new interpreter; the fault spec is armed
    on ``fault_rank`` only. ``env`` adds to every worker's environment
    (``OMP_NUM_THREADS`` and the like)."""
    port = port or _free_port()
    procs = []
    for r in range(world):
        e = dict(os.environ)
        e.update(env or {})
        e[cluster.ENV_COORDINATOR] = f"localhost:{port}"
        e[cluster.ENV_NUM_MACHINES] = str(world)
        e[cluster.ENV_MACHINE_RANK] = str(r)
        e["PYTHONPATH"] = _repo_root() + os.pathsep + e.get("PYTHONPATH", "")
        # a fault plan of the parent's must not reach every worker
        e.pop("LGBM_TPU_FAULTS", None)
        if faults and r == fault_rank:
            e["LGBM_TPU_FAULTS"] = faults
        stdout = None
        if log_dir:
            stdout = open(os.path.join(log_dir, f"worker{r}.log"), "w")
        try:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lightgbm_tpu_torch.parallel.elastic",
                 "--spec", spec_path],
                cwd=_repo_root(), env=e, stdout=stdout,
                stderr=subprocess.STDOUT if stdout else None))
        finally:
            if stdout is not None:
                stdout.close()
    return procs


def wait_workers(procs: List[subprocess.Popen],
                 timeout_s: float = 600.0) -> List[int]:
    """Join every worker; their return codes (negative: a signal). A
    worker past the timeout is killed and reported as -9."""
    deadline = time.monotonic() + timeout_s
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(deadline - time.monotonic(),
                                            1.0)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(-9)
    return codes


def worker_tails(workdir: str, world: int, nbytes: int = 3000) -> str:
    parts = []
    for r in range(world):
        path = os.path.join(workdir, f"worker{r}.log")
        try:
            with open(path, "rb") as fh:
                fh.seek(0, 2)
                fh.seek(max(fh.tell() - nbytes, 0))
                parts.append(f"--- worker {r} ---\n"
                             + fh.read().decode(errors="replace"))
        except OSError:
            parts.append(f"--- worker {r}: no log ---")
    return "\n".join(parts)


def run_world(workdir: str, spec: Dict, world: int, *,
              timeout_s: float = 600.0, env: Optional[Dict] = None,
              fault_rank: Optional[int] = None, faults: str = "") -> Dict:
    """Write ``spec`` (its ``out`` and ``dump_dir`` set under
    ``workdir``), run ``world`` ranks on it and wait: {codes, results
    (None for a rank that wrote none), texts: run -> [text a rank]}."""
    os.makedirs(workdir, exist_ok=True)
    spec = {**spec, "out": os.path.join(workdir, "result.json"),
            "dump_dir": workdir}
    spec_path = os.path.join(workdir, "spec.json")
    _write_json(spec_path, spec)
    procs = launch_workers(spec_path, world, log_dir=workdir, env=env,
                           fault_rank=fault_rank, faults=faults)
    codes = wait_workers(procs, timeout_s)
    results, texts = [], {}
    for r in range(world):
        try:
            with open(f"{spec['out']}.rank{r}") as fh:
                results.append(json.load(fh))
        except OSError:
            results.append(None)
    for run in spec.get("runs") or [{"name": "run"}]:
        name = run.get("name", "run")
        texts[name] = []
        for r in range(world):
            try:
                with open(os.path.join(workdir, f"{name}.rank{r}.txt")) as fh:
                    texts[name].append(fh.read())
            except OSError:
                texts[name].append(None)
    return {"codes": codes, "results": results, "texts": texts,
            "logs": worker_tails(workdir, world) if any(codes) else ""}


def run_two_process(workdir: str, *, n: int = 1024, iterations: int = 4,
                    seed: int = 0, extra_params: Optional[Dict] = None,
                    device: str = "cuda:0", timeout_s: float = 420.0) -> Dict:
    """The smoke: a small synthetic workload (the drill set) across 2
    ranks, on the card by default (the ranks share ``cuda:0`` over
    gloo); both must finish and agree on the model."""
    out = run_world(workdir, {
        "seed": seed, "n": n, "f": DRILL_F, "device": device,
        "params": {**(extra_params or {}), "num_iterations": iterations}},
        2, timeout_s=timeout_s)
    if any(out["codes"]):
        raise RuntimeError(f"two-process smoke failed: rc={out['codes']}\n"
                           f"{out['logs']}")
    shas = [r["runs"][0]["model_sha"] for r in out["results"]]
    if shas[0] != shas[1]:
        raise RuntimeError(f"ranks disagree on the trained model: {shas}")
    return out


if __name__ == "__main__":
    sys.exit(worker_main())
