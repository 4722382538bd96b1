"""The distributed runtime of the port on the CPU: the cluster's no-hang
guarantees (lightgbm_tpu_torch/parallel/cluster.py), the sharded half of
the ingest (io/ingest.py), the distributed loader's rules against the
JAX package's (io/distributed.py), the collective rules
(ops/autotune.py) and the network C entries (capi.py).

- ``explain_collective_error`` names the rank the heartbeat probe finds
  dead for gloo's and NCCL's error strings and leaves other errors alone;
  a barrier alone is a no-op; ``DeadlineGuard`` fires on a stall and
  names the rank.
- Two real ranks (gloo), rank 1 killed by SIGKILL at its third
  iteration: the survivor exits with ``EXIT_PEER_LOST`` (17) within a
  short ``tpu_collective_timeout_s``, its log naming rank 1 in one line.
- The sharded-ingest geometry: ``host_row_block``'s blocks tile the rows
  for every world size, each block a run of ``shard_width`` rows; the
  sharded binners give the same bins as the whole matrix's columns.
- The loader's row and query assignment and its mapper agreement equal
  the JAX package's (emulated ranks in one process).
"""
import os

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.parallel import cluster, elastic

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("msg", [
    "[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection "
    "closed by peer [127.0.0.1]:41423",
    "[../third_party/gloo/gloo/transport/tcp/pair.cc:598] Read error "
    "[127.0.0.1]:31415: Connection reset by peer",
    "NCCL error in: ProcessGroupNCCL.cpp:1970, remote process exited or "
    "there was a network error",
    "Timed out waiting 10000ms for recv operation to complete",
])
def test_explain_collective_error_names_the_dead_rank(msg):
    err = cluster.explain_collective_error(RuntimeError(msg),
                                           what="psum", probe=lambda: [1])
    assert isinstance(err, cluster.PeerLostError)
    assert err.ranks == [1]
    assert "rank 1" in str(err) and "\n" not in str(err)
    # the store unreachable: rank 0, which hosts it, is the suspect
    err = cluster.explain_collective_error(RuntimeError(msg),
                                           probe=lambda: None)
    assert err.ranks == [0]


def test_peer_lost_advice_follows_the_checkpoints():
    """A resume is advised only where the run writes checkpoints."""
    def msg():
        return str(cluster.explain_collective_error(
            RuntimeError("Connection reset by peer"), probe=lambda: [1]))
    try:
        cluster.note_checkpoints("/ckpt/run7")
        assert "resume from the latest checkpoint in /ckpt/run7" in msg()
        cluster.note_checkpoints("")
        assert "restart the run" in msg() and "resume" not in msg()
    finally:
        cluster.note_checkpoints("")


def test_explain_collective_error_leaves_bugs_alone():
    assert cluster.explain_collective_error(
        ValueError("shapes (3,) and (4,) not aligned"),
        probe=lambda: [1]) is None


def test_single_process_barrier_and_topology():
    assert not cluster.is_multiprocess()
    cluster.barrier("alone", timeout_s=0.01)      # a no-op
    assert cluster.probe_dead_ranks(0.0) == []
    assert cluster.fetch(torch.arange(3)).tolist() == [0, 1, 2]
    assert cluster.row_counts(5) == [5]


def test_topology_from_the_environment(monkeypatch):
    from lightgbm_tpu_torch.config import Config
    cfg = Config().set({"tpu_num_machines": 2, "tpu_machine_rank": 0,
                        "tpu_coordinator": "localhost:1"})
    assert cluster._resolve_topology(cfg) == (2, 0, "localhost:1")
    monkeypatch.setenv(cluster.ENV_MACHINE_RANK, "1")
    monkeypatch.setenv(cluster.ENV_COORDINATOR, "localhost:2")
    assert cluster._resolve_topology(cfg) == (2, 1, "localhost:2")
    monkeypatch.setenv(cluster.ENV_MACHINE_RANK, "")   # empty: the knob
    assert cluster._resolve_topology(cfg)[1] == 0
    # alone, nothing is joined
    assert not cluster.initialize_from_config(Config())


@pytest.mark.parametrize("device,world,backend", [
    ("cpu", 2, "gloo"), ("cuda:0", 2, "gloo"), (None, 4, "gloo")])
def test_backend_follows_the_topology(device, world, backend):
    # without a card a rank each (or on this host, without any card),
    # gloo; NCCL only for "cuda" with a card a rank
    assert cluster.choose_backend(device, world) == backend


def test_deadline_guard_fires_and_names_the_rank():
    fired = []
    guard = cluster.DeadlineGuard(deadline=0.2, what="test collective",
                                  on_stall=fired.append,
                                  probe=lambda: [1], poll_s=0.02)
    with guard:
        cluster.tick("iteration 3")
        for _ in range(100):
            if fired:
                break
            import time
            time.sleep(0.02)
    assert guard.fired and fired
    assert fired[0].ranks == [1]
    assert "rank 1" in str(fired[0]) and "iteration 3" in str(fired[0])


def test_deadline_guard_waits_while_peers_live():
    fired = []
    with cluster.DeadlineGuard(deadline=0.05, on_stall=fired.append,
                               probe=lambda: [], poll_s=0.01) as guard:
        cluster.tick("slow step")
        import time
        time.sleep(0.2)
    assert not guard.fired and not fired


def test_killed_peer_survivor_exits_17_naming_it(tmp_path):
    """Rank 1 SIGKILLs itself at its third iteration (utils/faults.py
    ``train.iter@3:kill``); rank 0 exits 17 with one line naming rank
    1, well inside its 8 s collective deadline."""
    import time
    t0 = time.monotonic()
    out = elastic.run_world(str(tmp_path), {
        "seed": 1, "n": 1500, "f": 6, "device": "cpu",
        "params": {"num_iterations": 8, "tpu_quantized_hist": False,
                   "tpu_collective_timeout_s": 8}},
        2, env={"OMP_NUM_THREADS": "1"}, timeout_s=120, fault_rank=1,
        faults="train.iter@3:kill")
    wall = time.monotonic() - t0
    assert out["codes"][1] == -9
    assert out["codes"][0] == cluster.EXIT_PEER_LOST
    assert wall < 60
    res = out["results"][0]
    assert res["peer_lost"] and res["dead_ranks"] == [1]
    with open(os.path.join(tmp_path, "worker0.log")) as fh:
        lines = [ln for ln in fh if "unresponsive" in ln]
    assert len(lines) == 1 and "rank 1" in lines[0]
    # the run writes no checkpoint: no resume is advised
    assert "restart the run" in lines[0] and "resume" not in lines[0]


def test_two_process_smoke_agrees(tmp_path):
    """``elastic.run_two_process`` (the drill set, data learner, int8)
    on two CPU ranks: both finish and write the same model."""
    out = elastic.run_two_process(str(tmp_path), n=768, iterations=3,
                                  device="cpu", timeout_s=120)
    assert out["codes"] == [0, 0]
    assert [r["runs"][0]["learner_mode"] for r in out["results"]] == \
        ["data", "data"]


# -- the sharded ingest ------------------------------------------------------


@pytest.mark.parametrize("n", [1, 999, 2003, 300_000])
def test_host_row_blocks_tile_the_rows(n):
    from lightgbm_tpu_torch.io import ingest
    for D in (1, 2, 3, 4, 8):
        S = ingest.shard_width(n, D)
        blocks = [ingest.host_row_block(n, D, r) for r in range(D)]
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        for (lo, hi, s), (lo2, _, _) in zip(blocks, blocks[1:]):
            # a full block, or the short (or empty) tail at n
            assert s == S and hi == lo2 and (hi - lo == S or hi == n)
        assert all(hi - lo <= S for lo, hi, _ in blocks)
        # the alignment unit depends on n and D only through n >= 4 D u:
        # a power of two (or 1) dividing S
        u = S & -S
        assert S % u == 0 and (S == -(-n // D) or u & (u - 1) == 0)


def test_shard_width_matches_the_jax_package():
    from lightgbm_tpu.io import ingest as jingest
    from lightgbm_tpu_torch.io import ingest
    for n in (1, 999, 2003, 65_536, 300_000, 1_000_000):
        for D in (1, 2, 4, 8):
            assert ingest.shard_width(n, D) == jingest.shard_width(n, D)


def test_sharded_binners_equal_the_whole_matrix():
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io import ingest
    from lightgbm_tpu_torch.io.dataset import (BinnedDataset, Metadata,
                                               find_column_mappers)
    r = np.random.default_rng(4)
    X = r.normal(size=(3001, 5))
    X[::7, 2] = np.nan
    cfg = Config().set({"max_bin": 63, "tpu_ingest": 1,
                        "tpu_ingest_chunk_rows": 256})
    mappers = find_column_mappers(X, cfg)
    ds = BinnedDataset(cfg, "cpu").construct_from_matrix(
        X, Metadata(label=np.zeros(3001)), mappers=mappers)
    whole = ds.bins_t
    binner = ingest.DeviceBinner(ds.mappers, ds.used_feature_map, cfg,
                                 X.dtype, "cpu")
    for D in (2, 3):
        for rank in range(D):
            lo, hi, _ = ingest.host_row_block(3001, D, rank)
            assert torch.equal(ingest.bin_matrix_sharded(binner, X, lo, hi),
                               whole[:, lo:hi])
            # the rank's own rows, with some before its block
            start = max(lo - 10, 0)
            assert torch.equal(ingest.bin_matrix_multihost(
                binner, X[start:hi], start, lo, hi), whole[:, lo:hi])
            stream = ingest.start_sharded_stream(binner, 3001, lo, hi)
            for b in range(0, 3001, 700):
                stream.feed(X[b:b + 700])
            assert torch.equal(stream.finish(), whole[:, lo:hi])
            sharded = BinnedDataset(cfg, "cpu").construct_from_matrix(
                X, Metadata(label=np.zeros(3001)), mappers=mappers,
                row_block=(lo, hi))
            assert sharded.num_data == 3001
            assert torch.equal(sharded.bins_t, whole[:, lo:hi])
    with pytest.raises(ValueError):
        ingest.bin_matrix_multihost(binner, X[10:], 10, 0, 100)


# -- the loader's rules against the JAX package's ---------------------------


def test_rank_rows_and_metadata_match_the_jax_package():
    from lightgbm_tpu.io import distributed as jd
    from lightgbm_tpu.io.dataset import Metadata as JMeta
    from lightgbm_tpu_torch.io import distributed as td
    from lightgbm_tpu_torch.io.dataset import Metadata
    r = np.random.default_rng(2)
    group = r.integers(1, 9, size=40)
    n = int(group.sum())
    label = r.normal(size=n).astype(np.float32)
    isc = r.normal(size=3 * n)
    qb = np.concatenate([[0], np.cumsum(group)])
    for world in (1, 3, 4, 50):
        for mode in ("round_robin", "contiguous"):
            for rank in range(world):
                a = td._rank_rows(n, rank, world, qb, mode)
                np.testing.assert_array_equal(
                    a, jd._rank_rows(n, rank, world, qb, mode))
                np.testing.assert_array_equal(
                    td._rank_rows(n, rank, world, None, mode),
                    jd._rank_rows(n, rank, world, None, mode))
                tm = td._slice_metadata(
                    Metadata(label=label, init_score=isc, group=group), a, n,
                    rank, world, mode)
                jm = jd._slice_metadata(
                    JMeta(label=label, init_score=isc, group=group), a, n,
                    rank, world, mode)
                np.testing.assert_array_equal(tm.label, jm.label)
                np.testing.assert_array_equal(tm.init_score, jm.init_score)
                np.testing.assert_array_equal(tm.query_boundaries,
                                              jm.query_boundaries)


@pytest.mark.parametrize("n,world", [(2000, 4), (2001, 4), (999, 3)])
def test_emulated_loader_agrees_with_the_jax_package(n, world):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Metadata as JMeta
    from lightgbm_tpu.io.distributed import DistributedLoader as JLoader
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.io.distributed import (DistributedLoader,
                                                   local_bin_mappers,
                                                   shard_bin_mappers)
    r = np.random.default_rng(n)
    X = r.normal(size=(n, 6))
    X[:, 1] = np.round(X[:, 1] * 2)
    y = (X[:, 0] > 0).astype(np.float32)
    params = {"objective": "binary", "max_bin": 63, "min_data_in_leaf": 20}
    cfg, jcfg = Config().set(params), JConfig().set(params)
    infos = []
    for rank in range(world):
        ds = DistributedLoader(cfg, world=world, rank=rank,
                               device="cpu").load_rank_matrix(
            X, Metadata(label=y))
        jds = JLoader(jcfg, world=world, rank=rank).load_rank_matrix(
            X, JMeta(label=y))
        info = [m.feature_info() for m in ds.mappers]
        assert info == [m.feature_info() for m in jds.mappers]
        assert ds.num_data == jds.num_data
        infos.append(info)
    assert all(i == infos[0] for i in infos)
    shards = [X[np.arange(k, n, world)] for k in range(world)]
    agreed = shard_bin_mappers([local_bin_mappers(s, cfg, (), n)
                                for s in shards])
    assert [m.feature_info() for m in agreed
            if not m.is_trivial] == infos[0]


# -- the collective rules and the C entries ---------------------------------


def test_collective_rules_match_the_jax_package():
    from lightgbm_tpu.ops import autotune as ja
    from lightgbm_tpu_torch.ops import autotune as ta
    for n in (1, 100, 258, 259, 10_000, 16_909_320):
        for req in (-1, 0, 1):
            assert ta.tune_psum_wire(n_rows_global=n, requested=req) == \
                ja.tune_psum_wire(n_rows_global=n, requested=req)
    assert ta.tune_psum_wire(n_rows_global=258) == "int16"
    assert ta.tune_psum_wire(n_rows_global=259) == "int32"
    # the int32 wire holds below 127 N < 2^31 on every device here
    assert ta.tune_hist_psum(world=2, W=8, F=4, B=16, channels=3,
                             n_rows_global=16_909_320)
    assert not ta.tune_hist_psum(world=2, W=8, F=4, B=16, channels=3,
                                 n_rows_global=16_909_321, requested=1)
    assert not ta.tune_hist_psum(world=2, W=8, F=4, B=16, channels=3,
                                 n_rows_global=100, requested=0)
    # auto keeps one slot: two are two blocking calls in turn here
    assert ta.tune_hist_psum_async(F=10) == 1
    assert ta.tune_hist_psum_async(F=10, requested=1) == 2
    assert ta.tune_hist_psum_async(F=10, requested=0) == 1
    assert ta.tune_hist_psum_async(F=1, requested=1) == 1
    assert ta.measure_psum_s((4, 4), torch.float32) == 0.0     # alone


def test_network_c_entries():
    from lightgbm_tpu_torch import capi
    from lightgbm_tpu_torch.parallel import learners
    assert capi.LGBM_NetworkInit("127.0.0.1:12400", 12400, 120, 2) == 0
    assert capi.LGBM_NetworkInitWithFunctions(
        2, 0, reduce_scatter_fn=lambda x, d: d(x)) == 0
    assert "reduce_scatter" in learners._collective_overrides
    assert capi.LGBM_NetworkFree() == 0
    assert not learners._collective_overrides
