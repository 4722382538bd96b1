"""Cluster bootstrap and collective robustness for multi-process
training on ``torch.distributed``.

The JAX package's ``parallel/cluster.py``. There one program spans the
processes' devices through ``jax.distributed``; here each rank is one OS
process (parallel/learners.py) and this module joins them into one
process group: the analog of the reference's socket linkers
(src/network/linkers_socket.cpp: TCP bootstrap, rank/world handshake,
``time_out``-bounded waits that name the machine that never answered).

**Bootstrap** (``initialize_from_config``): ``tpu_num_machines``,
``tpu_machine_rank`` and ``tpu_coordinator`` (``host:port``, rank 0's
address), with the environment twins ``LGBM_TPU_NUM_MACHINES``,
``LGBM_TPU_MACHINE_RANK`` and ``LGBM_TPU_COORDINATOR`` that a launcher
sets per process (a set, non-empty variable wins). Rank 0 hosts a
``TCPStore`` at the coordinator; the connection is retried through
utils/retry.py while the coordinator is still binding its port. The
backend follows the topology, once, at bootstrap (``choose_backend``):
NCCL only when each rank has a card of its own, gloo when ranks share a
card or run on the CPU (NCCL refuses two ranks on one device). It is
logged once and never swapped after a failure: a rank whose collective
fails is lost, not re-wired.

**Liveness and the no-hang guarantee** (``tpu_collective_timeout_s``):
each rank publishes a heartbeat sequence into the store every
``HEARTBEAT_S``; ``probe_dead_ranks`` compares two snapshots of the
sequences (progress, never wall clocks: a peer on a skewed clock still
advances). ``barrier`` raises ``PeerLostError`` naming the ranks that
never arrived; ``explain_collective_error`` maps gloo's and NCCL's error
strings to a ``PeerLostError`` naming the ranks the probe finds dead;
``DeadlineGuard`` turns a collective that blocks instead of failing
into one warning line naming the rank, a flight dump (obs/flight.py)
and ``os._exit(EXIT_PEER_LOST)``.

**Host arrays.** ``fetch`` gathers a row-sharded tensor (each rank's
contiguous block) to every rank. The JAX package's ``host_to_global``
and ``local_shards_to_global`` build JAX global arrays from host values
or per-device shards; a rank here owns plain tensors on its own device,
so they have no counterpart: a rank slices its block of a host array
itself (io/ingest.py ``host_row_block``).

The autoscale signal's keys (``post_scale_signal``, ``poll_scale_signal``,
``clear_scale_signal``) live in the same store; the autoscale controller
that reads them is the elastic drill's (not ported yet, ROADMAP item
19). Nothing here touches ``torch.distributed`` when imported.
"""
from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from ..utils import log

ENV_COORDINATOR = "LGBM_TPU_COORDINATOR"
ENV_NUM_MACHINES = "LGBM_TPU_NUM_MACHINES"
ENV_MACHINE_RANK = "LGBM_TPU_MACHINE_RANK"
ENV_TARGET_WORLD = "LGBM_TPU_TARGET_WORLD"

# the exit code of "peer lost, resume me elsewhere": distinct from crash
# codes, so a launcher tells a preemption casualty from a bug
EXIT_PEER_LOST = 17

_HB_PREFIX = "lgbm_tpu/hb/"
HEARTBEAT_S = 0.5
# a live rank publishes every HEARTBEAT_S, so 2.5 intervals show progress
# with a full cycle of slack
_PROBE_WAIT_S = 2.5 * HEARTBEAT_S
_ELASTIC_KEY = "lgbm_tpu/elastic/target_world"

# the marks of a peer or wire failure in gloo's, NCCL's and the store's
# error strings
PEER_MARKERS = (
    "Connection reset", "Connection refused", "Connection closed",
    "Socket closed", "Broken pipe", "Gloo", "gloo", "NCCL", "nccl",
    "Timed out", "timed out", "Timeout", "DEADLINE_EXCEEDED",
    "Read error", "Write error", "EOF", "peer")


class PeerLostError(RuntimeError):
    """A peer process is unresponsive or dead; ``ranks`` names the
    suspects (empty when none could be named). The message is the one
    actionable line the no-hang guarantee promises."""

    def __init__(self, msg: str, ranks: List[int] = ()):  # noqa: B006
        super().__init__(msg)
        self.ranks = list(ranks)


_lock = threading.Lock()
_state: Dict = {
    "initialized": False,   # this module made the process group
    "world": 1,
    "rank": 0,
    "coordinator": "",
    "backend": "",
    "deadline_s": 60.0,
    "store": None,
    "hb_thread": None,
    "hb_stop": None,
    "tick": None,           # (label, monotonic stamp) of the last progress
    "checkpoint_dir": "",   # where this run writes its checkpoints, if any
}


def note_checkpoints(directory: str) -> None:
    """Record where this run's checkpoints go ("" for none), so that a
    peer-lost message points to a resume only where one can happen."""
    _state["checkpoint_dir"] = str(directory or "")


def _after_loss() -> str:
    """The peer-lost message's advice: resume from this run's
    checkpoints, or restart the run where it writes none."""
    d = _state["checkpoint_dir"]
    if d:
        return (f"resume from the latest checkpoint in {d} "
                f"(tpu_resume_from)")
    return "restart the run (it writes no checkpoint: tpu_checkpoint_dir)"


def world() -> int:
    return _state["world"]


def rank() -> int:
    return _state["rank"]


def is_multiprocess() -> bool:
    """True when this process is one rank of a cluster of several."""
    return _state["world"] > 1


def deadline_s() -> float:
    return _state["deadline_s"]


def backend() -> str:
    """The process group's backend ("gloo" or "nccl"; "" alone)."""
    return _state["backend"]


def _store():
    return _state["store"] if is_multiprocess() else None


def _resolve_topology(config) -> tuple:
    """(world, rank, coordinator) from the knobs, a set non-empty
    environment twin winning (the launcher's per-process ranks)."""
    world_n = int(os.environ.get(ENV_NUM_MACHINES)
                  or getattr(config, "tpu_num_machines", 0) or 0)
    rank_n = int(os.environ.get(ENV_MACHINE_RANK)
                 or getattr(config, "tpu_machine_rank", -1))
    coord = (os.environ.get(ENV_COORDINATOR)
             or str(getattr(config, "tpu_coordinator", "") or ""))
    return world_n, rank_n, coord


def choose_backend(device, world_n: int) -> str:
    """The process group's backend for ranks on ``device``: "nccl" when
    each of the ``world_n`` ranks has a card of its own (``device`` is
    "cuda" with no index, which ``rank_device`` maps to the rank's own
    card, and the host has a card a rank), else "gloo" (ranks sharing
    one card such as "cuda:0", or on the CPU). Under gloo the
    histograms cross the wire through host memory; every kernel still
    runs on the rank's card."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() >= world_n):
        return "nccl"
    return "gloo"


def rank_device(device, rank_n: int):
    """The device rank ``rank_n`` trains on: ``device`` as given, or
    for a bare "cuda" the rank's own card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank_n % max(torch.cuda.device_count(),
                                                 1))
    return dev


def initialize_from_config(config, device=None) -> bool:
    """Join the process group when the config or environment asks for
    several processes; True when this process is (now) one rank of a
    cluster. Idempotent. ``device`` is where this rank trains (it picks
    the backend, ``choose_backend``)."""
    import torch.distributed as dist
    world_n, rank_n, coord = _resolve_topology(config)
    _state["deadline_s"] = float(
        getattr(config, "tpu_collective_timeout_s", 60.0) or 60.0)
    if _state["initialized"]:
        return is_multiprocess()
    if dist.is_available() and dist.is_initialized():
        # a process group someone else made (an embedding application)
        with _lock:
            _state.update(world=dist.get_world_size(),
                          rank=dist.get_rank(),
                          backend=str(dist.get_backend()))
        _set_identity()
        return is_multiprocess()
    if world_n <= 1:
        return False
    if rank_n < 0 or rank_n >= world_n:
        log.fatal(f"tpu_num_machines={world_n} needs tpu_machine_rank in "
                  f"[0, {world_n}) on every process (got {rank_n}); set "
                  f"it per process or export {ENV_MACHINE_RANK}")
    if not coord or ":" not in coord:
        log.fatal(f"tpu_num_machines={world_n} needs a coordinator "
                  f"address: set tpu_coordinator=host:port (or export "
                  f"{ENV_COORDINATOR}), rank 0's address, like the "
                  f"reference's machine_list first entry")
    host, port = coord.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=max(_state["deadline_s"], 1.0))
    chosen = choose_backend(device, world_n)

    from ..utils import retry

    def connect():
        return dist.TCPStore(host, int(port), world_n, rank_n == 0,
                             timeout=timeout, wait_for_workers=False)

    # a coordinator still binding its port refuses the connection: a
    # transient blip, not a config error
    store = retry.call(
        connect, what=f"TCPStore({coord})",
        classify=lambda e: isinstance(e, (ConnectionError, TimeoutError,
                                          RuntimeError)),
        policy=retry.RetryPolicy(
            attempts=max(int(getattr(config, "tpu_retry_attempts", 4)
                             or 4), 1), base_s=0.5, max_s=5.0))
    dist.init_process_group(chosen, store=store, rank=rank_n,
                            world_size=world_n, timeout=timeout)
    with _lock:
        _state.update(initialized=True, world=world_n, rank=rank_n,
                      coordinator=coord, backend=chosen, store=store)
    _set_identity()
    _start_heartbeat()
    log.info("cluster up: rank %d/%d, coordinator %s, backend %s "
             "(%s)", rank_n, world_n, coord, chosen,
             "a card a rank" if chosen == "nccl"
             else "ranks share a card or run on the CPU")
    return True


def _set_identity() -> None:
    from ..obs import identity
    identity.set_topology(rank(), world())


# -- heartbeats and liveness -------------------------------------------------


def _start_heartbeat() -> None:
    """Publish this rank's heartbeat sequence into the store every
    HEARTBEAT_S (``lgbm_tpu/hb/<rank>`` = seq)."""
    store = _store()
    if store is None or _state["hb_thread"] is not None:
        return
    stop = threading.Event()
    me = rank()

    def beat():
        seq = 0
        while not stop.is_set():
            try:
                store.set(f"{_HB_PREFIX}{me}", str(seq))
            except Exception:           # noqa: BLE001 — the store is gone:
                return                  # the collectives will say so
            seq += 1
            stop.wait(HEARTBEAT_S)

    t = threading.Thread(target=beat, name="lgbm-cluster-heartbeat",
                         daemon=True)
    with _lock:
        if _state["hb_thread"] is not None:
            return
        _state.update(hb_thread=t, hb_stop=stop)
    t.start()


def _hb_snapshot(store) -> Optional[Dict[int, int]]:
    """rank -> newest heartbeat sequence; None when the store itself is
    unreachable."""
    out: Dict[int, int] = {}
    try:
        for r in range(world()):
            key = f"{_HB_PREFIX}{r}"
            if store.check([key]):
                out[r] = int(store.get(key))
    except Exception:                   # noqa: BLE001 — store unreachable
        return None
    return out


def probe_dead_ranks(wait_s: Optional[float] = None) -> Optional[List[int]]:
    """Ranks (this one excluded) whose heartbeat sequence makes no
    progress across ``wait_s`` (2.5 publish intervals by default), or
    that never published; None when the store is unreachable (rank 0,
    which hosts it, is then the prime suspect)."""
    store = _store()
    if store is None:
        return []
    first = _hb_snapshot(store)
    if first is None:
        return None
    time.sleep(float(wait_s) if wait_s is not None else _PROBE_WAIT_S)
    second = _hb_snapshot(store)
    if second is None:
        return None
    return [r for r in range(world())
            if r != rank() and second.get(r, -1) <= first.get(r, -1)]


def _rank_list(ranks: List[int]) -> str:
    return ", ".join(f"rank {r}" for r in ranks) or "an unknown rank"


def explain_collective_error(exc: BaseException, what: str = "collective",
                             probe: Optional[Callable] = None
                             ) -> Optional[PeerLostError]:
    """A ``PeerLostError`` naming the dead rank(s) for a failure that
    looks like a peer or wire failure in gloo's, NCCL's or the store's
    words, else None (a real bug keeps its own traceback). ``probe``
    (tests) replaces ``probe_dead_ranks``."""
    if isinstance(exc, PeerLostError):
        return exc
    msg = str(exc)
    if not any(s in msg for s in PEER_MARKERS):
        return None
    dead = (probe or probe_dead_ranks)()
    if dead is None:
        return PeerLostError(
            f"{what} failed and the coordinator is unreachable: rank 0 "
            f"(coordinator {_state['coordinator'] or '?'}) is likely "
            f"dead; restart the cluster and {_after_loss()}", [0])
    return PeerLostError(
        f"{what} failed: {_rank_list(dead)} of {world()} unresponsive "
        f"(peer died or was preempted); surviving ranks should exit and "
        f"{_after_loss()} (original error: "
        f"{msg.splitlines()[0][:200] if msg else type(exc).__name__})",
        dead)


def barrier(name: str, timeout_s: Optional[float] = None) -> None:
    """Every rank meets here within ``timeout_s`` (the collective
    deadline by default), or ``PeerLostError`` names the ranks that never
    arrived; a no-op alone."""
    store = _store()
    if store is None:
        return
    t = float(timeout_s if timeout_s is not None else deadline_s())
    key = f"lgbm_tpu/barrier/{name}"
    end = time.monotonic() + t

    def wait_all(phase: str, what: str) -> None:
        store.set(f"{key}/{phase}/{rank()}", "1")
        while True:
            here = [r for r in range(world())
                    if store.check([f"{key}/{phase}/{r}"])]
            if len(here) == world():
                return
            if time.monotonic() >= end:
                missing = sorted(set(range(world())) - set(here))
                raise PeerLostError(
                    f"barrier {name!r} timed out after {t:.1f}s: "
                    f"{_rank_list(missing)} of {world()} never {what}",
                    missing)
            time.sleep(0.02)

    try:
        wait_all("in", "arrived")
        if rank() == 0:
            # rank 0 hosts the store: it leaves last, so a teardown right
            # after the barrier cannot cut a peer's last poll
            wait_all("out", "left")
        else:
            store.set(f"{key}/out/{rank()}", "1")
    except PeerLostError:
        raise
    except Exception as e:              # noqa: BLE001 — classified below
        named = explain_collective_error(e, what=f"barrier {name!r}")
        if named is not None:
            raise named from e
        raise


# -- the stall watchdog --------------------------------------------------------


def tick(label: str = "") -> None:
    """A progress stamp for ``DeadlineGuard``: the training loop stamps
    every iteration (models/gbdt.py train_one_iter)."""
    _state["tick"] = (label, time.monotonic())


class DeadlineGuard:
    """A watchdog that turns a silent collective hang into a fast, named
    death: while active, a thread checks the time since the last
    ``tick``; a stall past ``deadline`` probes the heartbeats. Every
    peer alive: one warning and it keeps waiting (a slow step is not a
    death). A dead peer (or an unreachable store): one warning line
    naming the rank(s), a flight dump, and ``os._exit(EXIT_PEER_LOST)``.

    ``on_stall`` (tests) replaces the exit with a callback, ``probe``
    (tests) the heartbeat probe. Alone, the guard watches nothing unless
    a probe is given."""

    def __init__(self, deadline: Optional[float] = None,
                 what: str = "training collective",
                 on_stall: Optional[Callable] = None,
                 probe: Optional[Callable] = None, poll_s: float = 0.25):
        self.deadline = float(deadline if deadline is not None
                              else deadline_s())
        self.what = what
        self.on_stall = on_stall
        self.probe = probe
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def __enter__(self):
        if not is_multiprocess() and self.probe is None:
            return self
        tick("guard-start")
        self._thread = threading.Thread(target=self._watch,
                                        name="lgbm-deadline-guard",
                                        daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        return False

    def _watch(self):
        while not self._stop.wait(self.poll_s):
            last = _state.get("tick")
            if last is None:
                continue
            stalled = time.monotonic() - last[1]
            if stalled < self.deadline:
                continue
            dead = (self.probe or probe_dead_ranks)()
            if dead == []:
                log.warning("%s stalled for %.1fs at %s but every peer is "
                            "alive (heartbeats advancing); waiting on",
                            self.what, stalled, last[0] or "start")
                tick(last[0])
                continue
            self.fired = True
            ranks = [0] if dead is None else dead
            who = (f"the coordinator ({_state['coordinator'] or 'rank 0'})"
                   if dead is None else _rank_list(dead))
            err = PeerLostError(
                f"rank {rank()}: {self.what} stalled for {stalled:.1f}s "
                f"(deadline {self.deadline:.1f}s) at {last[0] or 'start'}: "
                f"{who} unresponsive; exiting: {_after_loss()}", ranks)
            log.warning("%s", err)
            if self.on_stall is not None:
                self.on_stall(err)
                return
            exit_peer_lost(err, self.what, stalled)


def exit_peer_lost(err: PeerLostError, what: str = "training",
                   stalled_s: float = 0.0) -> None:
    """The survivor's exit: a flight dump naming the lost ranks, then
    ``os._exit(EXIT_PEER_LOST)`` (a normal exit would wait on the dead
    peer in the process group's teardown)."""
    try:
        from ..obs import flight
        flight.trigger("peer_lost", {"what": what, "ranks": err.ranks,
                                     "stalled_s": round(stalled_s, 2)},
                       force=True)
    except Exception:                   # noqa: BLE001 — the exit must not
        pass                            # wait on the postmortem
    os._exit(EXIT_PEER_LOST)


# -- the autoscale signal ------------------------------------------------------


def post_scale_signal(target_world: int) -> None:
    """Publish the desired world size into the store (or, alone, the
    environment twin ``LGBM_TPU_TARGET_WORLD``)."""
    store = _store()
    if store is not None:
        store.set(_ELASTIC_KEY, str(int(target_world)))
    else:
        os.environ[ENV_TARGET_WORLD] = str(int(target_world))


def poll_scale_signal() -> Optional[int]:
    """The posted target world size, or None; never blocks."""
    store = _store()
    raw = None
    if store is not None:
        try:
            if store.check([_ELASTIC_KEY]):
                raw = store.get(_ELASTIC_KEY).decode()
        except Exception:               # noqa: BLE001 — no signal
            raw = None
    if raw is None:
        raw = os.environ.get(ENV_TARGET_WORLD)
    try:
        target = int(str(raw))
    except (TypeError, ValueError):
        return None
    return target if target >= 1 else None


def clear_scale_signal() -> None:
    """Retire a consumed signal."""
    store = _store()
    if store is not None:
        try:
            store.delete_key(_ELASTIC_KEY)
        except Exception:               # noqa: BLE001 — already gone
            pass
    os.environ.pop(ENV_TARGET_WORLD, None)


# -- row-sharded tensors -----------------------------------------------------


def row_counts(n_local: int) -> List[int]:
    """Every rank's row count, in rank order (``[n_local]`` alone)."""
    if not is_multiprocess():
        return [int(n_local)]
    import torch.distributed as dist
    t = torch.tensor([int(n_local)], dtype=torch.int64)
    out = [torch.zeros(1, dtype=torch.int64) for _ in range(world())]
    dist.all_gather(out, t)
    return [int(x) for x in out]


def fetch(t: torch.Tensor, counts: Optional[List[int]] = None
          ) -> torch.Tensor:
    """A row-sharded tensor [..., n_local] (each rank's contiguous block
    of the last axis, in rank order) gathered to every rank as [..., n]
    on ``t``'s device; ``t`` itself alone. ``counts``: every rank's
    n_local when known (else one more gather learns them)."""
    if not is_multiprocess():
        return t
    import torch.distributed as dist
    counts = counts or row_counts(t.shape[-1])
    width = max(counts)
    host = t.detach().to("cpu")
    if host.shape[-1] < width:
        host = torch.cat([host, host.new_zeros(
            host.shape[:-1] + (width - host.shape[-1],))], dim=-1)
    host = host.contiguous()
    out = [torch.empty_like(host) for _ in range(world())]
    dist.all_gather(out, host)
    full = torch.cat([o[..., :c] for o, c in zip(out, counts)], dim=-1)
    return full.to(t.device)


def gather_object(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order; ``[obj]`` alone."""
    if not is_multiprocess():
        return [obj]
    import torch.distributed as dist
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def shutdown() -> None:
    """Orderly teardown after a successful run (a peer already lost
    exits through ``exit_peer_lost`` instead)."""
    stop = _state.get("hb_stop")
    if stop is not None:
        stop.set()
    if _state["initialized"]:
        import torch.distributed as dist
        try:
            dist.destroy_process_group()
        except Exception as e:          # noqa: BLE001 — teardown only
            log.warning("destroy_process_group: %s", e)
        with _lock:
            _state.update(initialized=False, world=1, rank=0, backend="",
                          store=None, hb_thread=None, hb_stop=None)
        _set_identity()
