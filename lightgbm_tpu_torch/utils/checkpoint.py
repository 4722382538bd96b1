"""Resumable training checkpoints: the model text PLUS the state the
model text lacks.

The JAX package's ``utils/checkpoint.py``, its single-process half. The
``snapshot_freq`` model snapshots are *predict*-grade: restarting from
one loses the bagging RNG stream and the early-stopping bookkeeping, so
the restarted run diverges from the run that died. A *checkpoint
bundle* captures everything the training loops need to continue
**bit-identically** (tests/test_torch_checkpoint.py; chip_smoke.py
phase 27 on the card, after a SIGKILL):

- the serialized model text (the device TreeRecords are rebuilt from
  it on resume, as ``GBDT.init_from_loaded`` does);
- the live train/valid SCORE BUFFERS, verbatim, in a compressed
  ``.scores.npz`` sidecar: a replay of the saved trees would round each
  update again (the forward step's fused multiply-add rounds once), and
  an ulp in the scores becomes a different later tree;
- every host RNG stream: bagging, feature fraction, GOSS's hook and
  DART's drop (numpy PCG64 ``bit_generator.state`` dicts, plain ints,
  JSON-safe);
- the *current* bagging mask (``bagging_freq > 1`` reuses one draw for
  several iterations; a resume inside the window must reuse it);
- the CLI driver's early-stopping bookkeeping (best score, iteration and
  message per metric, ``GBDT.train``);
- DART's tree weights and live shrinkage;
- the training config fingerprint (a mismatch is a refusal with an
  actionable message, not a silent divergence) and the bin mappers'
  fingerprint.

Format: the JAX package's, so a bundle written by either package
resumes in the other: one versioned JSON document per
``ckpt_iter_<N>.json`` plus a ``ckpt_iter_<N>.scores.npz`` sidecar,
both written via ``utils/fileio.atomic_write``, sidecar FIRST and
bundle second, so the bundle is the commit point, and pruned to the
last ``tpu_snapshot_keep``. Readers check schema and version first and
refuse a future or corrupt layout with a one-line error naming the file,
what is malformed and the expected version. ``tpu_ckpt_async`` (-1, the
default, or 1) hands the file writes to a background writer
(``AsyncCheckpointWriter``).

A JAX bundle's score buffers may be wider than the rows (its compiled
step pads rows to a bucket): the real rows are taken verbatim when the
bundle's ``world.n_real`` is the resuming set's row count. Left out
until ROADMAP item 19 (distributed): the re-shard onto another world
size and the multi-process gather; a bundle written by more than one
process is refused, never resumed approximately.

This module is a *friend* of models/gbdt.py: it reaches into the
booster's private training state deliberately, so the whole gather /
apply inventory lives in one reviewable place.
"""
from __future__ import annotations

import base64
import glob
import hashlib
import json
import os
import re
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from . import faults, log
from .fileio import atomic_write, prune_numbered

CHECKPOINT_SCHEMA = "lightgbm-tpu/checkpoint"
CHECKPOINT_VERSION = 1

_CKPT_RE = re.compile(r"ckpt_iter_(\d+)\.json$")

# config fields excluded from the resume fingerprint: paths, telemetry,
# the fault-tolerance knobs themselves, cluster topology, transport and
# serving knobs; none shapes the training math, and a resumed run must
# be free to redirect its artifacts (or extend num_iterations). The JAX
# package's list, kept identical so that both packages compute one
# fingerprint for one config
VOLATILE_KNOBS = frozenset({
    "config", "data", "valid", "task", "num_iterations",
    "output_model", "snapshot_freq", "input_model", "output_result",
    "verbosity",
    "tpu_run_report", "tpu_trace", "tpu_trace_buffer",
    "tpu_metrics_export", "tpu_metrics_interval_s", "tpu_metrics_port",
    "tpu_profile_dir", "tpu_profile_iters", "tpu_watchdog_factor",
    "tpu_autotune", "tpu_tuning_cache", "tpu_compile_cache",
    "tpu_checkpoint_dir", "tpu_checkpoint_freq", "tpu_snapshot_keep",
    "tpu_resume_from", "tpu_faults", "tpu_fault_seed",
    "tpu_retry_attempts",
    "tpu_reqlog", "tpu_reqlog_sample", "tpu_slo", "tpu_flight_buffer",
    "tpu_flight_dir", "tpu_cluster_obs",
    "num_machines", "tpu_num_machines", "tpu_machine_rank",
    "tpu_coordinator", "tpu_collective_timeout_s",
    "tpu_psum_wire", "tpu_async_psum", "tpu_ckpt_async",
    "tpu_fleet_port", "tpu_fleet_coalesce_us", "tpu_fleet_max_batch",
    "tpu_fleet_queue", "tpu_fleet_slo_p99_ms", "tpu_fleet_shed_budget",
})


def config_fingerprint(config) -> str:
    """Short sha256 over the training-relevant config fields (sorted
    ``name=value`` lines, VOLATILE_KNOBS excluded)."""
    import dataclasses
    lines = []
    for f in sorted(dataclasses.fields(config), key=lambda f: f.name):
        if f.name in VOLATILE_KNOBS or f.name.startswith("_"):
            continue
        v = getattr(config, f.name)
        if isinstance(v, list):
            v = ",".join(str(x) for x in v)
        lines.append(f"{f.name}={v}")
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def checkpoint_path(directory: str, iteration: int) -> str:
    return os.path.join(directory, f"ckpt_iter_{int(iteration)}.json")


def scores_path(bundle_path: str) -> str:
    """The score-buffer sidecar next to a bundle path."""
    return bundle_path[: -len(".json")] + ".scores.npz" \
        if bundle_path.endswith(".json") else bundle_path + ".scores.npz"


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """(iteration, path) pairs under ``directory``, newest first.
    The directory is caller data — escaped, so a path containing
    glob metacharacters still lists its own checkpoints."""
    out = []
    for p in glob.glob(os.path.join(glob.escape(directory),
                                    "ckpt_iter_*.json")):
        m = _CKPT_RE.search(os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out, reverse=True)


def prune_checkpoints(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` checkpoints, sidecars
    included (best-effort; utils/fileio.prune_numbered — the same
    helper the model-snapshot prune uses). Orphan sidecars — a crash
    between the sidecar write and the bundle commit leaves a
    ``.scores.npz`` with no bundle — are swept too: they are multi-MB
    and no bundle will ever claim their iteration number again."""
    prune_numbered(os.path.join(directory, ""), "ckpt_iter_*.json",
                   r"ckpt_iter_(\d+)\.json$", keep,
                   companions=lambda p: [scores_path(p)])
    for p in glob.glob(os.path.join(glob.escape(directory),
                                    "ckpt_iter_*.scores.npz")):
        if not os.path.isfile(p[: -len(".scores.npz")] + ".json"):
            try:
                os.unlink(p)
            except OSError:
                pass


def mapper_fingerprint(mappers) -> str:
    """Short sha256 over the serialized bin mappers: restore refuses a
    dataset binned differently from the checkpointed run (the device
    TreeRecords are rebuilt from model text THROUGH the resuming
    dataset's mappers, so silently different boundaries would shift
    every restored threshold)."""
    blob = json.dumps([m.to_dict() for m in mappers], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def mappers_from_bundle(bundle: dict):
    """The checkpointed run's bin mappers as a FULL per-real-column
    list (trivial placeholders on unused columns): how a resume can
    reconstruct the EXACT binning of the original run. None when the
    bundle predates the mapper record."""
    rec = bundle.get("mappers")
    if not rec:
        return None
    from ..io.binning import BinMapper
    used = [int(j) for j in rec["used"]]
    full = [BinMapper() for _ in range(int(rec["num_total_features"]))]
    for j, d in zip(used, rec["mappers"]):
        full[j] = BinMapper.from_dict(d)
    return full


# -- state gather/apply (the GBDT-private inventory) -------------------------

def _rng_state(gen) -> Optional[dict]:
    """numpy Generator -> its bit_generator state dict (JSON-safe
    ints), or None for absent generators."""
    if gen is None or not hasattr(gen, "bit_generator"):
        return None
    return gen.bit_generator.state


def _set_rng_state(gen, state) -> None:
    if gen is not None and state is not None \
            and hasattr(gen, "bit_generator"):
        gen.bit_generator.state = state


def _pack_mask(mask) -> Optional[dict]:
    """0/1 float mask -> {n, b64-packed-bits}; None passes through."""
    if mask is None:
        return None
    m = np.asarray(mask)
    return {"n": int(m.shape[0]),
            "bits": base64.b64encode(
                np.packbits(m > 0.5).tobytes()).decode()}


def _unpack_mask(rec) -> Optional[np.ndarray]:
    if rec is None:
        return None
    n = int(rec["n"])
    bits = np.frombuffer(base64.b64decode(rec["bits"]), np.uint8)
    return np.unpackbits(bits)[:n].astype(np.float32)


def gather_state(booster) -> dict:
    """Everything past the model text that a bit-identical resume
    needs (see the module docstring for the inventory), in the JAX
    package's layout."""
    state = {
        "rng": {
            "bagging": _rng_state(getattr(booster, "_bagging_rng",
                                          None)),
            "feature": _rng_state(getattr(booster, "_feature_rng",
                                          None)),
            "hook": _rng_state(getattr(booster, "_hook_rng", None)),
            "drop": _rng_state(getattr(booster, "_drop_rng", None)),
        },
        "bag_cache": _pack_mask(getattr(booster, "_bag_cache", None)),
        "shrinkage_rate": float(booster.shrinkage_rate),
        "boost_from_avg_done": [],
        "best_score": getattr(booster, "_best_score", None),
        "best_iter": getattr(booster, "_best_iter", None),
        "best_msg": getattr(booster, "_best_msg", None),
        "eval_history": [],
    }
    if hasattr(booster, "_tree_weight"):        # DART
        state["dart"] = {
            "tree_weight": [float(w) for w in booster._tree_weight],
            "sum_weight": float(booster._sum_weight),
        }
    return state


def apply_state(booster, state: dict) -> None:
    """``gather_state``'s inverse on an ``init()``-ed booster. The JAX
    package's ``boost_from_avg_done`` and ``eval_history`` have no
    counterpart here: the port boosts from the average only while the
    model is empty, and its drivers keep no eval history."""
    rng = state.get("rng", {})
    _set_rng_state(getattr(booster, "_bagging_rng", None),
                   rng.get("bagging"))
    _set_rng_state(getattr(booster, "_feature_rng", None),
                   rng.get("feature"))
    _set_rng_state(getattr(booster, "_hook_rng", None), rng.get("hook"))
    _set_rng_state(getattr(booster, "_drop_rng", None), rng.get("drop"))
    mask = _unpack_mask(state.get("bag_cache"))
    if mask is not None:
        booster._bag_cache = mask
    booster.shrinkage_rate = float(state.get(
        "shrinkage_rate", booster.shrinkage_rate))
    for attr in ("best_score", "best_iter", "best_msg"):
        if state.get(attr) is not None:
            setattr(booster, "_" + attr, state[attr])
    dart = state.get("dart")
    if dart is not None and hasattr(booster, "_tree_weight"):
        booster._tree_weight = list(dart["tree_weight"])
        booster._sum_weight = float(dart["sum_weight"])


def _geometry_summary(booster) -> dict:
    """The grower geometry this booster trains under: diagnostics, not
    a resume precondition."""
    gcfg = getattr(booster, "_grower_cfg", None)
    return {
        "n_score": int(booster._scores.shape[1]),
        "n_total": int(getattr(booster, "_n_total", 0)),
        "num_bins": int(gcfg.num_bins) if gcfg else None,
        "wave_size": int(gcfg.wave_size) if gcfg else None,
        "device": str(booster.device),
    }


# -- bundle IO ---------------------------------------------------------------

def _commit_bundle(directory: str, path: str, arrays: dict,
                   bundle: dict, keep: int) -> str:
    """The write phase: scores sidecar FIRST, bundle second (the bundle
    is the commit point), prune, count. Runs on the caller's thread for
    synchronous checkpoints and on the AsyncCheckpointWriter thread for
    background ones; the commit-point order is the same either way."""
    with atomic_write(scores_path(path), mode="wb") as fh:
        np.savez_compressed(fh, **arrays)
    with atomic_write(path) as fh:
        json.dump(bundle, fh)
    prune_checkpoints(directory, keep)
    from ..obs import registry as obs
    obs.counter("checkpoint/writes").add(1)
    log.info("checkpoint written: %s (iteration %d, keep %d)",
             path, int(bundle["iteration"]), keep)
    return path


class AsyncCheckpointWriter:
    """Bounded-queue background writer for checkpoint bundles
    (``tpu_ckpt_async``): the score download and the bundle's
    construction stay on the training thread (``save_checkpoint``); only
    the serialization and the atomic file writes run here, off the
    critical path.

    - commit-point ordering: jobs run strictly in submission order on
      ONE thread, and each job writes sidecar-then-bundle via
      atomic_write, so a crash (even SIGKILL mid-write) never leaves a
      torn bundle and the newest complete bundle is always a valid
      restart point;
    - ``checkpoint/write_failures``: a failed background write warns
      and counts, as the synchronous path does; training never stops
      for a full disk;
    - a full queue drops the OLDEST not-yet-started job (the newer
      checkpoint supersedes it) instead of blocking the training thread.

    ``drain()`` runs at train end and before any resume read
    (``resolve_resume`` calls ``drain_writers()`` itself).
    """

    def __init__(self, maxsize: int = 2):
        import collections
        import threading
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._jobs: "collections.deque" = \
            collections.deque()        # guarded-by: _lock
        self._maxsize = max(int(maxsize), 1)
        self._busy = False             # guarded-by: _lock
        self._closed = False           # guarded-by: _lock
        self._failures = 0             # guarded-by: _lock
        self._write_s = 0.0            # guarded-by: _lock
        self._thread = threading.Thread(
            target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, directory: str, path: str, arrays: dict,
               bundle: dict, keep: int) -> bool:
        """Enqueue one write job; never blocks on a slow disk."""
        from ..obs import registry as obs
        with self._lock:
            if self._closed:
                return False
            if len(self._jobs) >= self._maxsize:
                dropped = self._jobs.popleft()
                log.debug("checkpoint writer queue full: dropping "
                          "queued write %s (superseded by %s)",
                          dropped[1], path)
            self._jobs.append((directory, path, arrays, bundle, keep))
            obs.gauge("ckpt/queue_depth").set(len(self._jobs))
            self._wake.notify_all()
        return True

    def _run(self) -> None:
        from ..obs import registry as obs
        while True:
            with self._lock:
                while not self._jobs and not self._closed:
                    self._wake.wait()
                if not self._jobs and self._closed:
                    return
                job = self._jobs.popleft()
                self._busy = True
                obs.gauge("ckpt/queue_depth").set(len(self._jobs))
            t0 = time.monotonic()
            committed = False
            try:
                _commit_bundle(job[0], job[1], job[2], job[3], job[4])
                committed = True
            except Exception as e:       # same downgrade as the sync
                # path's caller: warn + count, never stop training
                obs.counter("checkpoint/write_failures").add(1)
                log.warning("background checkpoint write failed "
                            "(training continues): %s", e)
                with self._lock:
                    self._failures += 1
            finally:
                dt = time.monotonic() - t0
                obs.counter("ckpt/hidden_s").add(dt)
                if committed:
                    # the off-thread commit on the trace timeline, where
                    # it landed among the iterations it hid behind
                    from ..obs import trace as obs_trace
                    obs_trace.instant(
                        "ckpt/async_commit", cat="ckpt",
                        args={"path": job[1],
                              "iteration": job[3].get("iteration"),
                              "write_s": round(dt, 6)})
                with self._lock:
                    self._busy = False
                    self._write_s += dt
                    self._wake.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted job has committed (or failed).
        True = drained; False = timed out with work still pending."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._lock:
            while self._jobs or self._busy:
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._wake.wait(rem)
        return True

    def close(self, timeout: Optional[float] = None) -> bool:
        """Drain, then stop the thread. Safe to call twice."""
        ok = self.drain(timeout)
        with self._lock:
            self._closed = True
            self._wake.notify_all()
        self._thread.join(timeout)
        return ok and not self._thread.is_alive()

    @property
    def failures(self) -> int:
        with self._lock:
            return self._failures

    @property
    def write_seconds(self) -> float:
        """Total seconds of write work hidden from the training path."""
        with self._lock:
            return self._write_s


# every live writer, so resolve_resume can drain pending writes it did
# not create (a resume may read a directory another booster in this
# process is still writing to)
_writers: List[AsyncCheckpointWriter] = []   # guarded-by: _writers_lock
_writers_lock = threading.Lock()


def new_writer(maxsize: int = 2) -> AsyncCheckpointWriter:
    w = AsyncCheckpointWriter(maxsize=maxsize)
    with _writers_lock:
        _writers.append(w)
    return w


def drain_writers(timeout: Optional[float] = None) -> None:
    """Drain every live background writer: at train end and before any
    resume read, so a resume never races a pending write."""
    with _writers_lock:
        ws = list(_writers)
    for w in ws:
        w.drain(timeout)


def save_checkpoint(booster, directory: str, keep: int = 3,
                    writer: Optional[AsyncCheckpointWriter] = None,
                    ) -> Optional[str]:
    """Write ``ckpt_iter_<N>.scores.npz`` then ``ckpt_iter_<N>.json``
    (the bundle is the commit point) and prune to ``keep``; returns the
    bundle path. Raises on failure: the caller (the training loop)
    downgrades that to a warning so a full disk never takes training
    down, and the atomic writes keep the previous complete checkpoint.
    With ``writer`` the file writes are handed to the background writer
    thread; the score download and the bundle's construction happen
    here, a consistent view of the booster's mutable state."""
    it = booster.current_iteration
    path = checkpoint_path(directory, it)
    faults.check("checkpoint.write", context=f"iteration {it}")
    arrays = {"scores": booster._scores.cpu().numpy()}
    for vi, vs in enumerate(booster._valid_scores):
        arrays[f"valid_{vi}"] = vs.cpu().numpy()
    td = booster.train_data
    bundle = {
        "schema": CHECKPOINT_SCHEMA,
        "version": CHECKPOINT_VERSION,
        "created_unix": round(time.time(), 3),
        "iteration": int(it),
        "config_hash": config_fingerprint(booster.config),
        "parameters": booster.config.to_string(),
        "geometry": _geometry_summary(booster),
        # the writer's world: one process here (ROADMAP item 19 brings
        # the multi-process gather); the score buffers are the real
        # rows, so n_score == n_real
        "world": {
            "processes": 1,
            "devices": 1,
            "n_real": int(booster._n),
            "n_score": int(booster._scores.shape[1]),
            "valid_n_real": [int(v.num_data) for v in
                             getattr(booster, "valid_sets", [])],
        },
        "state": gather_state(booster),
        # the run's bin mappers: restore refuses a dataset binned
        # differently (see mapper_fingerprint)
        "mappers": {
            "used": [int(j) for j in td.used_feature_map],
            "num_total_features": int(td.num_total_features),
            "mappers": [m.to_dict() for m in td.mappers],
            "hash": mapper_fingerprint(td.mappers),
        },
        "scores_file": os.path.basename(scores_path(path)),
        "model": booster.model_to_string(),
    }
    # who wrote the bundle (obs/identity.py): postmortem provenance, not
    # part of the resume fingerprint
    from ..obs import identity
    bundle["identity"] = identity.identity()
    if writer is not None:
        writer.submit(directory, path, arrays, bundle, keep)
        return path
    return _commit_bundle(directory, path, arrays, bundle, keep)


def load_checkpoint(path: str) -> dict:
    """Parse and validate one checkpoint bundle. Every failure is a
    one-line ValueError naming the file, what is malformed, and the
    version this reader expects, never a deep parse traceback."""
    try:
        with open(path) as fh:
            bundle = json.load(fh)
    except OSError as e:
        raise ValueError(f"{path}: cannot read checkpoint ({e})") from e
    except json.JSONDecodeError as e:
        raise ValueError(
            f"{path}: corrupt checkpoint (truncated or not JSON: {e}); "
            f"expected schema {CHECKPOINT_SCHEMA} v{CHECKPOINT_VERSION}"
        ) from e
    if not isinstance(bundle, dict):
        raise ValueError(f"{path}: not a checkpoint bundle (top level "
                         f"is {type(bundle).__name__}, expected an "
                         f"object)")
    if bundle.get("schema") != CHECKPOINT_SCHEMA:
        raise ValueError(f"{path}: not a checkpoint bundle "
                         f"(schema={bundle.get('schema')!r}; expected "
                         f"{CHECKPOINT_SCHEMA})")
    if bundle.get("version") != CHECKPOINT_VERSION:
        raise ValueError(
            f"{path}: checkpoint version {bundle.get('version')!r}, "
            f"this reader wants {CHECKPOINT_VERSION} — refusing to "
            f"misread a different layout")
    for key in ("iteration", "model", "state", "config_hash",
                "scores_file"):
        if key not in bundle:
            raise ValueError(f"{path}: malformed checkpoint (missing "
                             f"{key!r}); expected schema "
                             f"{CHECKPOINT_SCHEMA} v{CHECKPOINT_VERSION}")
    sidecar = os.path.join(os.path.dirname(os.path.abspath(path)),
                           str(bundle["scores_file"]))
    if not os.path.isfile(sidecar):
        raise ValueError(f"{path}: score sidecar "
                         f"{bundle['scores_file']!r} is missing next to "
                         f"the bundle (partial copy? crash between "
                         f"writes?)")
    bundle["_scores_path"] = sidecar
    return bundle


def resolve_resume(path_or_dir: str) -> dict:
    """A checkpoint file loads directly; a directory resolves to its
    NEWEST valid checkpoint (corrupt or newer-layout bundles are skipped
    with a warning: a crash mid-write plus atomic_write means the newest
    complete one is the right restart point). Pending background writes
    are drained FIRST, so a resume in the same process never reads past
    a checkpoint still in a writer queue."""
    drain_writers()
    if os.path.isdir(path_or_dir):
        entries = list_checkpoints(path_or_dir)
        if not entries:
            raise ValueError(f"{path_or_dir}: no ckpt_iter_*.json "
                             f"checkpoints to resume from")
        errors = []
        for it, p in entries:
            try:
                return load_checkpoint(p)
            except ValueError as e:
                errors.append(str(e))
                log.warning("skipping unusable checkpoint: %s", e)
        raise ValueError(f"{path_or_dir}: no usable checkpoint "
                         f"({'; '.join(errors)})")
    return load_checkpoint(path_or_dir)


def _real_rows(arr: np.ndarray, want: tuple, n_real: int, name: str,
               spath: str) -> np.ndarray:
    """A saved [K, width] score buffer as this run's [K, n] one: the
    same shape verbatim; a wider buffer of the same real rows (the JAX
    package pads its rows to a bucket) cut to them; anything else
    refused."""
    if tuple(arr.shape) == want:
        return arr
    if (n_real == want[1] and arr.ndim == 2 and arr.shape[0] == want[0]
            and arr.shape[1] >= n_real):
        return np.ascontiguousarray(arr[:, :n_real])
    raise ValueError(
        f"{spath}: {name} score shape {tuple(arr.shape)} "
        f"(real rows {n_real}) does not match this run's {want}; the same "
        f"data and valid sets are required to resume")


def restore(booster, bundle: dict) -> int:
    """Apply a loaded bundle to an ``init()``-ed booster: refuse a
    config or mapper mismatch and a bundle of more than one process,
    rebuild the device TreeRecords from the model text, load the
    train/valid score buffers VERBATIM from the sidecar (the bit-identity
    guarantee, see the module docstring), then restore the host-side
    state. Returns the iteration to continue from."""
    import torch

    from ..models.gbdt import GBDT
    from ..models.tree import record_arrays_from_tree
    from ..ops.grower import TreeRecord

    want = config_fingerprint(booster.config)
    have = bundle.get("config_hash")
    if have != want:
        raise ValueError(
            f"checkpoint was written under a different training config "
            f"(hash {have} vs this run's {want}); resume requires "
            f"identical training parameters — diff the checkpoint's "
            f"'parameters' block against your run, or point "
            f"tpu_checkpoint_dir at a fresh directory to start over")
    wrec = bundle.get("world") or {}
    procs = int(wrec.get("processes", 1) or 1)
    if procs > 1:
        raise ValueError(
            f"checkpoint was written by a {procs}-process run; this "
            f"package resumes single-process bundles only (the "
            f"multi-process gather and re-shard are ROADMAP item 19)")
    mrec = bundle.get("mappers")
    if mrec and mrec.get("hash"):
        have_h = mapper_fingerprint(booster.train_data.mappers)
        if have_h != mrec["hash"]:
            raise ValueError(
                f"checkpoint was binned with different bin mappers "
                f"(hash {mrec['hash']} vs this dataset's {have_h}) — "
                f"restored tree thresholds would shift; construct the "
                f"resuming dataset with the checkpoint's mappers "
                f"(utils/checkpoint.mappers_from_bundle)")
    scratch = GBDT(device="cpu")
    scratch.load_model_from_string(bundle["model"],
                                   source="checkpoint model text")
    loaded = scratch.models
    K = booster.num_tree_per_iteration
    if scratch.num_tree_per_iteration != K:
        raise ValueError(
            f"checkpoint num_tree_per_iteration="
            f"{scratch.num_tree_per_iteration} does not match this "
            f"run's {K} (num_class/objective changed?)")

    # score buffers: the live device state, not a replay
    spath = bundle.get("_scores_path") or bundle.get("scores_file")
    try:
        with np.load(spath) as z:
            scores = z["scores"]
            valids = [z[f"valid_{vi}"] for vi in
                      range(len(booster._valid_scores))]
    except (OSError, KeyError, ValueError) as e:
        raise ValueError(f"{spath}: unusable score sidecar "
                         f"({type(e).__name__}: {e})") from e
    scores = _real_rows(scores, tuple(booster._scores.shape),
                        int(wrec.get("n_real", 0) or 0), "train", spath)
    vreal = [int(x) for x in wrec.get("valid_n_real", [])]
    valids = [_real_rows(v, tuple(booster._valid_scores[vi].shape),
                         vreal[vi] if vi < len(vreal) else 0,
                         f"valid_{vi}", spath)
              for vi, v in enumerate(valids)]

    L = booster._grower_cfg.num_leaves
    td = booster.train_data
    dev = booster.device
    booster.models = list(loaded)
    booster.records = []
    booster._tree_shrinkage = [m.shrinkage if m.shrinkage else 1.0
                               for m in loaded]
    for tree in loaded:
        arrs = record_arrays_from_tree(tree, td.real_to_inner,
                                       td.mappers, L)
        booster.records.append(TreeRecord(**{
            k: int(v) if k == "num_leaves"
            else torch.from_numpy(v).to(dev) for k, v in arrs.items()}))
    booster._scores = torch.from_numpy(
        np.ascontiguousarray(scores, np.float32)).to(dev)
    booster._valid_scores = [torch.from_numpy(
        np.ascontiguousarray(v, np.float32)).to(dev) for v in valids]
    booster.iter_ = len(loaded) // K
    booster._invalidate_stacked()
    apply_state(booster, bundle.get("state", {}))
    log.info("resumed from checkpoint at iteration %d (%d trees, "
             "config hash %s)", booster.iter_, len(loaded), want)
    return booster.iter_
