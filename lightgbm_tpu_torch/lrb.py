"""Windowed cache-admission training driver (the fork's application),
on the card.

The JAX package's ``lrb.py``, ported (reference: src/test.cpp:39-341): a
learning-relaxed-Belady loop that, per fixed-size window of (id, size,
cost) cache requests,

1. labels each request by an OPT-like volume ranking (calculateOPT,
   test.cpp:97-121): requests whose next-use volume fits the cache's
   byte-window budget get toCache = 1;
2. derives features (deriveFeatures, test.cpp:124-208): up to 50
   inter-arrival gaps, log2 object size, log2 available cache bytes,
   and the request cost;
3. trains a FRESH booster on the window's sample with the fork's fixed
   parameter set (trainModel, test.cpp:240-298), through the port's C
   API on the driver's device (the histogram kernels K1 and K2 and the
   score update K3);
4. evaluates the previous booster on the next window in micro-batches
   of ``serve_batch`` rows through ``LGBM_BoosterPredictForMat`` (the
   forest kernel K4), reporting false-positive / false-negative rates
   at ``cutoff`` plus the OPT object/byte hit ratios (evaluateModel,
   test.cpp:210-238).

Pipelined retrain-while-serve (``tpu_lrb_pipeline``, default on): window
K's training runs on a trainer thread while the main thread keeps
ingesting window K+1's requests, OPT-labeling them and deriving their
features, and window K's evaluation runs on a server thread; the
finished model is published with an atomic swap (pre-warmed through
``GBDT.prepare_serving``), and a failed/degraded window publishes
nothing: serving continues on the previous model. The trainer is joined
at the next window boundary BEFORE that window's evaluation, so
per-window results are field-for-field identical to the sequential
loop. Both threads launch on the device's default stream: the card runs
their kernels one after another, so the pipeline overlaps host work,
not kernels. The per-request hot loops (feature derivation's gap walk,
the OPT admission scan) are vectorized group-by-object numpy; the
scalar reference transliterations are kept as ``*_scalar`` test
oracles.

Where the port differs from the JAX driver:

- ``device``: where each window trains and serves (None: ``cuda:0``,
  raising at the first window's training when there is no card;
  ``"cpu"`` runs the plain PyTorch path, as the tests do).
- No device ingest chunk ring: ``tpu_lrb_ring`` is accepted and does
  nothing. The JAX ring keeps a window's chunks resident so that its
  fixed compiled chunk shape's pad rows are not sent again; the port's
  binner compiles no shape and sends no pad rows, so a ring would save
  no bytes on the wire. A port of it, measured on an H100, moved the
  same bytes with it and without, and no allocation retries, while it
  held its slots resident for the loop's lifetime (PERF.md, the ingest
  rows).
- The training-step registry (``ops/step_cache.py``) holds captured
  CUDA graphs of the waves, not compiled programs: a window's record
  carries ``step_cache_hits`` as the JAX driver's does (a later window's
  booster replays the graphs an earlier one captured), and ``compile_s``
  is the nvcc time the window paid building the kernels
  (``utils/cuda_build.py``, 0 once they are built) plus the seconds it
  spent capturing wave graphs.
- ``serve_daemon=True`` (``--serve-daemon``) scores every window
  through the fleet scoring daemon (serve/) over localhost HTTP, as the
  JAX driver does; the daemon runs on the driver's ``device``. The
  daemon serves its newest version, so in the pipelined loop a window's
  evaluation can move to the model trained on that same window once it
  is published (as in the JAX driver); the sequential loop's records
  equal the in-process loop's.

Run: ``python -m lightgbm_tpu_torch.lrb <trace> <cacheSize> <windowSize>
<sampleSize> <cutoff> <sampling> [result_file]``, the same argv as the
reference binary. ``trace`` rows: ``seq id size cost`` (or
``id size cost``; a synthetic trace generator is included for testing).
"""
from __future__ import annotations

import concurrent.futures
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import capi
from .analysis import lockorder
from .obs import export as obs_export
from .obs import flight as obs_flight
from .obs import registry as obs
from .obs import reqlog
from .obs import slo as obs_slo
from .obs import trace
from .ops import step_cache
from .utils import cuda_build, faults, log, retry
from .utils.device import resolve_device

HISTFEATURES = 50            # test.cpp:16
NUM_FEATURES = HISTFEATURES + 3

TRAIN_PARAMS = {             # test.cpp:67-87
    "boosting": "gbdt",
    "objective": "binary",
    "metric": "binary_logloss,auc",
    "metric_freq": "1",
    "is_provide_training_metric": "true",
    "max_bin": "255",
    "num_iterations": "50",
    "learning_rate": "0.1",
    "num_leaves": "31",
    "tree_learner": "serial",
    "feature_fraction": "0.8",
    "bagging_freq": "5",
    "bagging_fraction": "0.8",
    "min_data_in_leaf": "50",
    "min_sum_hessian_in_leaf": "5.0",
    "verbose": "-1",
}


class WindowBudgetExceeded(RuntimeError):
    """A window's training ran past the per-window wall budget — the
    degrade path treats it like any other window-train failure
    (serving continues on the previous model), and retry classifies
    it non-transient (re-running the same window would blow the same
    budget)."""


def _degrade_label(reason: Optional[str]) -> str:
    """Classify a degrade reason string into a small stable label set
    — the ``lrb/degraded_reason/<label>`` counter family (bounded
    cardinality; *why*, not just *that*). The raw reason string still
    rides the result record and the wide event."""
    if not reason or reason == "degenerate_labels":
        return "degenerate_labels"
    head = reason.split(":", 1)[0].strip()
    if head == "WindowBudgetExceeded":
        return "budget"
    if head == "InjectedFault":
        return ("injected_fault_transient" if "action=transient" in reason
                else "injected_fault")
    import re as _re
    return _re.sub(r"[^A-Za-z0-9_]", "_", head) or "error"


class Window:
    """One window's trace + OPT bookkeeping (test.cpp globals)."""

    def __init__(self):
        self.ids: List[int] = []
        self.sizes: List[int] = []
        self.costs: List[float] = []
        self.to_cache: Optional[np.ndarray] = None
        self.has_next: List[bool] = []
        self.volume: List[int] = []
        self.byte_sum = 0
        self._feat_ctx = None   # sampling-independent derive arrays


class LrbDriver:
    """The windowed retraining loop (test.cpp:300-341 processRequest),
    pipelined: training runs behind the serving path (see module
    docstring). ``device``: where every window trains and serves (None:
    ``cuda:0``)."""

    def __init__(self, cache_size: int, window_size: int,
                 sample_size: int, cutoff: float, sampling: int,
                 result_file=sys.stdout, seed: int = 0,
                 extra_params: Optional[dict] = None,
                 serve_batch: int = 64,
                 window_budget_s: Optional[float] = None,
                 serve_daemon: bool = False, device=None):
        self.device = device
        self._device = None           # resolved at the first window
        self.cache_size = cache_size
        self.window_size = window_size
        self.sample_size = sample_size
        self.cutoff = cutoff
        self.sampling = sampling
        self.out = result_file
        self.rng = np.random.default_rng(seed)
        # per-window training params: the reference's fixed set plus
        # operator overrides (telemetry knobs, tests); the telemetry
        # daemons start HERE so window spans and live metrics cover the
        # whole loop, not just the boosters
        self.params = dict(TRAIN_PARAMS)
        self.params.update({k: str(v) for k, v in
                            (extra_params or {}).items()})
        trace.ensure_from_config(self.params)
        obs_export.ensure_from_config(self.params)
        # serving observability: request-scoped wide events, the
        # SLO/error-budget engine the exporter evaluates, and the
        # always-on flight recorder, armed HERE so window 1's requests
        # already carry ids and a window-1 failure already dumps a
        # postmortem bundle
        reqlog.ensure_from_config(self.params)
        obs_slo.ensure_from_config(self.params)
        obs_flight.ensure_from_config(self.params)
        # fault-injection drills (idempotent for the same spec)
        if self.params.get("tpu_faults"):
            faults.configure(self.params["tpu_faults"],
                             int(self.params.get("tpu_fault_seed", 0)))
        # driver-OWNED window-wall instrument: this run's quantile
        # summary must not mix in an earlier driver's windows (the
        # process-global twin is cumulative by design, like every
        # registry counter)
        self._wall_hist = obs.latency_histogram(
            "lrb/window_wall_s", obs.MetricsRegistry())
        # serving-path instruments: every evaluation scores the
        # window's requests against the PREVIOUS window's model in
        # micro-batches (padded to serve buckets, ops/predict_cache.py).
        # serve_latency is PER-REQUEST — a k-row micro-batch whose wall
        # is dt contributes k request latencies of dt (every request in
        # it waited the batch out), so p99 means what an operator
        # thinks it means; serve_batch keeps the per-CALL wall.
        # Driver-owned for the same reason as _wall_hist.
        self.serve_batch = max(int(serve_batch), 1)
        self._serve_hist = obs.latency_histogram(
            "lrb/serve_latency_s", obs.MetricsRegistry())
        self._serve_batch_hist = obs.latency_histogram(
            "lrb/serve_batch_s", obs.MetricsRegistry())
        # degrade-don't-die bookkeeping: a window whose training fails
        # (exception, injected fault, or the per-window wall budget)
        # is marked degraded and serving continues on the previous
        # model; the staleness gauge counts windows since the last
        # successful retrain — the number an operator alarms on
        self.window_budget_s = (None if window_budget_s is None
                                else float(window_budget_s))
        self._windows_since_train = 0
        self._trained_window = 0      # index of the serving model's window
        self._retry_policy = retry.RetryPolicy(
            attempts=int(self.params.get("tpu_retry_attempts", 4)),
            seed=seed)
        # retrain-while-serve pipeline (tpu_lrb_pipeline: -1 auto=on /
        # 0 sequential / 1 on): one trainer thread, one window in
        # flight, atomic publish under the swap lock
        self.pipelined = int(self.params.get("tpu_lrb_pipeline",
                                             -1)) != 0
        self._swap_lock = lockorder.named_lock("lrb._swap_lock")
        # serializes the pending-window takeover: results/booster
        # drain from any thread, and two concurrent drains must not
        # both run the join body (double-counted staleness, duplicate
        # result lines)
        self._join_lock = lockorder.named_lock("lrb._join_lock")
        self._serving = None          # guarded-by: _swap_lock
        self._pending: Optional[dict] = None   # guarded-by: _join_lock
        self._executor: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self._eval_executor: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        # test seam for liveness drills: when a test installs an Event
        # as _train_gate, the trainer signals _train_started and parks
        # on the gate — the main thread can then prove serving stays
        # live while a training is provably mid-window
        self._train_gate: Optional[threading.Event] = None
        self._train_started = threading.Event()
        self.window = Window()
        self.last_seen: Dict[Tuple[int, int], int] = {}
        # per-id inter-arrival history carried ACROSS windows is reset
        # with the window in the reference (statistics is local to
        # deriveFeatures) — mirrored here
        self.window_index = 0
        self._results: List[dict] = []
        self.trace_lines_skipped = 0
        # flight-recorder bundles are process-global; remember where the
        # dump list stood at init so ``flight_dumps`` reports only THIS
        # run's bundles
        self._flight_dumps_at_init = len(obs_flight.dump_paths())
        # --serve-daemon: score every window's requests through the
        # fleet scoring daemon (serve/) over localhost HTTP instead of
        # in-process capi predict — each published model is registered
        # as a new version of the one "lrb" tenant (warm atomic swap
        # on the daemon side), on the driver's device. Degrade, don't
        # die: a daemon that cannot bind (or a request that fails past
        # the retry policy) falls back to in-process scoring on the
        # same device.
        self._fleet_daemon = None
        self._fleet_client = None
        self._fleet_warned = 0
        if serve_daemon:
            from .serve import FleetClient
            from .serve.daemon import ScoringDaemon
            try:
                self._fleet_daemon = ScoringDaemon.from_config(
                    self.params, device=self.device).start()
                self._fleet_client = FleetClient(self._fleet_daemon.url)
            except RuntimeError as e:
                log.warning("serve-daemon unavailable (%s); scoring "
                            "in-process", e)

    # -- published-model access ----------------------------------------------

    @property
    def booster(self):
        """The serving model's booster handle (None until a window
        trains successfully). Reading it drains any in-flight window
        training first, so callers always observe the final state of
        every completed window."""
        self.drain()
        with self._swap_lock:
            return self._serving

    @booster.setter
    def booster(self, handle) -> None:
        with self._swap_lock:
            self._serving = handle

    @property
    def results(self) -> List[dict]:
        """Per-window result records; drains the pipeline so the last
        window's training outcome is folded in."""
        self.drain()
        return self._results

    def predict_live(self, X: np.ndarray) -> Optional[np.ndarray]:
        """Score a request batch against the CURRENTLY published model
        — the live serving entry a request stream hits while the
        trainer thread may be mid-window. Thread-safe: the handle is
        snapshotted under the swap lock and a concurrent publish never
        mutates an already-published booster (every window trains a
        fresh one). None before the first successful window.

        Request-scoped (obs/reqlog.py): every call is issued a
        monotonic request id, carried through the predict stack in the
        thread-local context (trace spans and the serve-bucket seam
        tag themselves with it), and closed with ONE wide event."""
        with self._swap_lock:
            h = self._serving
        if h is None:
            return None
        rid = reqlog.next_request_id()
        t0 = time.monotonic()
        with reqlog.request(rid, window=self.window_index) as rctx, \
                trace.span("serve/request", cat="serve",
                           args={"req_id": rid,
                                 "window": self.window_index}):
            out = np.asarray(capi.LGBM_BoosterPredictForMat(
                h, X, predict_type=capi.C_API_PREDICT_NORMAL))
        reqlog.record(
            "request", req_id=rid, path="lrb/live",
            window=self.window_index, rows=int(len(X)),
            latency_ms=round(1e3 * (time.monotonic() - t0), 3),
            # the handle's OWN stamp (_train_model): a mid-window
            # publish serves the new model before _trained_window
            # advances at the boundary join — attribution follows the
            # handle actually scored against
            model_window=getattr(h, "_lrb_window",
                                 self._trained_window),
            serve_bucket=rctx.bucket,
            staleness_windows=self._windows_since_train)
        return out

    def training_in_flight(self) -> bool:
        """True while the trainer thread holds a window (the
        during-retrain tag of the streaming bench)."""
        p = self._pending
        return bool(p is not None and not p["future"].done())

    # -- request ingestion ---------------------------------------------------

    def process_request(self, seq: int, obj_id: int, size: int,
                        cost: float) -> None:
        w = self.window
        idx = (seq - 1) % self.window_size
        key = (obj_id, size)
        if size > 0 and key in self.last_seen:
            prev = self.last_seen[key]
            w.has_next[prev] = True
            w.volume[prev] = (idx - prev) * size
        w.byte_sum += size
        self.last_seen[key] = idx
        w.ids.append(obj_id)
        w.sizes.append(size)
        w.costs.append(cost)
        w.has_next.append(False)
        w.volume.append(np.iinfo(np.int64).max)
        if seq % self.window_size == 0:
            self._process_window()

    def _process_window(self) -> None:
        if self._device is None:
            # the first window's training needs the device: a missing
            # card raises HERE, not inside the degrade path
            self._device = resolve_device(self.device)
        self.window_index += 1
        if self.pipelined:
            self._process_window_pipelined()
        else:
            self._process_window_sequential()
        self.window = Window()
        self.last_seen.clear()

    def _process_window_sequential(self) -> None:
        """The reference's strictly serial boundary: evaluate ->
        derive -> train, everything on the calling thread."""
        t_window = time.monotonic()
        wi = {"window": self.window_index}
        rec = {"window": self.window_index}
        with trace.span("window", cat="window", args=wi):
            self._calculate_opt()
            # per-window phase table: derive / train / evaluate wall
            # seconds land in the results AND as spans on the trace
            # timeline (evaluate derives the NEXT window's features on
            # the previous model — the serving half of the loop)
            if self._serving is not None:
                t0 = time.monotonic()
                with trace.span("lrb/evaluate", cat="window", args=wi):
                    labels, X = self._derive_features(0)
                    rec.update(self._score_window(
                        labels, X, window=self.window_index))
                rec["evaluate_s"] = round(time.monotonic() - t0, 3)
            t0 = time.monotonic()
            with trace.span("lrb/derive", cat="window", args=wi):
                labels, X = self._derive_features(self.sampling)
            rec["derive_s"] = round(time.monotonic() - t0, 3)
            rec["train_rows"] = len(labels)
            with trace.span("lrb/train", cat="window", args=wi):
                stats, handle, reason = self._attempt_window_train(
                    labels, X, self.window_index)
                if handle is not None:
                    self.booster = handle
                    self._daemon_register(handle, self.window_index)
                self._apply_train_outcome(rec, stats, reason)
            rec.update(self._opt_ratios())
        self._results.append(rec)
        self._finish_window(rec, time.monotonic() - t_window)

    def _process_window_pipelined(self) -> None:
        """The retrain-while-serve boundary. Everything that does NOT
        need the incoming model runs while the PREVIOUS window may
        still be training on the trainer thread: OPT labels, the
        train-sample features and the eval batch's features (all
        model-independent). The join lands right before the model
        snapshot, so the snapshot is exactly the model the sequential
        loop would evaluate against; THIS window's training is then
        handed to the trainer and the evaluation — the expensive
        serving loop — runs over the trainer's shoulder against the
        snapshot (a mid-scoring publish of this window's own model
        cannot leak into its evaluation). Field-for-field, the record
        matches the sequential loop's."""
        t_window = time.monotonic()
        wi = {"window": self.window_index}
        rec = {"window": self.window_index}
        with trace.span("window", cat="window", args=wi):
            self._calculate_opt()
            t0 = time.monotonic()
            with trace.span("lrb/derive", cat="window", args=wi):
                labels, X = self._derive_features(self.sampling)
            rec["derive_s"] = round(time.monotonic() - t0, 3)
            ev = None
            ev_derive_s = 0.0
            if self._serving is not None or self._pending is not None:
                # the eval batch's features are model-independent —
                # derive them NOW, over the trainer's shoulder
                t0 = time.monotonic()
                with trace.span("lrb/derive_eval", cat="window",
                                args=wi):
                    ev = self._derive_features(0)
                ev_derive_s = time.monotonic() - t0
            self._join_pending()
            with self._swap_lock:
                h = self._serving       # swap-at-boundary snapshot
            rec["train_rows"] = len(labels)
            rec.update(self._opt_ratios())
            # build the COMPLETE pending record — training future AND
            # eval future — before publishing it: a drain() racing in
            # from another thread (the results/booster properties)
            # between a train-only publish and a later eval attach
            # would join the window without its evaluation and the
            # record would silently lose its fp/fn/serve fields
            pending = self._submit_train(labels, X, rec, t_window)
            try:
                if h is not None and ev is not None:
                    # the evaluation — the expensive serving loop —
                    # runs on its own server thread, concurrent with
                    # BOTH this window's training and the next
                    # window's arrivals; the join-time snapshot pins
                    # the model, so the result is exactly the
                    # sequential loop's
                    pending["eval"] = self._submit_eval(
                        ev, h, ev_derive_s, wi)
            finally:
                # publish even if the eval submit failed — the
                # trainer future must stay joinable
                with self._join_lock:
                    self._pending = pending
        with self._join_lock:
            if self._pending is not None:
                self._pending["boundary_end"] = time.monotonic()
        self._results.append(rec)

    # -- OPT labeling (test.cpp:97-121) --------------------------------------

    def _calculate_opt(self) -> None:
        """Vectorized admission scan: stable argsort by next-use
        volume + exclusive cumsum over the would-be-admitted volumes.
        The scalar loop breaks at the first position whose running
        volume exceeds the budget and only admitted items grow it, so
        (the cumsum being monotone) admission is exactly ``has_next &
        (exclusive_cumsum <= budget)`` — bit-identical to
        ``_calculate_opt_scalar`` (the early cutoff is the mask; no
        per-item Python loop)."""
        w = self.window
        n = len(w.ids)
        volume = np.asarray(w.volume, np.int64)
        has_next = np.asarray(w.has_next, bool)
        sizes = np.asarray(w.sizes, np.int64)
        order = np.argsort(volume, kind="stable")
        cache_volume = self.cache_size * self.window_size
        hn_o = has_next[order]
        vol_o = np.where(hn_o, volume[order], 0)
        cum_before = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(vol_o)[:-1]])
        admit = hn_o & (cum_before <= cache_volume)
        to_cache = np.zeros(n, bool)
        to_cache[order[admit]] = True
        self._opt_hits = int(admit.sum())
        self._opt_byte_hits = int(sizes[order][admit].sum())
        w.to_cache = to_cache
        w._feat_ctx = None          # labels changed: derive ctx stale

    def _calculate_opt_scalar(self) -> None:
        """Reference transliteration (test.cpp:97-121) — kept as the
        bit-parity oracle for ``_calculate_opt``."""
        w = self.window
        n = len(w.ids)
        volume = np.asarray(w.volume, np.int64)
        has_next = np.asarray(w.has_next, bool)
        order = np.argsort(volume, kind="stable")
        cache_volume = self.cache_size * self.window_size
        to_cache = np.zeros(n, bool)
        cur = 0
        self._opt_hits = 0
        self._opt_byte_hits = 0
        sizes = np.asarray(w.sizes, np.int64)
        for i in order:
            if cur > cache_volume:
                break
            if has_next[i]:
                to_cache[i] = True
                self._opt_hits += 1
                self._opt_byte_hits += int(sizes[i])
                cur += int(volume[i])
        w.to_cache = to_cache
        w._feat_ctx = None          # labels changed: derive ctx stale

    def _opt_ratios(self) -> dict:
        w = self.window
        return {
            "opt_obj_hit_ratio": round(self._opt_hits
                                       / self.window_size, 4),
            "opt_byte_hit_ratio": round(self._opt_byte_hits
                                        / max(w.byte_sum, 1), 4),
        }

    # -- feature derivation (test.cpp:124-208) -------------------------------

    def _derive_features(self, sampling: int):
        """Vectorized feature derivation — bit-identical to
        ``_derive_features_scalar`` (the reference transliteration
        below, kept as the test oracle).

        The scalar loop's per-request deque walk is a group-by-object
        gap computation: a stable argsort by object id keeps arrival
        order within each group, so consecutive sorted slots of one
        object give the inter-arrival gaps, and request i's feature j
        is simply the group's (k-j)-th gap (k = i's occurrence index,
        capped at HISTFEATURES most-recent). The cache-occupancy
        column follows from the observation that an object is in
        cache after request r iff to_cache[r]: inserts are 0->1 label
        transitions (debit the size at the transition), evictions are
        1->0 transitions (credit the size recorded at the RUN'S first
        1 — the insertion), and available-bytes is the exclusive
        cumsum of those deltas in arrival order."""
        w = self.window
        n = len(w.ids)
        if n == 0:
            return (np.zeros(0, np.float32),
                    np.zeros((0, NUM_FEATURES), np.float64))
        # sampling flags: ONE rng draw per request in arrival order,
        # exactly the scalar loop's stream (Generator.random(n) is the
        # same double sequence as n scalar draws)
        if sampling == 1:
            flag = np.arange(n) >= (self.window_size - self.sample_size)
        elif sampling == 2:
            flag = self.rng.random(n) < (self.sample_size
                                         / self.window_size)
        else:
            flag = np.ones(n, bool)
        ids, sizes, costs, to_cache, gaps, inv, occ, avail = \
            self._derive_ctx()
        rows_idx = np.flatnonzero(flag)
        s = inv[rows_idx]
        k = np.minimum(occ[s], HISTFEATURES)
        J = np.arange(HISTFEATURES)
        valid = J[None, :] < k[:, None]
        src = np.clip(s[:, None] - J[None, :], 0, n - 1)
        feat = np.zeros((len(rows_idx), NUM_FEATURES), np.float64)
        feat[:, :HISTFEATURES] = np.where(valid, gaps[src], 0)
        feat[:, HISTFEATURES] = np.round(
            100.0 * np.log2(np.maximum(sizes[rows_idx], 1)))
        av = avail[rows_idx]
        feat[:, HISTFEATURES + 1] = np.where(
            av <= 0, 0.0,
            np.round(100.0 * np.log2(np.maximum(av, 1))))
        feat[:, HISTFEATURES + 2] = costs[rows_idx]
        return to_cache[rows_idx].astype(np.float32), feat

    def _derive_ctx(self):
        """The sampling-independent half of feature derivation —
        per-window group/gap/occupancy arrays, computed ONCE per
        window (the boundary derives twice: the training sample and
        the eval batch differ only in the final flag slice).
        Invalidated by ``_calculate_opt`` (labels feed the occupancy
        deltas) and implicitly by the per-boundary Window reset."""
        w = self.window
        ctx = getattr(w, "_feat_ctx", None)
        if ctx is not None:
            return ctx
        n = len(w.ids)
        ids = np.asarray(w.ids, np.int64)
        sizes = np.asarray(w.sizes, np.int64)
        costs = np.asarray(w.costs, np.float64)
        to_cache = np.asarray(w.to_cache, bool)

        order = np.argsort(ids, kind="stable")
        sid = ids[order]
        new_grp = np.concatenate([[True], sid[1:] != sid[:-1]])
        slot = np.arange(n)
        starts = np.flatnonzero(new_grp)
        grp_start = starts[np.cumsum(new_grp) - 1]
        occ = slot - grp_start              # occurrence index k
        # gap at sorted slot s (k >= 1): arrival-index difference of
        # consecutive occurrences of the same object
        gaps = np.zeros(n, np.int64)
        cont = ~new_grp
        gaps[cont] = order[cont] - order[np.flatnonzero(cont) - 1]
        inv = np.empty(n, np.int64)
        inv[order] = slot                   # arrival row -> sorted slot

        # cache-occupancy deltas (see _derive_features docstring); the
        # run-start insert a 1->0 eviction credits is found with a
        # global maximum.accumulate over insert slots — safe across
        # group boundaries because an eviction's own group always
        # contains a nearer insert (prev label 1 needs one)
        lo = to_cache[order]
        prev_l = np.concatenate([[False], lo[:-1]]) & cont
        insert = lo & ~prev_l
        evict = (~lo) & prev_l
        so = sizes[order]
        last_ins = np.maximum.accumulate(np.where(insert, slot, -1))
        delta_o = np.zeros(n, np.int64)
        delta_o[insert] = -so[insert]
        delta_o[evict] = so[last_ins[evict]]
        delta = np.zeros(n, np.int64)
        delta[order] = delta_o
        avail = self.cache_size + np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(delta)[:-1]])
        w._feat_ctx = ctx = (ids, sizes, costs, to_cache, gaps, inv,
                             occ, avail)
        return ctx

    def _derive_features_scalar(self, sampling: int):
        """Reference transliteration (test.cpp:124-208) — kept as the
        bit-parity oracle for the vectorized ``_derive_features``."""
        w = self.window
        n = len(w.ids)
        cache_avail = self.cache_size
        history: Dict[int, deque] = {}
        cache: Dict[int, int] = {}
        labels: List[float] = []
        rows: List[np.ndarray] = []
        for i in range(n):
            q = history.setdefault(w.ids[i], deque())
            if len(q) > HISTFEATURES:
                q.pop()
            flag = True
            if sampling == 1:
                flag = i >= (self.window_size - self.sample_size)
            elif sampling == 2:
                flag = self.rng.random() < self.sample_size \
                    / self.window_size
            if flag:
                labels.append(1.0 if w.to_cache[i] else 0.0)
                feat = np.zeros(NUM_FEATURES, np.float64)
                last = i
                for j, t in enumerate(q):
                    feat[j] = last - t
                    last = t
                feat[HISTFEATURES] = round(
                    100.0 * np.log2(max(w.sizes[i], 1)))
                feat[HISTFEATURES + 1] = (
                    0.0 if cache_avail <= 0
                    else round(100.0 * np.log2(cache_avail)))
                feat[HISTFEATURES + 2] = w.costs[i]
                rows.append(feat)
            # cache-occupancy bookkeeping (test.cpp:180-199)
            oid = w.ids[i]
            if oid not in cache:
                if w.to_cache[i]:
                    cache_avail -= w.sizes[i]
                    cache[oid] = w.sizes[i]
            else:
                if not w.to_cache[i]:
                    cache_avail += cache.pop(oid)
            q.appendleft(i)
        X = (np.stack(rows) if rows
             else np.zeros((0, NUM_FEATURES), np.float64))
        return np.asarray(labels, np.float32), X

    # -- train / evaluate (test.cpp:210-298) ---------------------------------

    def _attempt_window_train(self, labels: np.ndarray, X: np.ndarray,
                              widx: int):
        """Degrade-don't-die attempt at one window's training: a
        transient failure retries with bounded backoff
        (utils/retry.py); a persistent failure — exception, injected
        fault, or the per-window wall budget — is captured as the
        failure reason instead of propagating. Runs on the trainer
        thread in pipelined mode, inline otherwise.

        -> (stats dict or None, fresh booster handle or None, reason).
        """
        out = None
        reason = None
        # ONE deadline for the whole window, shared across transient
        # retries — a fresh clock per attempt would let one window
        # stall the serving loop for attempts x budget
        deadline = (time.monotonic() + self.window_budget_s
                    if self.window_budget_s is not None else None)
        try:
            def attempt():
                faults.check("lrb.window_train",
                             context=f"window {widx}")
                return self._train_model(labels, X, widx, deadline)
            out = retry.call(
                attempt, what=f"lrb window {widx} train",
                policy=self._retry_policy)
        except Exception as e:      # noqa: BLE001 — degrade, don't die
            obs.counter("lrb/windows_failed").add(1)
            reason = f"{type(e).__name__}: {e}"
            log.warning(
                "window %d: training failed (%s); serving continues on "
                "the model from window %d", widx, reason,
                self._trained_window)
        if out is None:
            return None, None, reason
        stats, handle = out
        return stats, handle, None

    def _apply_train_outcome(self, rec: dict, stats: Optional[dict],
                             reason: Optional[str]) -> None:
        """Window-ordered accounting of a training outcome (staleness
        gauge, degrade counters, result fields) — always on the main
        thread, at the point the outcome becomes part of the window's
        record."""
        # the degraded-window rate's denominator, counted BEFORE the
        # degraded counter below: a concurrent reader of num then den
        # never sees a degraded window without its denominator
        obs.counter("lrb/windows_total").add(1)
        if stats is not None:
            self._windows_since_train = 0
            self._trained_window = rec["window"]
            rec.update(stats)
        else:
            if self._serving is not None or self._trained_window:
                self._windows_since_train += 1
            obs.counter("lrb/windows_degraded").add(1)
            rec["degraded"] = True
            rec["degrade_reason"] = reason or "degenerate_labels"
            # WHY, not just THAT: the labeled counter family gives a
            # rate per cause, the wide event the full reason string
            label = _degrade_label(reason)
            rec["degrade_label"] = label
            # bounded-cardinality: label comes from _degrade_label's
            # closed set (budget/injected_fault[_transient]/
            # degenerate_labels) plus exception CLASS names — bounded
            # by the code, not by request data
            obs.counter(f"lrb/degraded_reason/{label}").add(1)
            reqlog.record(
                "degraded_window", window=rec["window"], label=label,
                reason=rec["degrade_reason"],
                staleness_windows=self._windows_since_train)
            # the flight dump captures the failing window's spans and
            # requests NOW
            obs_flight.trigger(
                "degraded_window",
                {"window": rec["window"], "label": label,
                 "reason": rec["degrade_reason"],
                 "staleness_windows": self._windows_since_train})
        obs.gauge("lrb/model_staleness_windows").set(
            self._windows_since_train)
        rec["staleness_windows"] = self._windows_since_train

    # -- the trainer-thread pipeline -----------------------------------------

    def _submit_train(self, labels: np.ndarray, X: np.ndarray,
                      rec: dict, t_window: float) -> dict:
        """Hand one window's training to the trainer thread and
        return the UNPUBLISHED pending record — the boundary attaches
        the eval future and then publishes the complete record to
        ``self._pending`` in one locked write (see
        _process_window_pipelined)."""
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="lrb-trainer")
        self._train_started.clear()
        fut = self._executor.submit(self._train_async, labels, X,
                                    self.window_index)
        return {"window": self.window_index, "future": fut,
                "rec": rec, "t_window": t_window,
                "submit_t": time.monotonic()}

    def _submit_eval(self, ev, handle, ev_derive_s: float, wi: dict):
        """Queue one window's evaluation on the server thread (single
        worker: windows evaluate in order, so the cumulative serve
        histogram reads exactly like the sequential loop's).

        -> future of (eval fields dict, completion monotonic)."""
        if self._eval_executor is None:
            self._eval_executor = \
                concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="lrb-server")
        labels, X = ev

        def eval_job():
            t0 = time.monotonic()
            with trace.span("lrb/evaluate", cat="window", args=wi):
                out = self._score_window(labels, X, handle=handle,
                                         window=wi.get("window"))
            out["evaluate_s"] = round(
                time.monotonic() - t0 + ev_derive_s, 3)
            return out, time.monotonic()

        return self._eval_executor.submit(eval_job)

    def _train_async(self, labels: np.ndarray, X: np.ndarray,
                     widx: int):
        """Trainer-thread body: attempt the window, publish the fresh
        model on success (pre-warmed — see ``_publish``), and NEVER
        raise: every failure is folded into the returned reason so the
        join can only ever degrade the window, not kill the loop.

        -> (stats or None, reason or None, completion monotonic)."""
        try:
            if self._train_gate is not None:        # test seam
                self._train_started.set()
                self._train_gate.wait(timeout=60.0)
            with trace.span("lrb/train", cat="window",
                            args={"window": widx}):
                stats, handle, reason = self._attempt_window_train(
                    labels, X, widx)
                if handle is not None:
                    self._publish(handle, widx)
            return stats, reason, time.monotonic()
        except BaseException as e:  # noqa: BLE001 — the loop must live
            obs.counter("lrb/windows_failed").add(1)
            return None, f"{type(e).__name__}: {e}", time.monotonic()

    def _publish(self, handle, widx: int) -> None:
        """Publish-on-complete atomic model swap. The stacked serving
        path is built (its tables on the device, one warm-up predict of
        a serve batch) BEFORE the swap — on the trainer thread, under
        the booster's own serving lock — so a live request stream never
        pays the new model's cold tail; in-flight ``predict_live``
        readers keep the old handle they snapshotted. A degraded window
        never reaches here: the swap simply does not happen."""
        try:
            handle.gbdt.prepare_serving(warm_rows=self.serve_batch)
        except Exception as e:  # noqa: BLE001 — never drop a good model
            log.warning("window %d: serving warm-up failed (%s); "
                        "publishing cold", widx, e)
        with self._swap_lock:
            self._serving = handle
        obs.counter("lrb/model_swaps").add(1)
        trace.instant("lrb/swap", cat="window", args={"window": widx})
        self._daemon_register(handle, widx)

    def _daemon_register(self, handle, widx: int) -> None:
        """--serve-daemon twin of the in-process swap: republish the
        freshly trained model as the next version of the daemon's
        "lrb" tenant (serve/tenants.py warms it before the atomic
        publish; in-flight daemon requests finish on the old
        version). A failed registration keeps the previous daemon
        version serving — same degrade-don't-die rule as training."""
        if self._fleet_client is None:
            return
        try:
            version = self._fleet_client.register(
                "lrb", capi.LGBM_BoosterSaveModelToString(handle),
                warm_rows=self.serve_batch)
            trace.instant("lrb/daemon_swap", cat="window",
                          args={"window": widx, "version": version})
        except Exception as e:  # noqa: BLE001 — never kill the loop
            # over the serving sidecar; the old version keeps serving
            log.warning("window %d: serve-daemon registration failed "
                        "(%s); daemon serves the previous version",
                        widx, e)

    _FLEET_WARN_CAP = 5

    def _daemon_score(self, Xb: np.ndarray) -> Optional[np.ndarray]:
        """Score one micro-batch through the fleet daemon client
        (--serve-daemon); None when the mode is off or the request
        failed past the client's retry policy — the caller falls back
        to in-process predict for that batch (the same device)."""
        if self._fleet_client is None:
            return None
        try:
            return self._fleet_client.predict("lrb", Xb)
        except Exception as e:  # noqa: BLE001 — a dead sidecar must
            # degrade to in-process scoring, not kill the loop
            self._fleet_warned += 1
            if self._fleet_warned <= self._FLEET_WARN_CAP:
                log.warning("serve-daemon predict failed (%s); scoring "
                            "this batch in-process", e)
            elif self._fleet_warned == self._FLEET_WARN_CAP + 1:
                log.warning("further serve-daemon predict warnings "
                            "suppressed")
            return None

    def _join_pending(self) -> None:
        with self._join_lock:
            self._join_pending_locked()

    # guarded-by: _join_lock (called only from _join_pending's
    # locked region — the checker verifies every call site)
    def _join_pending_locked(self) -> None:
        p = self._pending
        if p is None:
            return
        t_join = time.monotonic()
        with trace.span("lrb/join", cat="window",
                        args={"window": p["window"]}):
            # _pending stays visible while we block here:
            # training_in_flight() must keep answering True to the
            # scorer for a trainer that overran the boundary — those
            # are exactly the during-retrain probes
            stats, reason, t_train = p["future"].result()
            t_done = t_train
            ev_fut = p.get("eval")
            if ev_fut is not None:
                ev_fields, t_eval = ev_fut.result()
                p["rec"].update(ev_fields)
                t_done = max(t_done, t_eval)
        self._pending = None
        rec = p["rec"]
        self._apply_train_outcome(rec, stats, reason)
        # overlap: how long the TRAINING ran while the main thread was
        # doing other work (ingesting/deriving the next window) — the
        # wall the pipeline reclaims vs the sequential loop; the eval
        # thread's tail is deliberately NOT counted here
        overlap = max(0.0, min(t_train, t_join) - p["submit_t"])
        rec["overlap_s"] = round(overlap, 3)
        obs.gauge("lrb/pipeline_overlap_s").set(round(overlap, 6))
        # window span: boundary open -> the LATEST of training
        # completion, evaluation completion and the boundary itself
        self._finish_window(
            rec, max(t_done, p.get("boundary_end", t_done))
            - p["t_window"])

    def drain(self) -> None:
        """Join any in-flight window training so ``results`` /
        ``booster`` reflect every completed window. No-op in
        sequential mode or between windows."""
        if self._pending is not None:
            self._join_pending()

    def close(self) -> None:
        """Drain and shut the trainer/server threads down (a later
        window would lazily restart them)."""
        self.drain()
        for attr in ("_executor", "_eval_executor"):
            ex = getattr(self, attr)
            if ex is not None:
                ex.shutdown(wait=True)
                setattr(self, attr, None)
        if self._fleet_daemon is not None:
            self._fleet_daemon.stop()
            self._fleet_daemon = None
            self._fleet_client = None

    # result-record fields replicated onto the per-window wide event
    # (the reqlog file sees the window's outcome without parsing the
    # result line)
    _WINDOW_EVENT_FIELDS = (
        "eval_rows", "fp_rate", "fn_rate", "train_rows", "train_s",
        "compile_s", "degraded", "degrade_reason", "degrade_label",
        "staleness_windows", "serve_p99_ms", "window_wall_s",
        "overlap_s")

    def _finish_window(self, rec: dict, wall: float) -> None:
        """A window's record is complete (sequential: at the boundary;
        pipelined: when its training resolves): quantile-grade wall
        bookkeeping, the result line, one wide event, and a
        trace/result flush so a live loop can be inspected mid-run and
        a killed run keeps its last finished window."""
        rec["window_wall_s"] = round(wall, 3)
        self._wall_hist.observe(wall)
        obs.latency_histogram("lrb/window_wall_s").observe(wall)
        # (lrb/windows_total is counted in _apply_train_outcome, den
        # before num — see the ratio-race note there)
        reqlog.record("window", window=rec["window"],
                      **{k: rec[k] for k in self._WINDOW_EVENT_FIELDS
                         if k in rec})
        print(f"window {rec['window']}: "
              + " ".join(f"{k}={v}" for k, v in rec.items()),
              file=self.out)
        if hasattr(self.out, "flush"):
            self.out.flush()
        trace.write()

    def degraded_windows(self) -> int:
        """Windows that did not produce a fresh model (failed training,
        blown budget, degenerate labels)."""
        return sum(1 for r in self.results if r.get("degraded"))

    @property
    def flight_dumps(self) -> List[str]:
        """Flight-recorder bundles dumped since this driver started (the
        fault trigger's and the degraded-window trigger's; the rate
        limiter coalesces one incident into one bundle): the postmortem
        evidence, printed by ``main`` next to the result summary."""
        return obs_flight.dump_paths()[self._flight_dumps_at_init:]

    def _train_model(self, labels: np.ndarray, X: np.ndarray,
                     widx: int,
                     deadline: Optional[float] = None):
        if len(labels) == 0 or len(np.unique(labels)) < 2:
            log.warning("window %d: degenerate labels; keeping previous "
                        "model", widx)
            return None
        s0 = step_cache.stats()
        c0 = cuda_build.compile_seconds()
        t0 = time.monotonic()
        ds = capi.LGBM_DatasetCreateFromMat(X, parameters=self.params,
                                            device=self._device)
        capi.LGBM_DatasetSetField(ds, "label", labels)
        # always a FRESH booster per window (test.cpp:281-295), on the
        # dataset's device
        booster = capi.LGBM_BoosterCreate(ds, self.params)
        for _ in range(int(self.params["num_iterations"])):
            if deadline is not None and time.monotonic() > deadline:
                # blown wall budget: the partial booster is DISCARDED
                # (the serving model is unchanged) — a half-trained
                # model must never serve
                raise WindowBudgetExceeded(
                    f"window {widx}: training exceeded "
                    f"the {self.window_budget_s:g}s wall budget; "
                    f"keeping the previous model")
            if capi.LGBM_BoosterUpdateOneIter(booster):
                break
        # per-window build-vs-train split: window 1 may pay the kernels'
        # nvcc build, later windows 0
        train_s = time.monotonic() - t0
        s1 = step_cache.stats()
        compile_s = (cuda_build.compile_seconds() - c0
                     + s1["compile_s"] - s0["compile_s"])
        log.info("window %d: %d rows trained in %.2fs (kernel build and "
                 "graph capture %.2fs, step cache +%d hit / +%d miss)",
                 widx, len(labels), train_s, compile_s,
                 s1["hits"] - s0["hits"], s1["misses"] - s0["misses"])
        # stamp the model's generation ON the handle: predict_live
        # reads the LIVE published handle, which in pipelined mode
        # can be newer than _trained_window (that field only advances
        # at the next boundary join) — the wide event's model
        # attribution must follow the handle, not the lagging field
        booster._lrb_window = widx
        return ({"train_s": round(train_s, 3),
                 "compile_s": round(compile_s, 3),
                 "step_cache_hits": s1["hits"] - s0["hits"]},
                booster)

    def window_wall_quantiles(self) -> Optional[dict]:
        """p50/p95/p99 window wall from THIS driver's log-bucketed
        latency instrument (obs/registry.py latency_histogram) —
        quantiles, not just means; None before the first window
        completes. Pipelined windows count boundary-to-publish."""
        self.drain()
        if not self._wall_hist.count:
            return None
        return {k: round(v, 3)
                for k, v in self._wall_hist.quantiles().items()
                if v is not None}

    def serve_latency_quantiles(self) -> Optional[dict]:
        """p50/p95/p99 PER-REQUEST serving latency from the driver's
        own instrument; None before the first evaluated window."""
        self.drain()
        if not self._serve_hist.count:
            return None
        return {k: round(v, 6)
                for k, v in self._serve_hist.quantiles().items()
                if v is not None}

    def _score_window(self, labels: np.ndarray, X: np.ndarray,
                      handle=None, window: Optional[int] = None) -> dict:
        # the serving half of the loop: this window's requests scored
        # against the previous window's model in micro-batches through
        # the forest kernel (padded to pow2 serve buckets,
        # ops/predict_cache.py). Each micro-batch's wall is ONE
        # serve_batch_s observation and `rows` serve_latency_s
        # observations (each request in it waited the batch out), so
        # the p99 an operator reads is a REQUEST quantile. ``handle``
        # pins the model (the pipelined boundary's join-time snapshot);
        # None = the currently published one. ``window`` stamps the
        # request identity: every micro-batch is issued a monotonic
        # request id, its trace span carries req_id/window, and one
        # wide event per batch records latency / serve bucket / model
        # generation / staleness (obs/reqlog.py).
        if handle is not None:
            h = handle
        else:
            with self._swap_lock:
                h = self._serving
        n = len(labels)
        b = self.serve_batch
        parts = []
        global_hist = obs.latency_histogram("lrb/serve_latency_s")
        global_batch = obs.latency_histogram("lrb/serve_batch_s")
        # model attribution for the wide events: prefer the pinned
        # handle's own generation stamp (_train_model). The fallback
        # fields are safe here too — they are updated ONLY by
        # _apply_train_outcome on the main thread, and the pipelined
        # boundary join resolves this evaluation's future BEFORE
        # applying the next outcome (_join_pending_locked), so they
        # describe the pinned ``handle`` even while the trainer
        # thread publishes mid-evaluation
        model_window = getattr(h, "_lrb_window", self._trained_window)
        staleness = self._windows_since_train
        for r0 in range(0, n, b):
            rows = min(b, n - r0)
            rid = reqlog.next_request_id()
            span_args = {"req_id": rid, "rows": rows}
            if window is not None:
                span_args["window"] = window
            t0 = time.monotonic()
            with reqlog.request(rid, window=window) as rctx, \
                    trace.span("serve/request", cat="serve",
                               args=span_args):
                preds_b = self._daemon_score(X[r0:r0 + b])
                if preds_b is None:
                    preds_b = np.asarray(capi.LGBM_BoosterPredictForMat(
                        h, X[r0:r0 + b],
                        predict_type=capi.C_API_PREDICT_NORMAL))
                parts.append(preds_b)
            dt = time.monotonic() - t0
            self._serve_batch_hist.observe(dt)
            global_batch.observe(dt)
            self._serve_hist.observe_n(dt, rows)
            global_hist.observe_n(dt, rows)
            reqlog.record(
                "request", req_id=rid, path="lrb/serve", window=window,
                rows=rows, latency_ms=round(1e3 * dt, 3),
                model_window=model_window, serve_bucket=rctx.bucket,
                staleness_windows=staleness)
        preds = (np.concatenate(parts) if parts
                 else np.zeros(0, np.float64))
        fp = ((labels < self.cutoff) & (preds >= self.cutoff)).sum()
        fn = ((labels >= self.cutoff) & (preds < self.cutoff)).sum()
        out = {"eval_rows": len(labels),
               "fp_rate": round(float(fp) / max(len(labels), 1), 4),
               "fn_rate": round(float(fn) / max(len(labels), 1), 4)}
        p99 = self._serve_hist.percentile(0.99)
        if p99 is not None:
            # cumulative across the run so far — the number a live
            # operator watches; the final summary prints the full set
            out["serve_p99_ms"] = round(1e3 * p99, 3)
        return out


# ---------------------------------------------------------------------------
# trace IO + synthetic generator
# ---------------------------------------------------------------------------

_MALFORMED_WARN_CAP = 10       # per-line warnings before going quiet


def run_trace_file(path: str, cache_size: int, window_size: int,
                   sample_size: int, cutoff: float, sampling: int,
                   result_file=sys.stdout,
                   extra_params: Optional[dict] = None,
                   window_budget_s: Optional[float] = None,
                   serve_daemon: bool = False,
                   device=None) -> LrbDriver:
    """Drive the loop from a trace file on ``device`` (None:
    ``cuda:0``). Malformed lines are SKIPPED with a warning carrying
    the line number (capped at ``_MALFORMED_WARN_CAP`` detail lines + a
    total-skipped summary) — one bad record in a multi-day trace must
    not kill the run."""
    driver = LrbDriver(cache_size, window_size, sample_size, cutoff,
                       sampling, result_file, extra_params=extra_params,
                       window_budget_s=window_budget_s,
                       serve_daemon=serve_daemon, device=device)
    seq = 0
    skipped = 0
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            parts = line.split()
            if not parts:
                continue
            try:
                if len(parts) >= 4:
                    _, obj_id, size, cost = parts[:4]
                else:
                    obj_id, size, cost = parts[:3]
                req = (int(obj_id), int(float(size)), float(cost))
            except (ValueError, IndexError) as e:
                skipped += 1
                if skipped <= _MALFORMED_WARN_CAP:
                    log.warning("%s:%d: malformed trace line skipped "
                                "(%s): %r", path, lineno, e,
                                line.rstrip()[:80])
                elif skipped == _MALFORMED_WARN_CAP + 1:
                    log.warning("%s: further malformed-line warnings "
                                "suppressed (summary at end)", path)
                continue
            seq += 1
            driver.process_request(seq, *req)
    driver.drain()
    driver.trace_lines_skipped = skipped
    if skipped:
        log.warning("%s: skipped %d malformed trace line(s) in total "
                    "(%d served)", path, skipped, seq)
    return driver


def synthetic_trace(n_requests: int, n_objects: int = 200,
                    seed: int = 7):
    """Zipf-ish request stream for tests: popular objects recur."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_objects + 1)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    ids = rng.choice(n_objects, size=n_requests, p=p)
    sizes = (2 ** rng.integers(6, 14, n_objects))
    for i, oid in enumerate(ids):
        yield i + 1, int(oid), int(sizes[oid]), 1.0


def _run_main(argv, out, serve_daemon: bool = False, device=None) -> None:
    trace_path, cache_size, window_size, sample_size, cutoff, sampling = \
        argv[0], int(argv[1]), int(argv[2]), int(argv[3]), \
        float(argv[4]), int(argv[5])
    driver = run_trace_file(trace_path, cache_size, window_size,
                            sample_size, cutoff, sampling, out,
                            serve_daemon=serve_daemon, device=device)
    driver.close()
    q = driver.window_wall_quantiles()
    if q:
        print("window_wall " + " ".join(f"{k}={v}s"
                                        for k, v in q.items()),
              file=out)
    sq = driver.serve_latency_quantiles()
    if sq:
        print("serve_latency " + " ".join(f"{k}={1e3 * v:.3f}ms"
                                          for k, v in sq.items()),
              file=out)
    dw = driver.degraded_windows()
    if dw:
        print(f"degraded_windows={dw} "
              f"model_staleness_windows={driver._windows_since_train}",
              file=out)
    if driver.flight_dumps:
        print("flight_dumps " + " ".join(driver.flight_dumps), file=out)


def main(argv=None, device=None):
    """The reference binary's CLI; ``device`` as ``LrbDriver``'s (None:
    ``cuda:0``)."""
    argv = sys.argv[1:] if argv is None else argv
    # the one optional flag rides alongside the reference's positional
    # CLI: strip it before the positional parse
    serve_daemon = "--serve-daemon" in argv
    argv = [a for a in argv if a != "--serve-daemon"]
    if len(argv) < 6:
        print("parameters: tracePath cacheSize windowSize sampleSize "
              "cutoff sampling [resultFile] [--serve-daemon]",
              file=sys.stderr)
        sys.exit(1)
    if len(argv) > 6:
        # context-managed: a crash mid-run must not strand buffered
        # tail windows in a never-closed handle (the driver also
        # flushes after every finished window)
        with open(argv[6], "w") as out:
            _run_main(argv, out, serve_daemon, device)
    else:
        _run_main(argv, sys.stdout, serve_daemon, device)


if __name__ == "__main__":
    main()
