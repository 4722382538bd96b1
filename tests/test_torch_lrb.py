"""Port parity of the LRB cache-admission loop (lightgbm_tpu_torch/lrb.py)
and the host modules it calls, against the JAX package on the CPU.

Bars: OPT labels, derived features and OPT hit counts bit-equal to the
JAX driver's (and to both packages' scalar oracles) on adversarial
windows; the sequential loop with the full TRAIN_PARAMS gives every
window's record equal to the JAX driver's on PARITY_KEYS
(tests/test_lrb_pipeline.py) and the final model text byte-equal; the
pipelined loop equals the sequential one; serving stays live during a
retrain under the port's lock-order monitor; degraded windows keep the
previous model; the copied host modules (serve buckets, latency
quantiles, retry backoff, fault specs) answer as their JAX twins.
"""
import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from lightgbm_tpu import lrb as jlrb
from lightgbm_tpu.obs import registry as jobs
from lightgbm_tpu.ops import predict_cache as jpc
from lightgbm_tpu.ops import step_cache as jstep_cache
from lightgbm_tpu.utils import faults as jfaults
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu.utils import retry as jretry
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch import lrb
from lightgbm_tpu_torch.analysis import lockorder
from lightgbm_tpu_torch.obs import registry as obs
from lightgbm_tpu_torch.obs import flight, reqlog, trace
from lightgbm_tpu_torch.ops import predict_cache, step_cache
from lightgbm_tpu_torch.utils import faults, retry
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port

FAST = {"num_iterations": 4, "verbose": -1}
# tests/test_lrb_pipeline.py PARITY_KEYS
PARITY_KEYS = ("window", "eval_rows", "fp_rate", "fn_rate",
               "train_rows", "opt_obj_hit_ratio", "opt_byte_hit_ratio",
               "staleness_windows", "degraded", "degrade_reason")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small PyTorch ops: one thread each under parallel test
    workers (their pools only contend), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_log_levels():
    """Training with verbose=-1 lowers either package's process-wide log
    level; each test puts both back."""
    levels = jlog.get_level(), tlog.get_level()
    yield
    jlog.set_level(levels[0])
    tlog.set_level(levels[1])


@pytest.fixture
def port_lock_order():
    """The port's own lock-order monitor (analysis/lockorder.py) armed
    for one test: locks the port creates inside through its factories
    are tracked, its module locks swapped for the window, and the test
    fails if the acquisition graph has a cycle."""
    with lockorder.detecting() as mon:
        yield mon
    mon.assert_acyclic()


def _driver(mode, window=300, sample=150, extra=None, **kw):
    params = dict(FAST)
    params["tpu_lrb_pipeline"] = mode
    params.update(extra or {})
    return lrb.LrbDriver(1 << 16, window, sample, 0.5, 1,
                         result_file=io.StringIO(), extra_params=params,
                         device="cpu", **kw)


def _feed(drv, n, objects=60):
    for seq, oid, size, cost in lrb.synthetic_trace(n, objects):
        drv.process_request(seq, oid, size, cost)


def _fill_window(drv, n, n_ids=8, seed=0, big_sizes=False):
    """An adversarial window (tests/test_lrb_pipeline.py _fill_window):
    heavy id repeats (>50 occurrences, the gap-deque cap), one id at
    several sizes, label runs, and optionally sizes that drive the
    available cache bytes <= 0."""
    rng = np.random.default_rng(seed)
    w = drv.window
    hi = (1 << 22) if big_sizes else 5000
    for _ in range(n):
        w.ids.append(int(rng.integers(0, n_ids)))
        w.sizes.append(int(rng.integers(1, hi)))
        w.costs.append(float(rng.random()))
        w.has_next.append(bool(rng.random() < 0.6))
        w.volume.append(int(rng.integers(0, 1 << 20)))
        w.byte_sum += w.sizes[-1]


# -- (a) OPT and feature derivation, bit for bit -----------------------------

def _pair(window=400, sample=170, big_sizes=False, n=400):
    """The port's and the JAX driver's, each on the same window."""
    out = []
    for mod, kw in ((lrb, {"device": "cpu"}), (jlrb, {})):
        drv = mod.LrbDriver(1 << 16, window, sample, 0.5, 1,
                            result_file=io.StringIO(),
                            extra_params=dict(FAST), **kw)
        if big_sizes:
            drv.cache_size = 1 << 20      # avail goes <= 0 mid-window
        _fill_window(drv, n, big_sizes=big_sizes)
        out.append(drv)
    return out


def _opt(drv, scalar):
    (drv._calculate_opt_scalar if scalar else drv._calculate_opt)()
    return (drv.window.to_cache.copy(), drv._opt_hits, drv._opt_byte_hits)


@pytest.mark.parametrize("big_sizes", [False, True])
def test_opt_bit_equal(big_sizes):
    t, j = _pair(big_sizes=big_sizes)
    want = _opt(j, scalar=True)
    for drv, scalar in ((t, False), (t, True), (j, False)):
        got = _opt(drv, scalar)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_opt_budget_cutoff():
    """The scalar loop admits while the running volume is <= budget and
    breaks past it: both packages stop at the same item."""
    for mod, kw in ((lrb, {"device": "cpu"}), (jlrb, {})):
        drv = mod.LrbDriver(10, 4, 4, 0.5, 1, result_file=io.StringIO(),
                            **kw)            # budget = 10 * 4 = 40
        w = drv.window
        for vol, size in ((15, 3), (25, 5), (1, 7), (999, 9)):
            w.ids.append(1)
            w.sizes.append(size)
            w.costs.append(1.0)
            w.has_next.append(True)
            w.volume.append(vol)
            w.byte_sum += size
        drv._calculate_opt()
        assert list(drv.window.to_cache) == [True, True, True, False]


@pytest.mark.parametrize("sampling", [0, 1, 2])
@pytest.mark.parametrize("big_sizes", [False, True])
def test_derive_bit_equal(sampling, big_sizes):
    t, j = _pair(big_sizes=big_sizes)
    runs = []
    for drv in (t, j):
        drv._calculate_opt()
        for fn in (drv._derive_features, drv._derive_features_scalar):
            drv.rng = np.random.default_rng(42)
            runs.append(fn(sampling))
    l0, x0 = runs[-1]                       # the JAX scalar oracle
    assert x0.dtype == np.float64 and l0.dtype == np.float32
    for labels, X in runs:
        np.testing.assert_array_equal(labels, l0)
        assert X.shape == x0.shape
        np.testing.assert_array_equal(X, x0)


def test_derive_empty_and_single():
    drv = _driver(0)
    labels, X = drv._derive_features(0)
    assert labels.shape == (0,) and X.shape == (0, lrb.NUM_FEATURES)
    t, j = _pair(n=1)
    for drv in (t, j):
        drv._calculate_opt()
    np.testing.assert_array_equal(t._derive_features(0)[1],
                                  j._derive_features_scalar(0)[1])


# -- (b) the sequential loop against the JAX driver ---------------------------

def _windowed(mod, **kw):
    """tests/test_capi_lrb.py:84's shape with the full TRAIN_PARAMS,
    sequential."""
    drv = mod.LrbDriver(cache_size=1 << 16, window_size=500,
                        sample_size=400, cutoff=0.5, sampling=1,
                        result_file=io.StringIO(),
                        extra_params={"tpu_lrb_pipeline": 0}, **kw)
    for seq, oid, size, cost in mod.synthetic_trace(1500):
        drv.process_request(seq, oid, size, cost)
    res = drv.results
    text = mod.capi.LGBM_BoosterSaveModelToString(drv.booster)
    drv.close()
    return res, text


def test_sequential_loop_matches_jax():
    # both step registries empty, as in a fresh process: an earlier test
    # of a geometry the windows share would count as a hit
    jstep_cache.clear()
    step_cache.clear()
    res_t, text_t = _windowed(lrb, device="cpu")
    res_j, text_j = _windowed(jlrb)
    assert len(res_t) == len(res_j) == 3
    for a, b in zip(res_j, res_t):
        for k in PARITY_KEYS:
            assert a.get(k) == b.get(k), (a["window"], k, a.get(k),
                                          b.get(k))
    # nothing built and no graph captured on the CPU. The three windows
    # keep 40, 49 and 34 non-trivial features and B of 128, 64 and 128:
    # both step geometries pad F to a multiple of 8 (40, 56, 40), so the
    # third window hits the first's in both packages
    assert all(r["compile_s"] == 0.0 for r in res_t)
    assert [r["step_cache_hits"] for r in res_t] == \
        [r["step_cache_hits"] for r in res_j] == [0, 0, 1]
    assert text_t == text_j


# -- (c) pipelined == sequential in the port ----------------------------------

def test_pipelined_matches_sequential():
    out = {}
    for mode in (1, 0):
        swaps0 = obs.counter("lrb/model_swaps").value
        drv = _driver(mode)
        _feed(drv, 1800)
        res = drv.results                   # drains the pipeline
        out[mode] = (drv, res, obs.counter("lrb/model_swaps").value
                     - swaps0)
        drv.close()
    drv_p, res_p, swaps_p = out[1]
    _, res_s, swaps_s = out[0]
    assert len(res_p) == len(res_s) == 6
    for a, b in zip(res_s, res_p):
        for k in PARITY_KEYS:
            assert a.get(k) == b.get(k), (k, a.get(k), b.get(k))
    # one published model per trained window, and only those; the
    # sequential loop swaps in place and counts none
    trained = sum(1 for r in res_p if not r.get("degraded"))
    assert swaps_p == trained == 6 and swaps_s == 0
    assert all("overlap_s" in r for r in res_p)
    # the serve histogram is PER-REQUEST: one observation per scored row
    assert drv_p._serve_hist.count == sum(r.get("eval_rows", 0)
                                          for r in res_p)
    assert drv_p._serve_batch_hist.count < drv_p._serve_hist.count
    assert set(drv_p.serve_latency_quantiles()) == {"p50", "p95", "p99",
                                                    "p999"}


# -- (d) serving stays live during a retrain ----------------------------------

def test_serving_stays_live_during_retrain(port_lock_order):
    reqs = list(lrb.synthetic_trace(600, 60))
    drv = _driver(1)
    for r in reqs[:300]:
        drv.process_request(*r)             # window 1 trains + publishes
    drv.drain()
    assert drv.booster is not None
    gate = threading.Event()
    drv._train_gate = gate
    try:
        for r in reqs[300:]:
            drv.process_request(*r)
        # window 2's training is parked on the gate: in flight NOW
        assert drv._train_started.wait(timeout=30)
        assert drv.training_in_flight()
        out = drv.predict_live(np.zeros((8, lrb.NUM_FEATURES)))
        assert out is not None and np.asarray(out).shape == (8,)
        assert drv.training_in_flight(), \
            "the serve call must not have waited the trainer out"
    finally:
        gate.set()
        drv._train_gate = None
    res = drv.results
    assert len(res) == 2 and not res[1].get("degraded")
    drv.close()
    assert "lrb._swap_lock" in port_lock_order.lock_names()


def test_concurrent_drain_joins_once():
    """Concurrent drains from several threads run the join body once."""
    reqs = list(lrb.synthetic_trace(600, 60))
    drv = _driver(1)
    for r in reqs[:300]:
        drv.process_request(*r)
    drv.drain()
    gate = threading.Event()
    drv._train_gate = gate
    got = []
    readers = [threading.Thread(target=lambda: got.append(
        len(drv.results))) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for r in reqs[300:]:
            drv.process_request(*r)         # window 2 parked on the gate
        assert drv._train_started.wait(timeout=30)
        for t in readers:
            t.start()
    finally:
        gate.set()
        drv._train_gate = None
        for t in readers:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers)
    assert got == [2] * 8
    assert drv.out.getvalue().count("window 2:") == 1
    drv.close()


def test_trace_and_request_log_files(tmp_path):
    """With ``tpu_trace`` and ``tpu_reqlog`` set, the pipelined loop
    writes a Chrome trace of its three threads and one wide event per
    64-row serving call (its 64-row bucket) and per window."""
    tpath, rpath = tmp_path / "trace.json", tmp_path / "req.jsonl"
    try:
        drv = _driver(1, extra={"tpu_trace": str(tpath),
                                "tpu_reqlog": str(rpath)})
        _feed(drv, 900)
        res = drv.results
        drv.close()
        doc = json.loads(tpath.read_text())
        events = reqlog.get().recent()
    finally:
        trace.stop()
        reqlog.shutdown()
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"window", "lrb/derive", "lrb/train", "lrb/evaluate",
            "serve/request", "lrb/swap", "lrb/join"} <= names
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e["name"] == "thread_name"}
    assert any(t.startswith("lrb-trainer") for t in threads)
    assert any(t.startswith("lrb-server") for t in threads)
    lines = [json.loads(x) for x in rpath.read_text().splitlines()]
    assert lines[0]["kind"] == "header"
    reqs = [r for r in lines if r["kind"] == "request"]
    assert len(reqs) == sum(-(-r.get("eval_rows", 0) // 64) for r in res)
    assert {r["serve_bucket"] for r in reqs} == {64}
    assert [r["window"] for r in lines if r["kind"] == "window"] == \
        [1, 2, 3]
    assert events[-1]["kind"] == "window"


# -- (e) degrading -------------------------------------------------------------

def _drive_degraded(spec=None, mode=1, **kw):
    if spec:
        faults.configure(spec)
    try:
        drv = _driver(mode, **kw)
        _feed(drv, 900)
        res = drv.results
    finally:
        faults.clear()
    drv.close()
    return drv, res


@pytest.mark.parametrize("mode", [1, 0])
def test_injected_window_fault_keeps_previous_model(mode):
    swaps0 = obs.counter("lrb/model_swaps").value
    failed0 = obs.counter("lrb/windows_failed").value
    drv, res = _drive_degraded("lrb.window_train@2", mode)
    assert [r.get("degraded") for r in res] == [None, True, None]
    assert "InjectedFault" in res[1]["degrade_reason"]
    assert res[1]["degrade_label"] == "injected_fault"
    assert [r["staleness_windows"] for r in res] == [0, 1, 0]
    assert obs.counter("lrb/windows_failed").value - failed0 == 1
    # windows 1 and 3 published (pipelined); window 2's swap never did
    assert obs.counter("lrb/model_swaps").value - swaps0 == 2 * mode
    # window 3 was still scored, on window 1's model
    assert res[2].get("eval_rows", 0) > 0
    assert drv.booster is not None and drv.degraded_windows() == 1


def test_transient_window_fault_retries_in_place():
    r0 = obs.counter("retry/retries").value
    drv, res = _drive_degraded("lrb.window_train@2:transient")
    assert drv.degraded_windows() == 0
    assert obs.counter("retry/retries").value - r0 >= 1
    assert all(r["staleness_windows"] == 0 for r in res)


def test_window_budget_degrades_not_dies():
    drv, res = _drive_degraded(window_budget_s=0.0)   # every window
    assert len(res) == 3 and drv.degraded_windows() == 3
    assert all("WindowBudgetExceeded" in r["degrade_reason"]
               and r["degrade_label"] == "budget" for r in res)
    assert drv.booster is None


def test_every_window_failing_degrades_not_deadlocks(tmp_path):
    """Every window's training fails: each degrades, none deadlocks, and
    the flight recorder (obs/flight.py, a fresh one in ``tmp_path``)
    leaves the run's postmortem bundles, which ``flight_dumps`` names."""
    flight.configure(directory=str(tmp_path))
    try:
        drv, res = _drive_degraded("lrb.window_train@1+")
        dumps = drv.flight_dumps
    finally:
        flight.shutdown()
    assert len(res) == 3 and all(r.get("degraded") for r in res)
    assert drv.booster is None
    assert [r["staleness_windows"] for r in res] == [0, 0, 0]
    assert dumps
    for path in dumps:
        assert os.path.dirname(path) == str(tmp_path)
        with open(path) as fh:
            assert json.load(fh)["schema"] == flight.FLIGHT_SCHEMA


# -- (f) the CLI and the trace reader -------------------------------------------

def _write_trace(path, n, bad_at=()):
    lines = []
    for i, (seq, oid, size, cost) in enumerate(lrb.synthetic_trace(n, 60)):
        lines.append(f"{seq} {oid} {size} {cost}")
        if i in bad_at:
            lines.append("1 2 not-a-size 1.0" if i % 2 else "only two")
    path.write_text("\n".join(lines) + "\n")


def test_main_writes_and_flushes_result_file(tmp_path):
    trace_path = tmp_path / "trace.txt"
    _write_trace(trace_path, 600)
    out_path = tmp_path / "result.txt"
    lrb.main([str(trace_path), str(1 << 16), "300", "150", "0.5", "1",
              str(out_path)], device="cpu")
    text = out_path.read_text()
    assert "window 1:" in text and "window 2:" in text
    assert "window_wall" in text and "serve_latency" in text
    assert "train_s=" in text and "compile_s=" in text


def test_malformed_trace_lines_skipped_and_counted(tmp_path):
    trace_path = tmp_path / "trace.txt"
    _write_trace(trace_path, 900, bad_at=(100, 201))
    drv = lrb.run_trace_file(str(trace_path), 1 << 16, 300, 120, 0.5, 1,
                             result_file=io.StringIO(),
                             extra_params=dict(FAST), device="cpu")
    assert drv.trace_lines_skipped == 2
    assert len(drv.results) == 3           # 900 good lines / 300
    drv.close()


def test_main_usage_error(capsys):
    with pytest.raises(SystemExit):
        lrb.main(["trace.txt", "1"])
    assert "parameters:" in capsys.readouterr().err


# -- the device: no card, no CPU fallback ---------------------------------------

def test_default_device_raises_at_first_window_without_card(monkeypatch):
    """With no device the loop trains on cuda:0; with no card the first
    window's training raises, and nothing trains on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    created = []
    monkeypatch.setattr(tcapi, "LGBM_DatasetCreateFromMat",
                        lambda *a, **k: created.append(1))
    drv = lrb.LrbDriver(1 << 16, 300, 150, 0.5, 1,
                        result_file=io.StringIO(),
                        extra_params=dict(FAST))
    with pytest.raises(LightGBMError, match="CUDA"):
        _feed(drv, 300)
    assert created == [] and drv.window_index == 0
    assert drv._results == []


def test_serve_bucket_padding_is_bit_exact():
    """A 7-row call rides the 16-row bucket (noted on the request
    context) and scores its rows as the same rows in a 300-row call."""
    drv = _driver(0)
    _feed(drv, 300)
    h = drv.booster
    rows = np.random.default_rng(3).integers(
        0, 5000, size=(300, lrb.NUM_FEATURES)).astype(np.float64)
    full = np.asarray(tcapi.LGBM_BoosterPredictForMat(h, rows))
    with reqlog.request() as ctx:
        part = np.asarray(tcapi.LGBM_BoosterPredictForMat(h, rows[:7]))
    assert ctx.bucket == 16
    np.testing.assert_array_equal(part, full[:7])
    assert predict_cache.stats()["stacks"] >= 1
    drv.close()


# -- (g) the copied host modules against their JAX twins --------------------------

def _quantiles(mod):
    h = mod.latency_histogram("t", mod.MetricsRegistry())
    r = np.random.default_rng(11)
    for v in r.lognormal(-6, 1.5, 500):
        h.observe(float(v))
    for v, n in zip(r.lognormal(-4, 1, 50), r.integers(1, 64, 50)):
        h.observe_n(float(v), int(n))
    h.observe_n(5.0, 0)
    snap = h.snapshot()
    return h.quantiles(), {k: snap[k] for k in
                           ("count", "sum", "min", "max", "buckets",
                            "overflow", "p50", "p90", "p999")}


def _rules(mod, spec):
    try:
        rules = mod._parse_spec(spec, 5)
    except ValueError:
        return "ValueError"
    return {k: (sorted(r.at), r.at_from, r.p, r.action, r.sleep_ms,
                r.rng.random() if r.p is not None else None)
            for k, r in rules.items()}


FAULT_SPECS = ["lrb.window_train@2", "lrb.window_train@1+",
               "a@1,3,5:transient; b@p0.25:kill", "x@2:sleep50",
               "x@3+:raise", "bad", "x@1:explode", "x@p1.5",
               "x@1:sleep-3"]


@pytest.mark.parametrize("what", ["serve_bucket_rows", "latency_quantiles",
                                  "retry_backoff", "fault_specs"])
def test_host_modules_match_jax(what):
    if what == "serve_bucket_rows":
        n = np.arange(1, 70_001)
        for policy in (-1, 0, 48):
            got = [predict_cache._bucket_rows(int(k), policy) for k in n]
            want = [jpc._bucket_rows(int(k), policy) for k in n]
            assert got == want, policy
        assert predict_cache.serve_bucket_rows(7) == 16
    elif what == "latency_quantiles":
        assert _quantiles(obs) == _quantiles(jobs)
    elif what == "retry_backoff":
        for seed in (0, 7):
            a = retry.RetryPolicy(attempts=6, seed=seed)
            b = jretry.RetryPolicy(attempts=6, seed=seed)
            assert [a.delay_s(i) for i in range(8)] == \
                [b.delay_s(i) for i in range(8)]
        fault = faults.InjectedFault("x", transient=True)
        assert retry.is_transient(fault)
        assert not retry.is_transient(faults.InjectedFault("x"))
        assert jretry.is_transient(jfaults.InjectedFault("x",
                                                         transient=True))
    else:
        for spec in FAULT_SPECS:
            assert _rules(faults, spec) == _rules(jfaults, spec), spec
