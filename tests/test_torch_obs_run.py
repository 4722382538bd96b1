"""Port parity: the run recorder, profiler window, metrics exporter and
flight recorder (lightgbm_tpu_torch/obs/{recorder,profiler,export,
flight}.py) against the JAX package's, on the CPU.

Bars: the port's run report has the JAX report's schema, version, keys
and eval values for the same run (timings, device memory and transfer
bytes left out of the comparison; the meta keys the port leaves out or
adds are named); ``callback.record_run`` spans every iteration; a
torch.profiler trace holds the phase ranges; the exporter's ``.prom``
text parses and equals the JAX renderer's for one snapshot, its JSONL
has one line a tick, and its HTTP endpoints answer on an ephemeral port;
a flight bundle is written before a ``kill`` fault in a subprocess and
on an uncaught exception, its rate limit coalesces and its sweep
persists; the armed LRB loop leaves a bundle that ``flight_dumps``
names.
"""
import io
import json
import math
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.obs import export as jexport
from lightgbm_tpu.obs import flight as jflight
from lightgbm_tpu.obs import recorder as jrecorder
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import lrb
from lightgbm_tpu_torch.obs import export, flight, recorder, reqlog, slo
from lightgbm_tpu_torch.obs import registry as obs
from lightgbm_tpu_torch.obs import trace
from lightgbm_tpu_torch.obs.profiler import ProfileWindow
from lightgbm_tpu_torch.utils import faults, log

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread a test worker, restored after: under parallel
    workers on a shared CPU, each small op's thread pool only contends
    (as in test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
          "min_data_in_leaf": 5, "num_iterations": 8,
          "bagging_freq": 3, "bagging_fraction": 0.7,
          "feature_fraction": 0.8, "metric": "binary_logloss,auc",
          "verbose": -1}
# per-iteration fields that are measurements of the run, not its result
TIMING_FIELDS = {"wall_s", "hbm_bytes_in_use", "h2d_bytes", "sync"}


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.clear()
    export.shutdown()
    slo.shutdown()
    flight.shutdown()


def make_binary(seed=0, n=500, f=6):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return X, y


def _engine_run(pkg, params, rounds=8):
    X, y = make_binary()
    Xv, yv = make_binary(3, n=200)
    kw = {"device": "cpu"} if pkg is lgt else {}
    train = pkg.Dataset(X, label=y)
    return pkg.train(params, train, rounds,
                     valid_sets=[pkg.Dataset(Xv, label=yv, reference=train)],
                     verbose_eval=False, **kw)


def _cli_run(pkg, params):
    X, y = make_binary()
    Xv, yv = make_binary(3, n=200)
    kw = {"device": "cpu"} if pkg is lgt else {}
    train = pkg.Dataset(X, label=y)
    bst = pkg.Booster(params=dict(params), train_set=train, **kw)
    bst.add_valid(pkg.Dataset(Xv, label=yv, reference=train), "v")
    bst._gbdt.train(-1, "")
    return bst


@pytest.mark.parametrize("driver", ["engine", "cli"])
def test_run_report_matches_the_jax_package(tmp_path, driver):
    """The same run through both packages: the reports' schema, version,
    top-level keys, iteration records (timings left out) and eval
    values agree; the meta keys differ only by those named here."""
    run = _engine_run if driver == "engine" else _cli_run
    # the JAX drivers read their metrics from pipelined device
    # evaluations in f32 (its engine.py eval_dispatch_async, models/
    # gbdt.py _eval_dispatch); the port's from its host metrics, within
    # 1e-10 of the JAX package's get_eval_at (the objectives suite)
    rel = 1e-6
    reps = {}
    for name, pkg, rec in (("jax", jlgb, jrecorder), ("port", lgt,
                                                      recorder)):
        path = str(tmp_path / f"{name}.json")
        run(pkg, dict(PARAMS, tpu_run_report=path))
        reps[name] = rec.load_run_report(path)
    j, p = reps["jax"], reps["port"]
    assert p["schema"] == j["schema"] == "lightgbm-tpu/run-report"
    assert p["version"] == j["version"] == 1
    assert set(p) == set(j)
    assert recorder.load_run_report(str(tmp_path / "jax.json"))["schema"]
    # the JAX driver's cache and wire meta wait for ROADMAP items 16,
    # 18(a) and 19; the port adds its device memory's peak (null here)
    waits = {"step_cache", "predict_cache"} | (
        {"wire"} if driver == "cli" else set())
    # cross-links present only when the process has flight bundles or a
    # tracer (process-wide state, not the run's)
    links = {"flight_dumps", "trace_path"}
    assert (set(p["meta"]) | waits) - links == \
        (set(j["meta"]) | {"peak_device_bytes"}) - links
    assert p["meta"]["peak_device_bytes"] is None
    assert p["meta"]["driver"] == j["meta"]["driver"]
    assert set(p.get("extra", {})) == set(j.get("extra", {}))
    assert len(p["iterations"]) == len(j["iterations"]) == 8
    for a, b in zip(p["iterations"], j["iterations"]):
        assert set(a) - TIMING_FIELDS == set(b) - TIMING_FIELDS
        assert a["it"] == b["it"] and a.get("leaves") == b.get("leaves")
        assert a.get("waves") == b.get("waves")
        for ds, metrics in b["evals"].items():
            for m, v in metrics.items():
                assert a["evals"][ds][m] == pytest.approx(v, rel=rel)


def test_record_run_spans_every_iteration():
    rec = recorder.RunRecorder(registry=obs.MetricsRegistry()).start()
    cb = lgt.callback.record_run(rec)
    assert cb.order == 25
    for it in range(4):
        cb(lgt.callback.CallbackEnv(
            model=None, params={}, iteration=it, begin_iteration=0,
            end_iteration=4,
            evaluation_result_list=[("v", "auc", 0.5 + it / 10, True)]))
    rep = rec.finish()
    assert [r["it"] for r in rep["iterations"]] == [1, 2, 3, 4]
    assert rep["iterations"][3]["evals"] == {"v": {"auc": 0.8}}
    assert all(r["wall_s"] >= 0 for r in rep["iterations"])


def test_run_report_jsonl_round_trips(tmp_path):
    path = str(tmp_path / "r.jsonl")
    _cli_run(lgt, dict(PARAMS, tpu_run_report=path))
    with open(path) as fh:
        kinds = [json.loads(ln)["kind"] for ln in fh]
    assert kinds == ["header"] + ["iteration"] * 8 + ["summary"]
    rep = recorder.load_run_report(path)
    assert len(rep["iterations"]) == 8 and rep["phases"]
    assert jrecorder.load_run_report(path)["schema"] == rep["schema"]


def test_watchdog_warns_and_triggers_the_flight_recorder(tmp_path):
    fr = flight.configure(directory=str(tmp_path))
    reg = obs.MetricsRegistry()
    rec = recorder.RunRecorder(watchdog_factor=4.0, registry=reg).start()
    for it in range(1, 10):
        rec.observe_iteration(it, 0.01)
    rec.observe_iteration(10, 1.0)
    rec.finish()
    assert reg.counter("watchdog/slow_iterations").value == 1
    assert [os.path.basename(p).split("_", 3)[-1]
            for p in fr.dump_paths()] == ["watchdog.json"]


def test_profiler_trace_holds_the_phase_ranges(tmp_path):
    """A torch.profiler window of 3 iterations from iteration 2: one
    Chrome trace whose ``lgbm/train/iteration`` ranges count the
    window's iterations, and whose evaluation ranges are there too."""
    prof = str(tmp_path / "prof")
    _engine_run(lgt, dict(PARAMS, tpu_profile_dir=prof,
                          tpu_profile_iters=3))
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(prof, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("lgbm/train/iteration") == 3
    assert names.count("lgbm/train/eval") >= 2


def test_profile_window_whole_run_and_close():
    win = ProfileWindow("", 0)
    assert not win.enabled
    win.iter_begin(1)
    win.close()
    from lightgbm_tpu_torch.utils import timing
    assert not timing._annotate


# -- the exporter ---------------------------------------------------------------

def _parse_prom(text: str) -> dict:
    """{sample name with labels: value} of Prometheus text; every line a
    ``# TYPE`` comment or a sample whose value parses as a float."""
    out = {}
    for ln in text.strip().split("\n"):
        if ln.startswith("# TYPE "):
            assert ln.split()[3] in ("counter", "gauge", "histogram")
            continue
        name, value = ln.rsplit(" ", 1)
        out[name] = float(value)
    return out


def test_exporter_files_and_http_endpoints(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("ingest/h2d_bytes").add(1024)
    reg.gauge("lrb/model_staleness_windows").set(0)
    h = reg.histogram("lrb/window_wall_s")
    for v in (0.1, 0.2, 0.4):
        h.observe(v)
    reg.timer("train/iteration").add(0.5)
    ex = export.MetricsExporter(str(tmp_path / "m.prom"), interval_s=0.05,
                                port=0, registry=reg).start()
    try:
        port = ex.http_port
        assert port and port > 0
        time.sleep(0.4)

        def get(route):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{route}", timeout=10) as r:
                return r.status, r.read().decode()
        status, text = get("/metrics")
        assert status == 200
        samples = _parse_prom(text)
        assert samples["lgbm_tpu_ingest_h2d_bytes_total"] == 1024
        assert samples['lgbm_tpu_lrb_window_wall_s_bucket{le="+Inf"}'] == 3
        status, body = get("/healthz")
        assert status == 200 and json.loads(body)["alive"] is True
        status, body = get("/metrics.json")
        assert json.loads(body)["counters"]["ingest/h2d_bytes"] == 1024
        status, body = get("/slo")
        assert status == 200 and json.loads(body)["enabled"] is False
        with pytest.raises(urllib.error.HTTPError):
            get("/nothing")
    finally:
        ex.stop()
    with open(tmp_path / "m.jsonl") as fh:
        lines = [json.loads(ln) for ln in fh]
    assert len(lines) == ex.snapshots_written >= 3
    assert all(ln["counters"]["ingest/h2d_bytes"] == 1024 for ln in lines)
    samples = _parse_prom((tmp_path / "m.prom").read_text())
    assert samples["lgbm_tpu_train_iteration_calls_total"] == 1
    assert all(math.isfinite(v) or math.isnan(v) for v in samples.values())


def test_prometheus_text_equals_the_jax_renderer():
    reg = obs.MetricsRegistry()
    reg.counter("a/b").add(3)
    reg.gauge("c").set(1.5)
    reg.histogram("h/s").observe(0.2)
    reg.timer("t").add(0.25)
    snap = reg.snapshot()
    snap["identity"] = {"machine_rank": 0, "world": 1, "incarnation": 0}
    assert export.prometheus_text(snap) == jexport.prometheus_text(snap)


def test_exporter_is_the_slo_clock_and_feeds_the_flight_ring(tmp_path):
    fr = flight.configure(directory=str(tmp_path))
    slo.configure("staleness_windows <= 2")
    obs.gauge("lrb/model_staleness_windows").set(0)
    ex = export.ensure_from_config({
        "tpu_metrics_export": str(tmp_path / "live"),
        "tpu_metrics_interval_s": "0.05"})
    time.sleep(0.3)
    export.shutdown()
    text = (tmp_path / "live.prom").read_text()
    assert "lgbm_tpu_slo_" in text and ex.snapshots_written >= 2
    doc = fr.document("probe")
    assert doc["metrics"]["recent"] and doc["slo"]["specs"]


# -- the flight recorder --------------------------------------------------------

_KILL_CHILD = r"""
import sys
import numpy as np
import lightgbm_tpu_torch as lgt
d = sys.argv[1]
r = np.random.default_rng(0)
X = r.normal(size=(300, 5)); y = (X[:, 0] > 0).astype(np.float32)
lgt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
           "tpu_flight_dir": d, "tpu_faults": "train.iter@3:kill"},
          lgt.Dataset(X, label=y), 6, device="cpu")
print("not killed")
"""


def test_flight_bundle_written_before_a_kill(tmp_path):
    """A subprocess that a ``train.iter@3:kill`` rule SIGKILLs: the
    flight bundle is on disk, written before the kill, naming the fault
    and holding the run's spans and log lines."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _KILL_CHILD, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
    assert "not killed" not in r.stdout
    files = [f for f in os.listdir(tmp_path) if f.startswith("flight_")]
    assert len(files) == 1 and files[0].endswith("_fault.json")
    doc = json.loads((tmp_path / files[0]).read_text())
    assert doc["schema"] == jflight.FLIGHT_SCHEMA == flight.FLIGHT_SCHEMA
    assert doc["version"] == jflight.FLIGHT_VERSION == 1
    assert doc["context"]["point"] == "train.iter"
    assert doc["context"]["action"] == "kill"
    assert doc["context"]["occurrence"] == 3
    assert any("injected fault at train.iter" in ln
               for ln in doc["log_lines"])
    assert any(e["name"] == "train/iteration" for e in doc["spans"])


_RAISE_CHILD = r"""
import sys
from lightgbm_tpu_torch.obs import flight
flight.configure(directory=sys.argv[1])
raise RuntimeError("boom")
"""


def test_flight_excepthook_trigger(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _RAISE_CHILD, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "RuntimeError: boom" in r.stderr
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith("unhandled_exception.json")
    doc = json.loads((tmp_path / files[0]).read_text())
    assert doc["context"] == {"type": "RuntimeError", "message": "boom"}


def test_flight_rate_limit_cap_and_sweep(tmp_path):
    """Non-forced triggers within the interval coalesce (the trigger is
    still recorded), the sweep persists the pending one, ``force``
    bypasses the interval and the cap, and the cap holds otherwise."""
    fr = flight.FlightRecorder(capacity=16, directory=str(tmp_path),
                               registry=obs.MetricsRegistry(),
                               min_dump_interval_s=60.0, max_dumps=2)
    assert fr.trigger("first") is not None
    assert fr.trigger("second") is None
    assert fr.trigger("third", {"k": 1}) is None
    swept = fr.sweep_pending()
    assert swept is not None and swept.endswith("third.json")
    assert fr.sweep_pending() is None
    assert fr.trigger("fourth") is None              # capped at 2 dumps
    assert fr.trigger("forced", force=True) is not None
    assert len(fr.dump_paths()) == 3
    doc = json.loads(open(fr.dump_paths()[-1]).read())
    assert [t["reason"] for t in doc["triggers"]] == [
        "first", "second", "third", "fourth", "forced"]


def test_flight_bundle_holds_every_feed(tmp_path):
    """Spans (a trace sink, with no tracer installed), log lines (a log
    sink), reqlog events and a registry snapshot land in the bundle; the
    document's keys are the JAX package's."""
    fr = flight.configure(directory=str(tmp_path))
    assert not trace.enabled()
    with trace.span("probe/span"):
        pass
    log.warning("probe line")
    reqlog.record("probe_event", note="x")
    doc = fr.document("probe")
    jdoc = jflight.FlightRecorder(directory=str(tmp_path)).document("probe")
    assert set(doc) == set(jdoc)
    assert any(e["name"] == "probe/span" for e in doc["spans"])
    assert any("probe line" in ln for ln in doc["log_lines"])
    assert any(e.get("kind") == "probe_event" for e in doc["reqlog"])
    assert "counters" in doc["metrics"]["current"]


def test_armed_lrb_loop_leaves_a_flight_bundle(tmp_path):
    """The LRB loop armed with the exporter (files and an ephemeral HTTP
    port), an SLO and the flight recorder: JSONL snapshots, the SLO
    gauges in the .prom text, and a transient fault in window 2 leaves a
    bundle that the driver's ``flight_dumps`` names."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    flight.configure(directory=str(tmp_path))
    extra = {"tpu_metrics_export": str(tmp_path / "loop"),
             "tpu_metrics_interval_s": 0.05, "tpu_metrics_port": port,
             "tpu_slo": "degraded_window_rate < 0.5",
             "tpu_faults": "lrb.window_train@2:transient"}
    drv = lrb.LrbDriver(1 << 16, 500, 400, 0.5, 1,
                        result_file=io.StringIO(), device="cpu",
                        extra_params=extra)
    for req in lrb.synthetic_trace(1500):
        drv.process_request(*req)
    res = drv.results
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=10) as r:
        assert r.status == 200
    drv.close()
    export.shutdown()
    assert len(res) >= 2 and not any(r.get("degraded") for r in res)
    dumps = drv.flight_dumps
    assert dumps and all(os.path.dirname(p) == str(tmp_path) for p in dumps)
    doc = json.loads(open(dumps[0]).read())
    assert doc["reason"] == "fault" and doc["spans"] and doc["log_lines"]
    assert doc["reqlog"] and doc["metrics"]["current"]["counters"]
    with open(tmp_path / "loop.jsonl") as fh:
        assert len(fh.readlines()) >= 2
    assert "lgbm_tpu_slo_" in (tmp_path / "loop.prom").read_text()
