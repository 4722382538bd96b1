"""Port parity of the fleet scoring daemon (lightgbm_tpu_torch/serve/)
and the SLO engine it admits by (lightgbm_tpu_torch/obs/slo.py),
against the JAX package on the CPU, case by case after
tests/test_fleet.py.

Both packages are fed the same LightGBM v2 model text, trained by the
JAX package's C API. Bars: the port's daemon answers bit-equal to the
port's direct ``LGBM_BoosterPredictForMat`` (coalesced, over HTTP, at
odd sizes, in a batch that mixes f32-exact rows with rows that are not)
and within the predict tolerance of tests/test_torch_stacked_predict.py
(atol 1e-5, rtol 1e-6) of the JAX daemon's answer to the same request;
swap and shed behave as the JAX daemon's; the SLO engines agree on the
same observations; the LRB loop with ``serve_daemon=True`` gives the
records of the in-process loop and of the JAX driver's daemon run.

The JAX test of cross-tenant reuse counts compiled-program hits in its
predict registry. The port has no such registry (K4 is one kernel that
takes any model geometry at launch, ops/predict_cache.py), so its twin
here counts forest stacks: exactly one per published model.
"""
import io
import threading
import time
import urllib.error

import numpy as np
import pytest
import torch

from lightgbm_tpu import capi as jcapi
from lightgbm_tpu import config as jconfig
from lightgbm_tpu import lrb as jlrb
from lightgbm_tpu.obs import registry as jobs
from lightgbm_tpu.obs import slo as jslo
from lightgbm_tpu.serve import ScoringDaemon as JScoringDaemon
from lightgbm_tpu.serve import ShedError as JShedError
from lightgbm_tpu.serve import client as jclient
from lightgbm_tpu.utils import faults as jfaults
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch import capi
from lightgbm_tpu_torch import config as tconfig
from lightgbm_tpu_torch import lrb
from lightgbm_tpu_torch.obs import registry as obs
from lightgbm_tpu_torch.obs import slo
from lightgbm_tpu_torch.ops import predict_cache
from lightgbm_tpu_torch.serve import (Coalescer, FleetClient, QueueFull,
                                      ScoringDaemon, ShedError,
                                      TenantRegistry)
from lightgbm_tpu_torch.serve import client as serve_client
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port

ATOL, RTOL = 1e-5, 1e-6        # tests/test_torch_stacked_predict.py:157
# tests/test_torch_lrb.py PARITY_KEYS
PARITY_KEYS = ("window", "eval_rows", "fp_rate", "fn_rate",
               "train_rows", "opt_obj_hit_ratio", "opt_byte_hit_ratio",
               "staleness_windows", "degraded", "degrade_reason")
_PARAMS = ("objective=binary num_leaves=15 max_bin=63 "
           "min_data_in_leaf=5 verbose=-1")


def _train_model_str(params=_PARAMS, n=300, f=6, iters=10, seed=0):
    """tests/test_fleet.py's binary model, trained by the JAX package."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    ds = jcapi.LGBM_DatasetCreateFromMat(X, parameters=params)
    jcapi.LGBM_DatasetSetField(ds, "label", y)
    bst = jcapi.LGBM_BoosterCreate(ds, params)
    for _ in range(iters):
        if jcapi.LGBM_BoosterUpdateOneIter(bst):
            break
    return jcapi.LGBM_BoosterSaveModelToString(bst)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_state():
    """Faults of both packages cleared and both log levels restored
    after every test, even a failing one."""
    levels = jlog.get_level(), tlog.get_level()
    yield
    faults.clear()
    jfaults.clear()
    jlog.set_level(levels[0])
    tlog.set_level(levels[1])


@pytest.fixture(scope="module")
def binary_model():
    return _train_model_str(seed=0)


@pytest.fixture(scope="module")
def binary_model_v2():
    return _train_model_str(seed=9)


@pytest.fixture(scope="module")
def multiclass_model():
    params = ("objective=multiclass num_class=3 num_leaves=15 "
              "max_bin=63 min_data_in_leaf=5 verbose=-1")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 6))
    y = (np.abs(X[:, 0]) + X[:, 1] > 0.8).astype(np.float32) \
        + (X[:, 2] > 0.5)
    ds = jcapi.LGBM_DatasetCreateFromMat(X, parameters=params)
    jcapi.LGBM_DatasetSetField(ds, "label", y.astype(np.float32))
    bst = jcapi.LGBM_BoosterCreate(ds, params)
    for _ in range(6):
        jcapi.LGBM_BoosterUpdateOneIter(bst)
    return jcapi.LGBM_BoosterSaveModelToString(bst)


@pytest.fixture
def make_daemon():
    """Daemon factory (the port's on the CPU, or the JAX package's) that
    stops every daemon it made, even when an assertion fails."""
    made = []

    def _make(jax=False, **kw):
        d = (JScoringDaemon(port=0, **kw) if jax
             else ScoringDaemon(port=0, device="cpu", **kw)).start()
        made.append(d)
        return d

    yield _make
    for d in made:
        d.stop()


def _direct(model_str, X):
    """The port's uncoalesced call on a freshly loaded handle."""
    h = capi.LGBM_BoosterLoadModelFromString(model_str, device="cpu")
    return np.asarray(capi.LGBM_BoosterPredictForMat(
        h, X, predict_type=capi.C_API_PREDICT_NORMAL))


def _rows(n, seed, f32_exact):
    X = np.random.default_rng(seed).normal(size=(n, 6))
    X[::7, 3] = np.nan
    return X.astype(np.float32).astype(np.float64) if f32_exact else X


# -- tenant registry ---------------------------------------------------------

@pytest.mark.parametrize("name", ["tenant_07", "a" * 64, "", "UPPER",
                                  "has-dash", "a" * 65, "sp ace"])
def test_tenant_name_validation_matches_jax(name):
    from lightgbm_tpu.serve import TenantRegistry as JTenantRegistry
    try:
        want = JTenantRegistry.validate_name(name)
    except ValueError:
        with pytest.raises(ValueError, match="tenant name"):
            TenantRegistry.validate_name(name)
        return
    assert TenantRegistry.validate_name(name) == want


def test_registry_swap_and_drop(binary_model):
    reg = TenantRegistry(warm_rows=4, device="cpu")
    swaps0 = obs.counter("fleet/model_swaps").value
    assert reg.register("t", binary_model) == 1
    h1, v1 = reg.get("t")
    assert v1 == 1 and h1.gbdt.device == torch.device("cpu")
    assert reg.register("t", binary_model) == 2   # swap bumps version
    h2, v2 = reg.get("t")
    assert v2 == 2 and h2 is not h1
    assert obs.counter("fleet/model_swaps").value == swaps0 + 1
    st = reg.stats()
    assert st["tenants"]["t"]["version"] == 2 and st["active"] == 1
    assert reg.drop("t") and not reg.drop("t")
    with pytest.raises(KeyError):
        reg.get("t")


def test_daemon_without_device_raises_at_first_registration(binary_model):
    """No device means cuda:0: without a card the daemon starts, its
    first registration raises (500 over the wire), and no tenant is
    served from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    d = ScoringDaemon(port=0).start()
    try:
        with pytest.raises(LightGBMError, match="CUDA"):
            d.register_tenant("nocard", binary_model)
        with pytest.raises(urllib.error.HTTPError) as ei:
            FleetClient(d.url).register("nocard", binary_model)
        assert ei.value.code == 500
        assert d.tenants.names() == []
    finally:
        d.stop()


# -- coalesced parity ----------------------------------------------------------

def test_coalesced_parity_concurrent_odd_batches(
        make_daemon, binary_model, multiclass_model):
    """Concurrent requests of 1, 3, 7, 64 and 130 rows for two tenants
    of different shapes, every other one f32-exact, coalesced into
    shared batches: each answer bit-equal to the port's direct call and
    within the predict tolerance of the JAX daemon's."""
    d = make_daemon(coalesce_us=3000, warm_rows=16)
    jd = make_daemon(jax=True, coalesce_us=3000, warm_rows=16)
    models = {"bin": binary_model, "multi": multiclass_model}
    for t, m in models.items():
        assert d.register_tenant(t, m) == 1
        assert jd.register_tenant(t, m) == 1
    jobs0 = obs.histogram("fleet/coalesced_batch_rows").count
    jobs_ = []
    for tenant in models:
        for i, rows in enumerate((1, 3, 7, 64, 130, 1, 7)):
            jobs_.append((tenant, _rows(rows, 100 + i, i % 2 == 0)))
    out, errs = {}, []

    def worker(k, tenant, X):
        try:
            out[k] = d.predict(tenant, X)
        except Exception as e:                # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(k, t, X))
               for k, (t, X) in enumerate(jobs_)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and len(out) == len(jobs_)
    for k, (tenant, X) in enumerate(jobs_):
        preds, version = out[k]
        assert version == 1 and preds.shape[0] == X.shape[0]
        np.testing.assert_array_equal(preds, _direct(models[tenant], X))
        jpreds, _ = jd.predict(tenant, X)
        np.testing.assert_allclose(preds, jpreds, atol=ATOL, rtol=RTOL)
    assert obs.histogram("fleet/coalesced_batch_rows").count > jobs0


def test_mixed_binning_batch_bit_equal(binary_model):
    """One dispatch holding f32-exact requests (binned on the device
    when scored alone) and requests that are not (binned on the host):
    the whole batch takes the host's binning, and every request's
    answer is still the bytes it gets alone."""
    reg = TenantRegistry(warm_rows=4, device="cpu")
    reg.register("mix", binary_model)
    batches = []

    def predict(handle, X):
        batches.append(X.shape[0])
        return capi.LGBM_BoosterPredictForMat(handle, X)

    co = Coalescer(reg, max_wait_us=0, max_batch=4096, predict_fn=predict)
    reqs = [_rows(n, 200 + n, n % 2 == 1) for n in (1, 3, 7, 64, 130)]
    futs = [co.submit("mix", X) for X in reqs]   # queued before start
    co.start()
    try:
        for X, f in zip(reqs, futs):
            preds, version = f.result(timeout=30)
            assert version == 1
            np.testing.assert_array_equal(preds, _direct(binary_model, X))
    finally:
        co.stop()
    assert batches == [sum(X.shape[0] for X in reqs)]   # one dispatch


@pytest.mark.parametrize("which", ["binary", "multiclass"])
def test_http_roundtrip_bit_parity(make_daemon, which, binary_model,
                                   multiclass_model):
    """Predictions over the JSON wire equal the in-process daemon's and
    the direct call's to the last bit."""
    model = binary_model if which == "binary" else multiclass_model
    d = make_daemon(coalesce_us=0)
    client = FleetClient(d.url)
    assert client.register("wire", model, warm_rows=8) == 1
    for rows in (1, 7, 33):
        Xb = _rows(rows, rows, False)
        got, version = client.predict_versioned("wire", Xb)
        assert version == 1
        np.testing.assert_array_equal(got, d.predict("wire", Xb)[0])
        np.testing.assert_array_equal(got, _direct(model, Xb))
    assert "wire" in client.health()["tenants"]
    assert client.tenants()["tenants"]["tenants"]["wire"]["version"] == 1


def test_same_geometry_tenants_stack_once_each(make_daemon, binary_model):
    """Four same-geometry tenants: one forest stack per published model,
    and serving them builds no more."""
    d = make_daemon(coalesce_us=0, warm_rows=16)
    before = predict_cache.stats()["stacks"]
    for i in range(4):
        d.register_tenant(f"tenant_{i:02d}", binary_model)
        assert predict_cache.stats()["stacks"] == before + i + 1
    Xb = _rows(8, 2, False)
    want = _direct(binary_model, Xb)
    stacks = predict_cache.stats()["stacks"]
    for i in range(4):
        preds, _ = d.predict(f"tenant_{i:02d}", Xb)
        np.testing.assert_array_equal(preds, want)
    assert d.stats()["predict_cache"]["stacks"] == stacks


# -- versioned warm swap under load ------------------------------------------

def test_swap_under_load_every_response_is_some_clean_version(
        make_daemon, binary_model, binary_model_v2):
    d = make_daemon(coalesce_us=0, warm_rows=8)
    swaps0 = obs.counter("fleet/model_swaps").value
    d.register_tenant("swap", binary_model)
    Xb = _rows(6, 7, False)
    want = {1: _direct(binary_model, Xb), 2: _direct(binary_model_v2, Xb),
            3: _direct(binary_model, Xb)}
    stop = threading.Event()
    got, errs = [], []

    def hammer():
        while not stop.is_set():
            try:
                preds, version = d.predict("swap", Xb)
                got.append((version, np.asarray(preds)))
            except Exception as e:            # noqa: BLE001
                errs.append(e)
                return

    def wait_seen(version, deadline_s=30.0):
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_s:
            if errs or any(v == version for v, _ in list(got)):
                return
            time.sleep(0.002)
        raise AssertionError(f"version {version} never served")

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        assert d.register_tenant("swap", binary_model_v2) == 2
        wait_seen(2)
        assert d.register_tenant("swap", binary_model) == 3
        wait_seen(3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errs and got
    for version, preds in got:
        np.testing.assert_array_equal(preds, want[version])
    assert obs.counter("fleet/model_swaps").value == swaps0 + 2


# -- SLO admission control: the shed drill -----------------------------------

def _shed_drill(d, fault_mod, shed_cls, model):
    """tests/test_fleet.py's drill on one daemon: a healthy history for
    two tenants, then an 80 ms latency fault on one. Returns what a
    comparison needs."""
    a, b = "drill_a", "drill_b"
    d.register_tenant(a, model)
    d.register_tenant(b, model)
    x1 = np.zeros((1, 6))
    for _ in range(400):
        d.predict(a, x1)
        d.predict(b, x1)
    assert d.shed_check(a) is None
    pre = next(r for r in d.slo_report()["specs"] if a in r["name"])
    fault_mod.configure(f"fleet.predict.{a}@1+:sleep80")
    shed_at = None
    for i in range(12):
        try:
            d.predict(a, x1)
        except shed_cls as e:
            shed_at = i
            assert e.tenant == a and e.retry_after_s > 0
            break
    state = dict(d.slo_report()["shedding"].get(a, {}))
    sheds = 0
    for _ in range(20):
        try:
            d.predict(a, x1)
        except shed_cls:
            sheds += 1
    nb_preds, _ = d.predict(b, x1)
    rep = d.slo_report()
    return {"shed_at": shed_at, "state": state, "sheds": sheds,
            "pre_bad": pre["bad_events"], "neighbor": nb_preds,
            "neighbor_shed": b in rep["shedding"]}


class _DrillClock:
    """The coalescers' clock in the shed drill, driven by the test, not
    by the host: it moves 0.5 ms at each read, so a healthy request
    (read at enqueue, dispatch and completion) takes 1 ms, and 80 ms
    more each time the drill's latency fault fires. The classification
    of every request is then the same on a loaded host as on an idle
    one."""

    def __init__(self):
        self._now = 0.0
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self._now += 0.0005
            return self._now

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def __getattr__(self, name):
        # stands in for the JAX coalescer's ``time`` module, which it
        # reads as time.perf_counter()
        return self if name == "perf_counter" else getattr(time, name)


def _drive_fault(monkeypatch, fault_mod, clock, point, seconds):
    """Each check of ``point`` (armed with a sleep fault) moves ``clock``
    by ``seconds`` after the fault's own sleep."""
    check = fault_mod.check

    def driven(p, context=None):
        check(p, context=context)
        if p == point:
            clock.advance(seconds)
    monkeypatch.setattr(fault_mod, "check", driven)


def test_shed_drill_matches_jax(make_daemon, binary_model, monkeypatch):
    """Admission sheds the slow tenant with budget still left, keeps its
    neighbor serving, and does so where the JAX daemon does under the
    same fault and request sequence. The latencies both daemons classify
    come from clocks the test drives (``_DrillClock``): 1 ms a healthy
    request, 80 ms more a faulted one."""
    from lightgbm_tpu.serve import coalescer as jcoalescer
    point = "fleet.predict.drill_a"
    tclock, jclock = _DrillClock(), _DrillClock()
    _drive_fault(monkeypatch, faults, tclock, point, 0.080)
    _drive_fault(monkeypatch, jfaults, jclock, point, 0.080)
    monkeypatch.setattr(jcoalescer, "time", jclock)
    kw = dict(coalesce_us=0, slo_p99_ms=50.0, shed_budget=0.5,
              slo_eval_gap_s=0.0, slo_min_events=100, shed_probe_every=16)
    shed0 = obs.counter("fleet/shed_total").value
    got = _shed_drill(make_daemon(clock=tclock, **kw), faults, ShedError,
                      binary_model)
    faults.clear()
    want = _shed_drill(make_daemon(jax=True, **kw), jfaults, JShedError,
                       binary_model)
    for r in (got, want):
        assert r["shed_at"] is not None, "admission never shed"
        assert r["state"]["budget_remaining_at_shed"] > 0
        assert r["state"]["exhausted_at_shed"] is False
        assert r["sheds"] >= 15 and not r["neighbor_shed"]
    assert obs.counter("fleet/shed_total").value - shed0 >= 15
    assert obs.counter("fleet/shed/drill_a").value >= 15
    np.testing.assert_array_equal(got["neighbor"],
                                  _direct(binary_model, np.zeros((1, 6))))
    # the same request sequence with the same latency classification
    # (no slow outlier in either healthy history) sheds at the same
    # request, with the same budget left
    if got["pre_bad"] == want["pre_bad"]:
        assert got["shed_at"] == want["shed_at"]
        assert got["state"]["budget_remaining_at_shed"] == \
            want["state"]["budget_remaining_at_shed"]
        assert got["sheds"] == want["sheds"]


def test_shed_over_http_is_429(make_daemon, binary_model):
    """The wire surface of a shed: HTTP 429 + Retry-After -> ShedError,
    never retried."""
    d = make_daemon(coalesce_us=0, slo_p99_ms=50.0, shed_budget=0.5,
                    slo_eval_gap_s=0.0, slo_min_events=10,
                    shed_probe_every=0)
    d.register_tenant("wire_shed", binary_model)
    x1 = np.zeros((1, 6))
    faults.configure("fleet.predict.wire_shed@1+:sleep60")
    for _ in range(12):
        try:
            d.predict("wire_shed", x1)
        except ShedError:
            break
    retries0 = obs.counter("retry/retries").value
    with pytest.raises(ShedError) as ei:
        FleetClient(d.url).predict("wire_shed", x1)
    assert ei.value.retry_after_s > 0
    assert obs.counter("retry/retries").value == retries0


# -- backpressure, lifecycle, config ------------------------------------------

def test_bounded_queue_refuses_then_drains(binary_model):
    reg = TenantRegistry(warm_rows=4, device="cpu")
    reg.register("t", binary_model)
    rejects0 = obs.counter("fleet/queue_rejects").value
    co = Coalescer(reg, max_wait_us=0, max_queue=2)
    f1 = co.submit("t", np.zeros((1, 6)))
    f2 = co.submit("t", np.zeros((1, 6)))
    with pytest.raises(QueueFull) as ei:
        co.submit("t", np.zeros((1, 6)))
    assert ei.value.retry_after_s > 0
    assert obs.counter("fleet/queue_rejects").value == rejects0 + 1
    co.start()
    preds, version = f1.result(timeout=30)
    assert version == 1 and preds.shape[0] == 1
    f2.result(timeout=30)
    co.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        co.submit("t", np.zeros((1, 6)))


def test_stop_drains_queued_requests(binary_model):
    """stop() is drain-and-exit: what was queued before it still
    dispatches."""
    reg = TenantRegistry(warm_rows=0, device="cpu")
    reg.register("t", binary_model)
    co = Coalescer(reg, max_wait_us=0, max_batch=8, max_queue=64)
    X = _rows(40, 5, False)
    futs = [co.submit("t", X[i:i + 1]) for i in range(40)]
    co.start()
    co.stop()
    preds = np.concatenate([f.result(timeout=0)[0] for f in futs])
    np.testing.assert_array_equal(preds, _direct(binary_model, X))


def test_daemon_lifecycle_and_from_config(binary_model):
    d = ScoringDaemon.from_config(
        {"tpu_fleet_coalesce_us": 123, "tpu_fleet_max_batch": 77,
         "tpu_fleet_queue": 5, "tpu_fleet_slo_p99_ms": 10.0,
         "tpu_fleet_shed_budget": 0.4}, device="cpu")
    assert d.coalescer._wait_s == pytest.approx(123 / 1e6)
    assert d.coalescer._max_batch == 77 and d.coalescer._max_queue == 5
    assert d._slo_p99_ms == 10.0 and d._shed_budget == 0.4
    assert d.tenants.device == "cpu"
    d.start()
    try:
        assert d.start() is d
        port = d.http_port
        assert port > 0 and d.url.endswith(f":{port}")
        client = FleetClient(d.url)
        assert client.health()["ok"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.predict("nobody", np.zeros((1, 6)))
        assert ei.value.code == 404
    finally:
        d.stop()
    d.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        d.predict("nobody", np.zeros((1, 6)))


@pytest.mark.parametrize("key,value", [
    ("tpu_fleet_port", 70000), ("tpu_fleet_coalesce_us", -5),
    ("tpu_fleet_coalesce_us", 2_000_000), ("tpu_fleet_max_batch", 0),
    ("tpu_fleet_queue", -1), ("tpu_fleet_slo_p99_ms", -3.0),
    ("tpu_fleet_shed_budget", 1.5), ("tpu_fleet_shed_budget", -0.1)])
def test_fleet_knobs_clamp_as_jax(key, value):
    """The tpu_fleet_* knobs: same defaults, and an out-of-range value
    becomes what the JAX Config makes of it."""
    t, j = tconfig.Config(), jconfig.Config()
    assert getattr(t, key) == getattr(j, key)
    t.set({key: value})
    j.set({key: value})
    assert getattr(t, key) == getattr(j, key) != value


def test_forest_library_binds_once_across_threads(monkeypatch):
    """K4's library binding (ops/forest.py ``_fn``), first used by many
    threads at once (the dispatcher, registrations' warm-ups, the LRB
    loop's server): the library loads once and every thread gets a
    function whose types are set."""
    import sys
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.utils import cuda_build

    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self):
            for sym in forest_ops._SIGNATURES:
                setattr(self, sym, Fn())

    loads = []

    def library(name):
        loads.append(name)
        time.sleep(0.01)
        return Lib()

    monkeypatch.setattr(cuda_build, "library", library)
    monkeypatch.setattr(forest_ops, "_fns", {})
    names = list(forest_ops._SIGNATURES)
    barrier = threading.Barrier(16)
    got = []

    def worker(k):
        barrier.wait()
        f = forest_ops._fn(names[k % len(names)])
        got.append((names[k % len(names)], f.argtypes, f.restype))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert loads == ["forest_predict"] and len(got) == 16
    for name, argtypes, restype in got:
        assert argtypes == forest_ops._SIGNATURES[name]
        assert restype is not None


# -- the client -----------------------------------------------------------------

def _cases(shed_cls):
    return [
        shed_cls("t", 0.5),
        urllib.error.HTTPError("u", 503, "busy", None, None),
        urllib.error.HTTPError("u", 502, "bad gw", None, None),
        urllib.error.HTTPError("u", 404, "nope", None, None),
        urllib.error.HTTPError("u", 500, "boom", None, None),
        urllib.error.URLError(ConnectionRefusedError("Connection refused")),
        urllib.error.URLError("name not known"),
        ConnectionResetError("Connection reset by peer"),
        RuntimeError("Remote end closed connection without response"),
        OSError("Read timed out"),
        TimeoutError("timed out"),
        ValueError("bad rows"),
    ]


@pytest.mark.parametrize("i", range(12))
def test_client_transient_classification_matches_jax(i):
    """429 is admission (never retried); 502/503 are retried; other HTTP
    errors fail fast; socket failures are transient: as the JAX
    client classifies them."""
    got = serve_client._classify(_cases(ShedError)[i])
    want = jclient._classify(_cases(JShedError)[i])
    assert got is want


# -- the SLO engine ----------------------------------------------------------------

_SPECS = {
    "quantile": "hist:fleet/t_lat_s:p99 < 0.05",
    "named_quantile": "predict_p99_ms < 50",
    "ratio": "ratio:t/bad|t/total < 0.1",
    "gauge": "gauge:t/depth <= 4",
}


def _drive_engine(mod_slo, mod_obs, kind, min_events):
    """One engine on a private registry fed a fixed observation script,
    evaluated after every step; the rows each evaluation reports."""
    reg = mod_obs.MetricsRegistry()
    eng = mod_slo.SloEngine(mod_slo.parse_specs(_SPECS[kind]),
                            registry=reg, min_events=min_events)
    rng = np.random.default_rng(4)
    rows = []
    for step in range(40):
        if kind in ("quantile", "named_quantile"):
            name = ("predict/latency_s" if kind == "named_quantile"
                    else "fleet/t_lat_s")
            h = mod_obs.latency_histogram(name, reg)
            slow = 0.08 if step >= 25 else 0.002
            for v in rng.uniform(0.5, 1.5, size=7) * slow:
                h.observe(float(v))
        elif kind == "ratio":
            reg.counter("t/total").add(10)
            reg.counter("t/bad").add(int(step >= 30) * 6)
        else:
            reg.gauge("t/depth").set(float(step % 7))
        rows.append(eng.evaluate()["specs"][0])
    return rows


@pytest.mark.parametrize("min_events", [0, 100])
@pytest.mark.parametrize("kind", sorted(_SPECS))
def test_slo_engine_matches_jax(kind, min_events):
    got = _drive_engine(slo, obs, kind, min_events)
    want = _drive_engine(jslo, jobs, kind, min_events)
    for a, b in zip(got, want):
        for k in ("name", "kind", "ok", "current", "events", "bad_events",
                  "budget_remaining", "burn_rate", "exhausted"):
            assert a[k] == b[k], (k, a, b)
        assert a.get("warming") == b.get("warming")
    # the drive burns through the budget: exhaustion latches in both
    assert got[-1]["exhausted"] or kind == "gauge"


@pytest.mark.parametrize("text", [
    "predict_p100_ms < 5", "serve_p99_s < 1", "nonsense < 1",
    "ratio:a < 0.1", "degraded_window_rate > 0.1", "hist:x:q9 < 1",
    "gauge:x 5"])
def test_slo_spec_errors_match_jax(text):
    with pytest.raises(ValueError) as want:
        jslo.parse_specs(text)
    with pytest.raises(ValueError) as got:
        slo.parse_specs(text)
    assert str(got.value) == str(want.value)


def test_slo_global_engine_lifecycle():
    try:
        assert slo.ensure_from_config({"tpu_slo": ""}) is None
        eng = slo.ensure_from_config({"tpu_slo": "staleness_windows <= 2"})
        assert eng is slo.global_engine() and eng.specs[0].kind == "gauge"
        assert slo.ensure_from_config(
            {"tpu_slo": " staleness_windows <= 2 "}) is eng   # idempotent
        assert slo.configure("") is None and slo.global_engine() is None
    finally:
        slo.shutdown()


@pytest.mark.parametrize("v", [0.0, 1e-4, 0.0021, 0.01, 0.0499, 0.05,
                               0.07, 0.2, 5.0])
def test_count_le_matches_jax(v):
    hs = [mod.latency_histogram("x", mod.MetricsRegistry())
          for mod in (obs, jobs)]
    rng = np.random.default_rng(8)
    for x in rng.lognormal(-5, 1.5, size=500):
        for h in hs:
            h.observe(float(x))
    assert hs[0].count_le(v) == hs[1].count_le(v)
    assert hs[0].count_and_le(v) == hs[1].count_and_le(v)


# -- the LRB loop through the daemon -----------------------------------------------

def _windowed(mod, **kw):
    """tests/test_torch_lrb.py (b)'s shape: full TRAIN_PARAMS,
    sequential, 3 windows of 500 requests."""
    drv = mod.LrbDriver(cache_size=1 << 16, window_size=500,
                        sample_size=400, cutoff=0.5, sampling=1,
                        result_file=io.StringIO(),
                        extra_params={"tpu_lrb_pipeline": 0}, **kw)
    try:
        for seq, oid, size, cost in mod.synthetic_trace(1500):
            drv.process_request(seq, oid, size, cost)
        res = drv.results
        daemon = drv._fleet_daemon
        version = (daemon.tenants.get("lrb")[1] if daemon is not None
                   else None)
        return res, version, drv._fleet_warned
    finally:
        drv.close()


def test_lrb_serve_daemon_matches_in_process_and_jax():
    requests0 = obs.counter("fleet/requests_total").value
    res_d, version, warned = _windowed(lrb, serve_daemon=True,
                                       device="cpu")
    served = obs.counter("fleet/requests_total").value - requests0
    res_p, _, _ = _windowed(lrb, device="cpu")
    res_j, jversion, jwarned = _windowed(jlrb, serve_daemon=True)
    assert len(res_d) == len(res_p) == len(res_j) == 3
    for a, b, c in zip(res_d, res_p, res_j):
        for k in PARITY_KEYS:
            assert a.get(k) == b.get(k) == c.get(k), (a["window"], k)
    # every window published, no batch fell back to in-process scoring,
    # and windows 2-3 went through the daemon in 64-row calls
    assert warned == jwarned == 0
    assert version == jversion == 3
    assert served == sum(-(-r["eval_rows"] // 64) for r in res_d
                         if "eval_rows" in r)


def test_lrb_serve_daemon_without_card_raises_at_first_window():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    drv = lrb.LrbDriver(1 << 16, 300, 150, 0.5, 1, serve_daemon=True,
                        result_file=io.StringIO(),
                        extra_params={"num_iterations": 4,
                                      "verbose": -1})
    try:
        assert drv._fleet_daemon is not None
        assert drv._fleet_daemon.tenants.device is None
        with pytest.raises(LightGBMError, match="CUDA"):
            for seq, oid, size, cost in lrb.synthetic_trace(300, 60):
                drv.process_request(seq, oid, size, cost)
    finally:
        drv.close()
