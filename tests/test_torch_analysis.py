"""The port's static analysis (lightgbm_tpu_torch/analysis/) against the
JAX package's (lightgbm_tpu/analysis/) on the CPU.

Bars: on tests/test_analysis.py's fixture sources, the port's ``core``
(baseline), ``lock_discipline`` and ``contracts`` give the JAX
package's finding keys (each under its own package's paths); the
capture checker flags a serving graph keyed without the tree range it
closes over (the form ``ops/stacked_predict.py _replay`` had before its
graphs were kept per (first, ntree)), passes the repaired form, flags
host syncs inside a captured function, and follows ``run_wave``; the
whole port analyzes clean against its baseline, whose capture and
lock_discipline entries are refused; the driver's exit codes are 0, 1
and 2 as tools/run_analysis.py's.
"""
import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest

from lightgbm_tpu.analysis import contracts as jcontracts
from lightgbm_tpu.analysis import lock_discipline as jlock
from lightgbm_tpu.analysis.core import Baseline as JBaseline
from lightgbm_tpu.analysis.core import SourceFile as JSourceFile

from lightgbm_tpu_torch.analysis import capture, contracts, lock_discipline
from lightgbm_tpu_torch.analysis import __main__ as driver
from lightgbm_tpu_torch.analysis.core import (BASELINE_PATH,
                                              NO_BASELINE_CHECKERS,
                                              Baseline, Finding,
                                              SourceFile, UsageError,
                                              iter_sources)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_analysis import LOCK_SRC  # noqa: E402


def _pair(text, rel="synthetic.py"):
    """(port SourceFile, JAX SourceFile) of one fixture, each under its
    package's path when ``rel`` names the JAX package."""
    trel = rel.replace("lightgbm_tpu/", "lightgbm_tpu_torch/", 1)
    return SourceFile(trel, trel, text), JSourceFile(rel, rel, text)


def _keys(findings, pkg=None):
    keys = sorted(f.key for f in findings)
    if pkg:
        keys = [k.replace("lightgbm_tpu_torch/", "lightgbm_tpu/")
                for k in keys]
    return keys


# -- lock_discipline and contracts: the JAX package's keys --------------------

LOCK_FIXTURES = [LOCK_SRC, """
import threading, collections
class Ring:
    def __init__(self):
        self._mu = threading.Lock()
        # guarded-by: _mu
        self._slots: "collections.OrderedDict[int, tuple]" = \\
            collections.OrderedDict()
    def good(self, k, v):
        with self._mu:
            self._slots[k] = v
    def bad(self, k, v):
        self._slots[k] = v
""", """
import threading
class A:
    def __init__(self):
        self._cache = None        # guarded-by: _guard()
    def good(self):
        with self._guard():
            self._cache = 1
    def bad(self):
        with self._other():
            self._cache = 2
""", """
import threading
_lock = threading.Lock()
_steps = {}                       # guarded-by: _lock

def innocent():
    _steps = {"local": "temp"}    # new local, not the global
    return _steps

def guilty_rebind():
    global _steps
    _steps = {}

def guilty_item(k, v):
    _steps[k] = v
""", """
import threading
class A:
    def __init__(self):
        self._lk = threading.Lock()
        self._pending = None      # guarded-by: _lk

    # guarded-by: _lk
    def _drain_locked(self):
        self._pending = None      # body counts as guarded

    def good(self):
        with self._lk:
            self._drain_locked()

    def bad(self):
        self._drain_locked()      # call without the lock
"""]


@pytest.mark.parametrize("i", range(len(LOCK_FIXTURES)))
def test_lock_discipline_keys_equal_jax(i):
    t, j = _pair(LOCK_FIXTURES[i])
    got, want = _keys(lock_discipline.check([t])), _keys(jlock.check([j]))
    assert got == want and got


def _infos(**kw):
    out = []
    for mod in (contracts, jcontracts):
        info = mod.RepoInfo()
        info.config_fields = set(kw.get("fields", {"tpu_known"}))
        info.volatile_knobs = set(kw.get("volatile", ()))
        info.documented_knobs = set(kw.get("documented",
                                           info.config_fields))
        info.validated_knobs = set(kw.get("validated", ()))
        out.append(info)
    return out


KNOB_FIXTURES = [
    ("""
def f(cfg, params):
    a = cfg.tpu_known
    b = params.get("tpu_unknown", 0)
    return a, b
""", "lightgbm_tpu/models/x.py", {}),
    ("""
def f(autotune):
    return autotune.tpu_compiler_params()
""", "lightgbm_tpu/ops/x.py", {}),
    ("def f(c):\n    return c.tpu_known\n", "lightgbm_tpu/obs/x.py", {}),
    ("def f(c):\n    return c.tpu_known\n", "lightgbm_tpu/obs/x.py",
     {"volatile": {"tpu_known"}}),
    ("def f(c):\n    return c.tpu_known\n", "lightgbm_tpu/obs/x.py",
     {"volatile": {"tpu_known", "tpu_renamed_away"}}),
    ("def f(c):\n    return c.tpu_known\n", "lightgbm_tpu/models/x.py",
     {"fields": {"tpu_known", "tpu_undocumented"},
      "documented": {"tpu_known"}}),
]


@pytest.mark.parametrize("i", range(len(KNOB_FIXTURES)))
def test_contracts_knob_keys_equal_jax(i):
    text, rel, kw = KNOB_FIXTURES[i]
    t, j = _pair(text, rel)
    ti, ji = _infos(**kw)
    assert _keys(contracts.check_knobs([t], ti), "jax") == \
        _keys(jcontracts.check_knobs([j], ji))


CONTRACT_FIXTURES = [
    ("""
def f(obs, label):
    obs.counter("good/name").add(1)
    obs.counter("Bad-Name").add(1)
    obs.counter(f"dyn/{label}").add(1)
    # bounded-cardinality: label comes from a closed enum
    obs.counter(f"dyn2/{label}").add(1)
""", "lightgbm_tpu/obs/x.py"),
    ("""
def f(path):
    with open(path) as fh:              # read: fine
        fh.read()
    with open(path, "a") as fh:         # append stream: fine
        fh.write("x")
    with open(path, "w") as fh:         # torn-file hazard
        fh.write("x")
    # atomic-ok: crash-only debug dump, no concurrent reader
    with open(path, "w") as fh:
        fh.write("x")
""", "lightgbm_tpu/obs/x.py"),
    ("def f(p):\n    open(p, 'w').write('x')\n", "lightgbm_tpu/models/x.py"),
    ("""
def f(p):
    with open(p, "w") as fh:
        fh.write("x")
""", "lightgbm_tpu/utils/fileio.py"),
]


@pytest.mark.parametrize("i", range(len(CONTRACT_FIXTURES)))
def test_contracts_metric_and_artifact_keys_equal_jax(i):
    text, rel = CONTRACT_FIXTURES[i]
    t, j = _pair(text, rel)
    got = _keys(contracts.check_metrics([t]) + contracts.check_artifacts([t]),
                "jax")
    want = _keys(jcontracts.check_metrics([j])
                 + jcontracts.check_artifacts([j]))
    assert got == want


def test_contracts_validate_through_the_config_tables():
    """The port validates its knobs table-driven: a knob named in a
    module-level table that ``check_param_conflict`` reads is validated;
    one in a table it does not read is not."""
    sf = SourceFile("lightgbm_tpu_torch/config.py",
                    "lightgbm_tpu_torch/config.py", """
_TABLE = ("tpu_a",)
_OTHER = ("tpu_b",)
class Config:
    tpu_a: int = 0
    tpu_b: int = 0
    def check_param_conflict(self):
        for key in _TABLE:
            pass
""")
    info = contracts.RepoInfo()
    contracts._parse_config(sf, info)
    assert info.validated_knobs == {"tpu_a"}
    info.documented_knobs = set(info.config_fields)
    fs = contracts.check_knob_validation([sf], info)
    assert [f.detail for f in fs] == ["tpu_b"]


def _finding(checker="contracts", rule="r", detail="d"):
    return Finding(checker, rule, "a.py", 3, "msg", detail)


def test_baseline_round_trip_equals_jax(tmp_path):
    f1, f2 = _finding(detail="one"), _finding(detail="two")
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({
        "version": 1,
        "entries": [{"key": f1.key, "justification": "known"},
                    {"key": "contracts:r:a.py:gone",
                     "justification": "stale"}]}))
    kept, suppressed, stale = Baseline.load(str(path)).apply([f1, f2])
    jkept, jsup, jstale = JBaseline.load(str(path)).apply([f1, f2])
    assert [f.key for f in kept] == [f.key for f in jkept] == [f2.key]
    assert (suppressed, stale) == (jsup, jstale) == \
        (1, ["contracts:r:a.py:gone"])
    doc = Baseline.load(str(path)).dump([f1, f2])
    assert doc == JBaseline.load(str(path)).dump([f1, f2])


@pytest.mark.parametrize("checker", NO_BASELINE_CHECKERS)
def test_baseline_refuses_capture_and_lock_entries(tmp_path, checker):
    assert NO_BASELINE_CHECKERS == ("capture", "lock_discipline")
    path = tmp_path / f"{checker}.json"
    path.write_text(json.dumps({
        "version": 1, "entries": [{"key": f"{checker}:r:a.py:d",
                                   "justification": "nope"}]}))
    with pytest.raises(UsageError):
        Baseline.load(str(path))


# -- the capture checker -------------------------------------------------------

def _capture(text):
    sf = SourceFile("fixture.py", "fixture.py", text)
    return capture.check([sf], {"learning_rate"})


REPLAY_KEYED_BY_PLAN = '''
from ..utils.device import capture_graph


class StackedModel:
    def _replay(self, memo: list, rows, first: int, ntree: int):
        entry, graphs = memo
        with entry.lock:
            st = entry.staging()
            graph = graphs.get(entry.plan)
            if graph is None:
                # capture: ok(self) — the graph is kept in this
                # model's memo: the tables it reads are this model's
                run = lambda: self._stage_and_launch(st, first, ntree)
                run()
                graphs[entry.plan] = capture_graph(run, self.device)
            else:
                graph.replay()
            st.done.record()
            st.done.synchronize()

    def _stage_and_launch(self, st, first: int, ntree: int) -> None:
        st.x_dev.copy_(st.x_host, non_blocking=True)
        forest_predict_from_x(st.x_dev, self.edges, self.forest, first,
                              ntree, out=st.out_dev)
'''

REPLAY_KEYED_BY_RANGE = REPLAY_KEYED_BY_PLAN.replace(
    "graph = graphs.get(entry.plan)",
    "rng = (first, ntree)\n            graph = graphs.get(rng)").replace(
    "graphs[entry.plan] = capture_graph", "graphs[rng] = capture_graph")


def test_capture_flags_a_graph_keyed_without_its_range():
    """The serving graph stored under the plan closes over the tree
    range: flagged; stored under ``rng = (first, ntree)``: clean."""
    fs = _capture(REPLAY_KEYED_BY_PLAN)
    assert sorted(f.detail for f in fs) == [
        "StackedModel._replay.<lambda>:first",
        "StackedModel._replay.<lambda>:ntree"], [f.render() for f in fs]
    assert all(f.rule == "nonstatic-capture" for f in fs)
    assert _capture(REPLAY_KEYED_BY_RANGE) == []


def test_capture_flags_host_syncs_and_follows_methods():
    """A host sync inside the captured function, or inside a method of
    the class it calls, is a finding; an ``ok(sync)`` waiver with a
    reason clears the function's."""
    src = REPLAY_KEYED_BY_RANGE.replace(
        "        st.x_dev.copy_(st.x_host, non_blocking=True)\n",
        "        st.x_dev.copy_(st.x_host, non_blocking=True)\n"
        "        if (st.x_dev > 0).any():\n"
        "            n = st.x_dev.sum().item()\n"
        "        idx = st.x_dev.nonzero()\n"
        "        torch.cuda.synchronize()\n")
    fs = _capture(src)
    what = sorted(f.detail.rsplit(":", 1)[-1] for f in fs)
    assert what == [".item()", ".synchronize()", "a", "nonzero()"], \
        [f.render() for f in fs]
    assert all(f.rule == "host-sync" for f in fs)
    sized = src.replace("st.x_dev.nonzero()", "st.x_dev.nonzero(size=4)")
    assert len(_capture(sized)) == 3
    waived = src.replace(
        "    def _stage_and_launch",
        "    # capture: ok(sync) — a probe run on a card outside serving\n"
        "    def _stage_and_launch")
    assert len(_capture(waived)) == 4      # the waiver is the lambda's own
    waived = src.replace("# capture: ok(self) —",
                         "# capture: ok(self, sync) —")
    assert _capture(waived) == []


WAVE_SRC = '''
import torch


def grow(bins, grad, state, n: int):
    keep = state.keep
    hg = keep("hg", grad)
    pool = keep("pool", torch.zeros((4, 8)))
    scale = grad.sum()
    mask = hg > 0
    nl = keep("nl", torch.tensor(1))

    def elect():
        nl.add_(1)

    def wave(k):
        pool[:k] += hg[:k].sum() * scale
        pool[0] = mask.float().sum()
        elect()

    for _ in range(n):
        k = 3
        state.run_wave(k, lambda: wave(k))
'''


def test_capture_follows_run_wave_and_nested_functions():
    """``run_wave``'s function is audited through the nested functions
    it calls: the state's tensors and the key ``k`` pass, a per-call
    tensor (a sum, a comparison on a state's tensor) is flagged."""
    fs = _capture(WAVE_SRC)
    assert sorted(f.detail for f in fs) == ["grow.wave:mask",
                                            "grow.wave:scale"], \
        [f.render() for f in fs]
    src = WAVE_SRC.replace(
        "    def wave(k):",
        "    # capture: ok(scale, mask) — fixture: waived with a reason\n"
        "    def wave(k):")
    assert _capture(src) == []
    src = WAVE_SRC.replace(
        "    def wave(k):",
        "    # capture: ok(scale, mask)\n    def wave(k):")
    assert len(_capture(src)) == 2          # a waiver needs its reason


def test_capture_flags_an_unresolvable_function():
    fs = _capture('''
def f(graphs, make, dev):
    graphs[0] = capture_graph(make(), dev)
''')
    assert [f.rule for f in fs] == ["unresolvable"]


# -- the whole port -------------------------------------------------------------

def test_port_analyzes_clean_against_its_baseline():
    """Every finding on the port is baselined (contracts only, each with
    a reason) and no entry is stale; the capture and lock_discipline
    baselines are empty, and both checkers have sites to check."""
    baseline = Baseline.load(os.path.join(REPO, BASELINE_PATH))
    assert baseline.entries
    assert not any(k.split(":", 1)[0] in NO_BASELINE_CHECKERS
                   for k in baseline.entries)
    kept, _, stale = baseline.apply(driver.run_checkers(REPO))
    assert kept == [] and stale == [], [f.render() for f in kept]
    sources = {sf.rel: sf for sf in iter_sources(REPO)}
    assert "lightgbm_tpu_torch/ops/wave_grower.py" in sources
    assert "chip_smoke.py" in sources
    text = "".join(sf.text for sf in sources.values())
    assert text.count("# guarded-by:") >= 20
    assert text.count("capture_graph(") >= 2


def test_driver_exit_codes_and_json(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        assert driver.main(["--json"]) == 0
    doc = json.loads(out.getvalue())
    assert doc["clean"] and doc["findings"] == []
    bad = tmp_path / "b.json"
    bad.write_text(json.dumps({"version": 1, "entries": [
        {"key": "capture:r:a.py:d", "justification": "nope"}]}))
    with redirect_stdout(io.StringIO()):
        assert driver.main(["--baseline", str(bad)]) == 2
        assert driver.main(["--root", str(tmp_path)]) == 2
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"version": 1, "entries": []}))
    with redirect_stdout(io.StringIO()):
        assert driver.main(["--baseline", str(empty)]) == 1
