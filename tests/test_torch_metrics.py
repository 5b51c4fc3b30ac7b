"""The metrics heartbeat (TPU_METRICS) and `--status` against avida_tpu's:
metrics.prom and its history ring from a run with the clock pinned, the
`--status` output and exit codes of both command lines on one data dir
(the port's importing no torch), the batch heartbeat of a MultiWorld,
and the history and alert functions (observability/history.py,
alerts.py -- copies of the reference's) on the reference's own test
inputs (tests/test_alerts.py).

Inputs: an 8x8 InjectAll world (RANDOM_SEED 5, AVE_TIME_SLICE 100) run 5
updates on the micro-step engine in both packages with time.time pinned;
the fixed samples and rules of tests/test_alerts.py.

Tolerance: exact -- file bytes, printed text, exit codes and returned
values equal.
"""

import json
import os
import subprocess
import sys
import time

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu.config import AvidaConfig as RefConfig  # noqa: E402
from avida_tpu.observability import alerts as ralerts  # noqa: E402
from avida_tpu.observability import exporter as rexporter  # noqa: E402
from avida_tpu.observability import history as rhistory  # noqa: E402

from avida_tpu_torch.config import AvidaConfig as PortConfig  # noqa: E402
from avida_tpu_torch.observability import alerts as talerts  # noqa: E402
from avida_tpu_torch.observability import exporter as texporter  # noqa: E402
from avida_tpu_torch.observability import history as thistory  # noqa: E402

from test_torch_world import _pair  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = 1_700_000_000.0
VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5, AVE_TIME_SLICE=100,
            TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0,
            TPU_USE_PALLAS=2, TPU_METRICS=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset_process_counters():
    """Zero the process-wide counters whose families ride every
    heartbeat once non-zero: both packages' integrity and profiler
    counters, and the reference's program-cache counters.  A test that
    ran a digest, a profile or a cached compile earlier in the same
    worker would otherwise add families to one package's file only."""
    from avida_tpu.observability import profiler as rprofiler
    from avida_tpu.utils import compilecache as rcompilecache
    from avida_tpu.utils import integrity as rintegrity
    from avida_tpu_torch.observability import profiler as tprofiler
    from avida_tpu_torch.utils import integrity as tintegrity
    for mod in (rintegrity, tintegrity, rprofiler, tprofiler,
                rcompilecache):
        mod.reset_for_tests()


def _run_pair(tmp):
    """Both packages' worlds run 5 updates with TPU_METRICS=1 and the
    clock pinned (the heartbeat timestamp and the ring rows read it),
    from zeroed process counters."""
    _reset_process_counters()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: PINNED)
        ref, port = _pair(tmp, VALS, ["u begin InjectAll"])
        ref.run(max_updates=5)
        port.run(max_updates=5)
    return tmp, ref, port


@pytest.fixture(scope="module")
def metrics_run(tmp_path_factory):
    return _run_pair(tmp_path_factory.mktemp("metrics"))


def _assert_files_equal(run, name):
    tmp, _, port = run
    a = (tmp / "ref" / name).read_bytes()
    b = (tmp / "port" / name).read_bytes()
    assert a == b and b"avida_update" in b
    assert port.update == 5 and int(port._total_births) > 0


@pytest.mark.parametrize("name", ["metrics.prom", "metrics.hist.jsonl"])
def test_metrics_files_equal_reference(metrics_run, name):
    """The final heartbeat and its history ring (one row per chunk
    boundary publish), byte for byte."""
    _assert_files_equal(metrics_run, name)


def test_metrics_files_equal_reference_after_a_digest(tmp_path):
    """The order fault of a shared test worker: a port world that
    digested its state earlier in the process leaves avida_integrity_*
    counters behind, and the next heartbeat of the port alone carried
    them.  The pair run zeroes both packages' counters first."""
    from avida_tpu_torch.utils import integrity as tintegrity
    from avida_tpu_torch.world import World
    w = World(overrides=[("WORLD_X", "4"), ("WORLD_Y", "4"),
                         ("TPU_STATE_DIGEST", "1")],
              data_dir=str(tmp_path / "digest"), device="cpu")
    w.run(max_updates=2)
    assert tintegrity.counters()["digest_ms"] > 0
    run = _run_pair(tmp_path / "pair")
    for name in ("metrics.prom", "metrics.hist.jsonl"):
        _assert_files_equal(run, name)


_STATUS = r"""
import runpy, sys, time
time.time = lambda: {now!r}
try:
    runpy.run_module({pkg!r}, run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code
print("TORCH", "torch" in sys.modules)
sys.exit(rc)
"""


def _status(pkg, args, now):
    res = subprocess.run(
        [sys.executable, "-c", _STATUS.format(now=now, pkg=pkg)] + args,
        cwd=REPO, capture_output=True, text=True, timeout=120)
    out, _, flag = res.stdout.rpartition("TORCH ")
    return res.returncode, out, flag.strip()


@pytest.mark.parametrize("case", ["fresh", "no_max_age", "stale",
                                  "missing"])
def test_status_cli_equals_reference(metrics_run, case):
    """`python -m avida_tpu --status DIR` and `python -m avida_tpu_torch
    --status DIR` (clock pinned in both) on the port's data dir: the same
    lines and exit code (0 fresh, 2 staler than --max-age, 1 no
    metrics.prom); the port's process never imports torch."""
    tmp, _, _ = metrics_run
    d = str(tmp / ("nowhere" if case == "missing" else "port"))
    args = ["--status", d]
    now = PINNED + 30.0
    if case in ("fresh", "missing"):
        args += ["--max-age", "600"]
    elif case == "stale":
        args += ["--max-age", "10"]
    want = _status("avida_tpu", args, now)
    got = _status("avida_tpu_torch", args, now)
    assert got[:2] == want[:2]
    assert got[0] == {"fresh": 0, "no_max_age": 0, "stale": 2,
                      "missing": 1}[case]
    assert got[2] == "False"
    if case != "missing":
        assert "heartbeat   30.0s ago" in got[1]


def test_multiworld_heartbeat_and_member_refusals(tmp_path):
    """A two-world batch with TPU_METRICS=1 publishes metrics.prom (the
    batch aggregates) and multiworld.prom (a row per world); members
    with a flight recorder or a fault plan are refused with the
    reference's reason, and --serve-worlds with no control file exits
    2."""
    from avida_tpu_torch.__main__ import main
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    mw = MultiWorld.from_seeds([1, 2], overrides=[
        ("WORLD_X", "4"), ("WORLD_Y", "4"), ("TPU_METRICS", "1")],
        data_dir=str(tmp_path / "mw"), device="cpu")
    mw.run(max_updates=2)
    agg = texporter.read_metrics(str(tmp_path / "mw" / "metrics.prom"))
    rows = texporter.multiworld_rows(texporter.read_metrics(
        str(tmp_path / "mw" / "multiworld.prom")))
    assert agg["avida_update"] == 2 and sorted(rows) == ["w000", "w001"]
    assert agg["avida_organisms"] == sum(
        r["avida_organisms"] for r in rows.values())
    for name, value in (("TPU_TRACE", "1"),
                        ("TPU_FAULT", "crash@update=9")):
        with pytest.raises(ValueError, match="does not slice the flight "
                                             "recorder, live analytics or "
                                             "fault-injection"):
            MultiWorld.from_seeds([1, 2], overrides=[(name, value)],
                                  data_dir=str(tmp_path / name),
                                  device="cpu")
    assert main(["--serve-worlds", "ctl", "--device", "cpu"]) == 2


# ---- history and alerts on the reference's own test inputs ----

def _mk(values_by_time):
    return [{"record": "sample", "time": t, "v": v}
            for t, v in sorted(values_by_time.items())]


def _plain(x):
    """Rules and other objects as comparable plain values."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "__slots__"):
        return {k: _plain(getattr(x, k)) for k in x.__slots__}
    if hasattr(x, "__dict__"):
        return {k: _plain(v) for k, v in vars(x).items()}
    return x


def _roundtrip(h, a, d, cfg):
    ring = os.path.join(d, "metrics.hist.jsonl")
    for i in range(5):
        h.append_sample(ring, {"avida_update": i * 4, "x": 1.5},
                        now=100.0 + i)
    return [h.read_samples(ring),
            h.read_samples(ring, window_sec=2.5, now=104.0),
            h.read_samples(ring, tail_bytes=200)]


def _rotation(h, a, d, cfg):
    ring = os.path.join(d, "metrics.hist.jsonl")
    for i in range(200):
        h.append_sample(ring, {"avida_update": i, "pad": 123456.0},
                        now=1000.0 + i, max_bytes=2048)
    with open(ring, "a") as f:
        f.write('{"record": "sample", "time": 99')
    return [os.path.getsize(ring), os.path.getsize(ring + ".1"),
            h.read_samples(ring)]


def _sink(h, a, d, cfg):
    prom = os.path.join(d, "metrics.prom")
    off = h.HistorySink(prom, env={"TPU_METRICS_HIST": "0"})
    off.publish("avida_update 7\n")
    gone = os.path.exists(h.hist_path(prom))
    every = h.HistorySink(prom, env={"TPU_METRICS_HIST_EVERY": "3"})
    for _ in range(7):
        every.publish("avida_update 7\n")
    c = cfg()
    c.TPU_METRICS_HIST = 0
    return [gone, len(h.read_samples(h.hist_path(prom))),
            h.HistorySink(prom, env={}, cfg=c).knobs.enabled,
            h.HistorySink(prom, env={"TPU_METRICS_HIST": "1"},
                          cfg=c).knobs.enabled]


def _prune(h, a, d, cfg):
    ring = os.path.join(d, "metrics.hist.jsonl")
    for i in range(300):
        h.append_sample(ring, {"avida_update": i}, now=float(i),
                        max_bytes=4096)
    return [h.prune(ring, keep_bytes=512), h.read_samples(ring)[-3:]]


def _rules_eval(h, a, d, cfg):
    out = []
    r = a.Rule("hot", "q", "threshold", 3.0, op=">")
    high = _mk({100.0: {"q": 1.0}, 101.0: {"q": 9.0}})
    out += [a.evaluate_rule(r, high, 102.0),
            a.evaluate_rule(r, high + _mk({103.0: {"q": 2.0}}), 104.0),
            a.evaluate_rule(r, [], 104.0)]
    r = a.Rule("hot", "q", "threshold", 3.0, op=">", for_sec=10.0)
    s = _mk({100.0: {"q": 1.0}, 105.0: {"q": 9.0}, 112.0: {"q": 8.0}})
    out += [a.evaluate_rule(r, s, 110.0), a.evaluate_rule(r, s, 116.0)]
    r = a.Rule("stall", "avida_update", "rate", 0.0, op="<=",
               window_sec=60.0)
    flat = _mk({float(t): {"avida_update": 42.0}
                for t in range(100, 200, 10)})
    out += [a.evaluate_rule(r, flat, 190.0), a.evaluate_rule(r, flat, 400.0)]
    r = a.Rule("stale", "hb", "staleness", 30.0, for_sec=20.0)
    s = _mk({100.0: {"hb": 100.0}})
    out += [a.evaluate_rule(r, s, 140.0), a.evaluate_rule(r, s, 151.0)]
    r = a.Rule("collapse", "eff", "threshold", 0.2, op="<")
    s = _mk({100.0: {'eff{world="a"}': 0.05, 'eff{world="b"}': 0.9}})
    out.append(a.evaluate_rule(r, s, 101.0))
    metrics = _mk({float(t): {"avida_update": 5000.0 + t}
                   for t in range(100, 200, 5)})
    out.append(a.evaluate(a.default_rules(), {"metrics": metrics}, 195.0))
    return out


def _rule_errors(h, a, d, cfg):
    msgs = []
    for bad in ({"name": "x", "family": "f", "kind": "threshold",
                 "value": 1, "threshold": 2},
                {"name": "x", "family": "f", "kind": "threshold"},
                {"name": "x", "family": "f", "kind": "threshold",
                 "value": None},
                ["not", "a", "rule"],
                {"name": "x", "family": "f", "kind": "derivative",
                 "value": 1}):
        try:
            a.Rule.from_dict(bad)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def _load_rules(h, a, d, cfg):
    with open(os.path.join(d, "alerts.json"), "w") as f:
        json.dump([
            {"name": "stall", "family": "avida_update", "kind": "rate",
             "op": "<=", "value": 0.0, "window_sec": 7.0},
            {"name": "queue_growth", "family": "avida_fleet_queue_depth",
             "kind": "rate", "value": 0, "enabled": False},
            {"name": "custom", "family": "avida_organisms",
             "kind": "threshold", "op": "<", "value": 2.0}], f)
    return [_plain(a.load_rules()), _plain(a.load_rules(d))]


def _plane(h, a, d, cfg):
    journal = os.path.join(d, "alerts.jsonl")
    plane = a.AlertPlane([a.Rule("hot", "q", "threshold", 3.0, op=">",
                                 severity="page")], journal_path=journal)
    high = _mk({100.0: {"q": 9.0}})
    edges = [plane.observe(high, 101.0), plane.observe(high, 102.0),
             plane.observe(high + _mk({103.0: {"q": 1.0}}), 104.0)]
    recs = a.read_alert_records(journal)
    for r in recs:
        r.pop("time", None)
    return [edges, recs, plane.families()]


def _status_lines(h, a, d, cfg):
    m = {'avida_alerts_firing{rule="stall"}': 1.0,
         'avida_alerts_firing{rule="hot"}': 0.0,
         'avida_alerts_fired_total{rule="stall"}': 3.0,
         'avida_alerts_fired_total{rule="hot"}': 0.0}
    ring = os.path.join(d, "metrics.hist.jsonl")
    ex = texporter if h is thistory else rexporter
    metrics = {"avida_update": 40, "avida_organisms": 3,
               "avida_heartbeat_timestamp_seconds": 1000.0,
               "avida_trace_events_total": 9.0,
               "avida_trace_dropped_total": 1.0}
    out = [a.firing_from_metrics(m), a.format_alert_status(m),
           ex.format_status(metrics, now=1000.0, hist_path=ring)]
    for t in range(900, 1001, 10):
        h.append_sample(ring, {"avida_update": float(t - 900)},
                        now=float(t))
    out.append(ex.format_status(metrics, now=1000.0, hist_path=ring))
    mw = {"avida_multiworld_size": 2.0,
          "avida_multiworld_batch_efficiency": 0.75,
          'avida_update{world="w000"}': 8.0,
          'avida_organisms{world="w000"}': 12.0,
          'avida_multiworld_straggler_lag_updates{world="w000"}': 0.0,
          'avida_update{world="w001"}': 8.0,
          'avida_organisms{world="w001"}': 10.0,
          'avida_multiworld_straggler_lag_updates{world="w001"}': 1.5}
    out.append(ex.format_multiworld_status(mw))
    out.append(ex.format_analytics_status(
        metrics, {"avida_analytics_census_update": 32.0,
                  "avida_analytics_tasks_held_mask": 5.0}))
    return out


_CASES = {
    "hist_path": lambda h, a, d, cfg: [h.hist_path("/d/metrics.prom"),
                                       h.hist_path("/d/fleet.prom"),
                                       h.hist_path("/d/odd.txt")],
    "parse_exposition": lambda h, a, d, cfg: h.parse_exposition(
        "# HELP avida_update updates\n# TYPE avida_update counter\n"
        "avida_update 12\n" 'avida_trace_code_total{code="birth"} 3\n'
        "garbage line without number trailing\n"),
    "roundtrip": _roundtrip,
    "rotation": _rotation,
    "sink_knobs": _sink,
    "series": lambda h, a, d, cfg: [
        h.series(_mk({1.0: {'f{world="a"}': 2.0, 'f{world="b"}': 5.0,
                            "g": 1.0}}), "f"),
        h.series(_mk({1.0: {'f{world="a"}': 2.0}}), "f",
                 labels='world="a"')],
    "summarize": lambda h, a, d, cfg: [
        h.summarize(_mk({float(t): {"c": float(t * 2)}
                         for t in range(10, 21)}), "c", now=20.0),
        h.summarize([], "absent")],
    "prune": _prune,
    "rules_evaluate": _rules_eval,
    "rule_errors": _rule_errors,
    "load_rules": _load_rules,
    "alert_plane": _plane,
    "status_lines": _status_lines,
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_history_and_alerts_equal_reference(tmp_path, case):
    fn = _CASES[case]
    out = {}
    for side, h, a, cfg in (("ref", rhistory, ralerts, RefConfig),
                            ("port", thistory, talerts, PortConfig)):
        d = tmp_path / side
        d.mkdir()
        out[side] = json.loads(json.dumps(_plain(fn(h, a, str(d), cfg)),
                                          default=str))
    assert out["ref"] == out["port"]
