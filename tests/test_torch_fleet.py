"""The port's fleet orchestrator (service/fleet.py, tools/fleet_tool.py,
the batchability classes of service/serve.py) against avida_tpu's: every
non-slow fleet scenario of the reference's tests/test_fleet.py, the
fleet scenarios of tests/test_serve.py that need no serve pool and the
two fleet scenarios of tests/test_alerts.py, each driven through both
packages with the same spool contents, the same scripted stub children
and the same fake clock; a spool each package's orchestrator wrote, read
by the other; `python -m avida_tpu_torch --fleet` never importing torch;
and one drill with real children on the CPU.

Inputs: the reference tests' fakes (FakeClock, FakeProc and
_write_metrics of tests/test_supervisor.py; StubChildren and
PreemptibleProc of tests/test_fleet.py) and each package's own
fleet_tool writing the specs.

Tolerance: exact -- exit codes, the normalised journals (event, job and
every field, with times and pids removed and the spool root masked), the
final job states, fleet.prom's values (all but the heartbeat
timestamp), the quarantined `.bad-*` names, the files of the spool, and
each spawn's argv (with `avida_tpu` read as `avida_tpu_torch`) equal;
the real-child drill's final generations byte for byte an uninterrupted
run's.

One difference is deliberate.  On a crash storm that implicates the
kernel the reference degrades the whole fleet to its XLA path: it
journals `xla_fallback`, relaunches every job with `-set TPU_USE_PALLAS
2` and sets avida_fleet_xla_fallback to 1.  The port never routes a job
around its kernel: test_kernel_storm_pauses_without_degrading holds its
journal to the reference's minus that record, its spawns to the
reference's minus that override, and the gauge at 0.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import fleet_tool as rtool  # noqa: E402
from avida_tpu.observability import alerts as ralerts  # noqa: E402
from avida_tpu.observability import history as rhistory  # noqa: E402
from avida_tpu.observability.exporter import \
    read_metrics as rread_metrics  # noqa: E402
from avida_tpu.observability.runlog import (  # noqa: E402
    append_record as rappend, read_records as rread)
from avida_tpu.service import fleet as rfleet  # noqa: E402
from avida_tpu.service import serve as rserve  # noqa: E402

from avida_tpu_torch.observability import alerts as talerts  # noqa: E402
from avida_tpu_torch.observability import history as thistory  # noqa: E402
from avida_tpu_torch.observability.exporter import \
    read_metrics as tread_metrics  # noqa: E402
from avida_tpu_torch.observability.records import (  # noqa: E402
    append_record as tappend, read_records as tread)
from avida_tpu_torch.service import fleet as tfleet  # noqa: E402
from avida_tpu_torch.service import serve as tserve  # noqa: E402
from avida_tpu_torch.tools import fleet_tool as ttool  # noqa: E402
from avida_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

import test_supervisor as ts  # noqa: E402
from test_fleet import PreemptibleProc, StubChildren  # noqa: E402

PINNED = 1_700_000_000.0
PKGS = {
    "ref": SimpleNamespace(
        name="ref", fleet=rfleet, serve=rserve, tool=rtool, alerts=ralerts,
        history=rhistory, read_records=rread, append_record=rappend,
        read_metrics=rread_metrics, module="avida_tpu"),
    "port": SimpleNamespace(
        name="port", fleet=tfleet, serve=tserve, tool=ttool, alerts=talerts,
        history=thistory, read_records=tread, append_record=tappend,
        read_metrics=tread_metrics, module="avida_tpu_torch"),
}
JOURNAL = "fleet.jsonl"

# the reference tests' job-supervisor knobs: crash loops resolve in a
# handful of fake seconds
SUP_ENV = {"TPU_WATCHDOG_SEC": "10", "TPU_SUPERVISE_POLL_SEC": "0.5",
           "TPU_SUPERVISE_GRACE_SEC": "30",
           "TPU_SUPERVISE_MAX_RETRIES": "3",
           "TPU_SUPERVISE_BACKOFF_BASE": "0.1",
           "TPU_SUPERVISE_BACKOFF_CAP": "0.5",
           "TPU_SUPERVISE_HEALTHY_SEC": "1000000000"}
SERVE_ENV = dict(SUP_ENV, TPU_SUPERVISE_MAX_RETRIES="2")
ARGS = ["-u", "40", "-set", "WORLD_X", "8", "-set", "WORLD_Y", "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers: one package's orchestrator on stub children, and the snapshot
# of what it left behind
# ---------------------------------------------------------------------------

def _cfg(P, **kw):
    base = dict(max_jobs=2, poll_sec=0.5, breaker_k=3, breaker_sec=60.0,
                drain_sec=30.0)
    base.update(kw)
    return P.fleet.FleetConfig(**base)


def _orch(P, spool, clk, stubs, env=SUP_ENV, **cfg_kw):
    return P.fleet.FleetOrchestrator(spool, cfg=_cfg(P, **cfg_kw),
                                     env=dict(env), clock=clk,
                                     sleep=clk.sleep,
                                     spawn_factory=stubs.factory)


def _mk_fleet(P, root, clk, scripts, env=SUP_ENV, **cfg_kw):
    spool = str(root / "spool")
    stubs = StubChildren(clk, scripts)
    return _orch(P, spool, clk, stubs, env, **cfg_kw), spool, stubs


def _drive(fleet, clk, max_ticks=400):
    for _ in range(max_ticks):
        if not fleet.poll_once():
            return
        clk.sleep(0.5)
    raise AssertionError("fleet did not drain within the tick budget")


def _events(P, spool):
    recs = [r for r in P.read_records(os.path.join(spool, JOURNAL))
            if r.get("record") == "fleet"]
    return [(r["event"], r.get("job")) for r in recs], recs


def _mask(obj, spool):
    return json.loads(json.dumps(obj).replace(str(spool), "<spool>"))


def _snap(P, spool, stubs=(), fleet=None, **extra):
    """Everything an orchestrator left behind, comparable across the two
    packages: journal records without times and pids, job states (the
    orchestrator's and the journal's), fleet.prom's values without the
    heartbeat, the spool's files, each spawn's argv."""
    recs = []
    for r in P.read_records(os.path.join(spool, JOURNAL)):
        r = dict(r)
        r.pop("time", None)
        r.pop("pid", None)
        recs.append(r)
    prom = os.path.join(spool, "fleet.prom")
    m = P.read_metrics(prom) if os.path.exists(prom) else None
    if m is not None:
        m.pop("avida_fleet_heartbeat_timestamp_seconds")
    files = []
    if os.path.isdir(spool):
        for d, _, fs in os.walk(spool):
            files += [os.path.relpath(os.path.join(d, f), spool) for f in fs]
    spawns = []
    for name, _proc, argv in getattr(stubs, "spawned", ()):
        assert argv[1:3] == ["-m", P.module]
        spawns.append([name] + list(argv[3:]))
    state, pids, xla = P.fleet.journal_states(os.path.join(spool, JOURNAL))
    return _mask({
        "journal": recs,
        "jobs": (None if fleet is None
                 else {n: j.state for n, j in sorted(fleet.jobs.items())}),
        "journal_states": [state, sorted(pids), xla],
        "prom": m,
        "bad": sorted(f for f in files if os.path.basename(f)
                      .startswith(".bad-")),
        "files": sorted(files),
        "spawns": spawns,
        **extra}, spool)


def _submit(P, spool, name, argv, **kw):
    return os.path.relpath(P.tool.submit(spool, name, argv, **kw), spool)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_fleet.py: each runs the reference test's
# body against one package and returns its snapshot
# ---------------------------------------------------------------------------

def sc_validate_spec_rejects_garbage(P, root, clk):
    P.fleet.validate_spec({"argv": ["-u", "1"]})
    P.fleet.validate_spec({"argv": ["-u", "1"], "fault_plan": ["crash"],
                           "env": {"A": "1"}})
    errors = []
    for bad in ([], {"argv": []}, {"argv": "nope"}, {"argv": [1, 2]},
                {"x": 1}, {"argv": ["-u"], "fault_plan": "crash"},
                {"argv": ["-u"], "env": {"A": 1}},
                {"argv": ["-u"], "batch": "yes"},
                {"argv": ["-u"], "tenant": 3}):
        with pytest.raises(ValueError) as e:
            P.fleet.validate_spec(bad)
        errors.append(str(e.value))
    return {"errors": errors,
            "legal": [P.fleet.legal_name(n) for n in (
                "ok", "a.b-c_d", "fleet", "fleet.prom", "x.cancel",
                "x.cancelled", "x.requeue", ".h", "bad name", "")]}


def sc_quarantines_malformed_specs_once(P, root, clk):
    spool = str(root / "spool")
    os.makedirs(spool)
    with open(os.path.join(spool, "broken.json"), "w") as f:
        f.write("{this is not json")
    with open(os.path.join(spool, "noargv.json"), "w") as f:
        json.dump({"x": 1}, f)
    _submit(P, spool, "good", ["-u", "5"])
    fleet, spool, stubs = _mk_fleet(
        P, root, clk,
        {"good": [lambda: ts.FakeProc(clk, code=0, runtime=1.0)]})
    rc = fleet.run()
    assert rc == 1
    assert {n: j.state for n, j in fleet.jobs.items()} == {
        "broken": "quarantined", "noargv": "quarantined", "good": "done"}
    events, _ = _events(P, spool)
    assert events.count(("quarantined", "broken")) == 1
    assert events.count(("quarantined", "noargv")) == 1
    m = P.read_metrics(os.path.join(spool, "fleet.prom"))
    assert m['avida_fleet_jobs{state="quarantined"}'] == 2
    return _snap(P, spool, stubs, fleet, rc=rc)


def sc_fleet_tool_submit_validates(P, root, clk):
    spool = str(root / "spool")
    errors = []
    for bad in ("bad name", "fleet", "fleet.prom", "fleet.jsonl",
                "fleet.lock", ".hidden"):
        with pytest.raises(ValueError, match="illegal job name") as e:
            P.tool.submit(spool, bad, ["-u", "1"])
        errors.append(str(e.value))
    path = _submit(P, spool, "ok", ["-u", "1"])
    with pytest.raises(ValueError, match="already exists") as e:
        P.tool.submit(spool, "ok", ["-u", "1"])
    errors.append(str(e.value))
    for kw in ({"batch": True}, {"batch": True, "fault_plan": ["crash"]}):
        with pytest.raises(ValueError) as e:
            P.tool.submit(spool, "b", ["-u", "1"], **kw)
        errors.append(str(e.value))
    spec = json.load(open(os.path.join(spool, path)))
    return _snap(P, spool, errors=errors, path=path, spec=spec)


def sc_reserved_name_spec_is_quarantined_not_fatal(P, root, clk):
    spool = str(root / "spool")
    os.makedirs(spool)
    with open(os.path.join(spool, "fleet.prom.json"), "w") as f:
        json.dump({"argv": ["-u", "1"]}, f)
    fleet, spool, stubs = _mk_fleet(P, root, clk, {})
    rc = fleet.run()
    assert rc == 1 and fleet.jobs["fleet.prom"].state == "quarantined"
    assert not stubs.spawned
    return _snap(P, spool, stubs, fleet, rc=rc)


def sc_runs_spool_to_completion_within_budget(P, root, clk):
    names = ("j1", "j2", "j3", "j4")
    spool = str(root / "spool")
    for n in names:
        _submit(P, spool, n, ["-u", "10"])
    fleet, spool, stubs = _mk_fleet(
        P, root, clk,
        {n: [lambda: ts.FakeProc(clk, code=0, runtime=3.0)] for n in names},
        max_jobs=2)
    rc = fleet.run()
    assert rc == 0 and len(stubs.spawned) == 4
    assert stubs.max_concurrent == 2
    for name, _, argv in stubs.spawned:
        i = argv.index("-d")
        assert argv[i + 1] == os.path.join(spool, name, "data")
        assert "TPU_CKPT_DIR" in argv and "--resume" in argv
    return _snap(P, spool, stubs, fleet, rc=rc,
                 max_concurrent=stubs.max_concurrent)


def sc_replay_resumes_without_double_spawn(P, root, clk):
    spool = str(root / "spool")
    for n in ("j1", "j2"):
        _submit(P, spool, n, ["-u", "10"])
    f1, spool, stubs1 = _mk_fleet(
        P, root, clk,
        {n: [lambda: ts.FakeProc(clk, runtime=None)] for n in ("j1", "j2")})
    for _ in range(3):
        f1.poll_once()
    assert all(j.state == "running" for j in f1.jobs.values())
    stubs2 = StubChildren(clk, {n: [lambda: ts.FakeProc(clk, code=0,
                                                        runtime=1.0)]
                                for n in ("j1", "j2")})
    f2 = _orch(P, spool, clk, stubs2)
    replayed = {n: j.state for n, j in f2.jobs.items()}
    assert replayed == {"j1": "queued", "j2": "queued"}
    rc = f2.run()
    assert rc == 0 and len(stubs2.spawned) == 2
    events, _ = _events(P, spool)
    assert [e for e, _ in events].count("admit") == 2
    assert events.count(("replay_resume", "j1")) == 1
    snap = _snap(P, spool, stubs2, f2, rc=rc, replayed=replayed)
    snap["first_spawns"] = _snap(P, spool, stubs1)["spawns"]
    return snap


def sc_replay_completes_half_done_admission(P, root, clk):
    spool = str(root / "spool")
    _submit(P, spool, "j1", ["-u", "10"])
    P.append_record(os.path.join(spool, JOURNAL),
                    {"record": "fleet", "event": "admit", "job": "j1",
                     "time": 0.0})
    fleet, spool, stubs = _mk_fleet(
        P, root, clk,
        {"j1": [lambda: ts.FakeProc(clk, code=0, runtime=1.0)]})
    assert fleet.jobs["j1"].state == "queued"
    rc = fleet.run()
    assert rc == 0 and len(stubs.spawned) == 1
    assert os.path.exists(os.path.join(spool, "j1", "job.json"))
    assert not os.path.exists(os.path.join(spool, "j1.json"))
    return _snap(P, spool, stubs, fleet, rc=rc)


def sc_replay_honors_in_flight_cancellation(P, root, clk):
    spool = str(root / "spool")
    os.makedirs(spool)
    jp = os.path.join(spool, JOURNAL)
    for rec in ({"event": "admit", "job": "c1"},
                {"event": "cancel_requested", "job": "c1"}):
        P.append_record(jp, {"record": "fleet", "time": 0.0, **rec})
    stubs = StubChildren(clk, {})
    fleet = _orch(P, spool, clk, stubs)
    assert fleet.jobs["c1"].state == "cancelled"
    rc = fleet.run()
    assert rc == 0
    events, _ = _events(P, spool)
    assert ("cancelled", "c1") in events
    assert ("replay_resume", "c1") not in events
    return _snap(P, spool, stubs, fleet, rc=rc)


def sc_rotation_snapshot_keeps_replay_whole(P, root, clk):
    spool = str(root / "spool")
    _submit(P, spool, "longrun", ["-u", "10"])
    _submit(P, spool, "noisy", ["-u", "10"])
    scripts = {"longrun": [lambda: ts.FakeProc(clk, runtime=None)],
               "noisy": [lambda: ts.FakeProc(clk, code=1, runtime=0.5)
                         for _ in range(9)]}
    fleet, spool, stubs = _mk_fleet(P, root, clk, scripts,
                                    journal_max_bytes=10)
    for _ in range(60):
        fleet.poll_once()
        clk.sleep(0.5)
    assert os.path.exists(os.path.join(spool, JOURNAL + ".1"))
    assert fleet.jobs["longrun"].state == "running"
    recs = P.read_records(os.path.join(spool, JOURNAL))
    assert not any(r.get("event") == "admit" and r.get("job") == "longrun"
                   for r in recs)
    assert any(r.get("event") == "snapshot" for r in recs)
    f2 = _orch(P, spool, clk, StubChildren(clk, {}))
    replayed = {n: j.state for n, j in sorted(f2.jobs.items())}
    assert replayed["longrun"] == "queued"
    return _snap(P, spool, stubs, fleet, replayed=replayed)


def sc_supervisor_exception_is_terminal(P, root, clk):
    spool = str(root / "spool")
    _submit(P, spool, "cursed", ["-u", "1"])

    def exploding_factory(job):
        def spawn(argv, env, logf):
            raise RuntimeError("spawn machinery broken")
        return spawn

    fleet = P.fleet.FleetOrchestrator(
        spool, cfg=_cfg(P), env=dict(SUP_ENV), clock=clk, sleep=clk.sleep,
        spawn_factory=exploding_factory)
    rc = fleet.run()
    assert rc == 1 and fleet.jobs["cursed"].state == "failed"
    f2 = _orch(P, spool, clk, StubChildren(clk, {}))
    assert f2.jobs["cursed"].state == "failed"
    rc2 = f2.run()
    assert rc2 == 1
    return _snap(P, spool, fleet=f2, rc=[rc, rc2])


def sc_terminal_states_survive_replay(P, root, clk):
    spool = str(root / "spool")
    _submit(P, spool, "ok", ["-u", "1"])
    _submit(P, spool, "boom", ["-u", "1"])
    scripts = {"ok": [lambda: ts.FakeProc(clk, code=0, runtime=1.0)],
               "boom": [lambda: ts.FakeProc(clk, code=1, runtime=0.5)
                        for _ in range(9)]}
    fleet, spool, stubs = _mk_fleet(P, root, clk, scripts)
    rc = fleet.run()
    assert rc == 1 and fleet.jobs["boom"].state == "failed"
    f2 = _orch(P, spool, clk, StubChildren(clk, {}))
    assert {n: j.state for n, j in f2.jobs.items()} == \
        {"ok": "done", "boom": "failed"}
    rc2 = f2.run()
    assert rc2 == 1
    return _snap(P, spool, stubs, f2, rc=[rc, rc2])


def sc_breaker_trips_on_k_same_class(P, root, clk):
    br = P.fleet.CircuitBreaker(3, 60.0)
    seen = [br.note_failure("crash", 0.0), br.note_failure("crash", 10.0),
            br.note_failure("crash", 20.0), br.is_open(21.0), br.trips,
            br.note_failure("crash", 50.0), br.maybe_close(100.0),
            br.maybe_close(110.0), br.is_open(110.0)]
    assert seen == [False, False, True, True, 1, False, None, "crash",
                    False]
    return {"seen": seen}


def sc_breaker_needs_same_class_in_window(P, root, clk):
    br = P.fleet.CircuitBreaker(2, 60.0)
    seen = [br.note_failure("crash", 0.0), br.note_failure("hang", 10.0),
            br.note_failure("crash", 70.0), br.note_failure("crash", 80.0)]
    assert seen == [False, False, False, True]
    return {"seen": seen, "open": br.open_class, "at": br.opened_at}


def sc_breaker_pauses_admissions_then_recovers(P, root, clk):
    spool = str(root / "spool")
    for n in ("a-boom", "b-boom", "c-late"):
        _submit(P, spool, n, ["-u", "10"])
    scripts = {
        "a-boom": [lambda: ts.FakeProc(clk, code=1, runtime=0.5)
                   for _ in range(9)],
        "b-boom": [lambda: ts.FakeProc(clk, code=1, runtime=0.5)
                   for _ in range(9)],
        "c-late": [lambda: ts.FakeProc(clk, code=0, runtime=1.0)],
    }
    fleet, spool, stubs = _mk_fleet(P, root, clk, scripts, max_jobs=2,
                                    breaker_k=2, breaker_sec=40.0)
    rc = fleet.run()
    assert rc == 1
    events, _ = _events(P, spool)
    names = [e for e, _ in events]
    assert names.index("breaker_close") < events.index(("admit", "c-late"))
    assert fleet.failures["crash"] == 8
    m = P.read_metrics(os.path.join(spool, "fleet.prom"))
    assert m["avida_fleet_breaker_trips_total"] == 1
    assert m["avida_fleet_breaker_open"] == 0
    return _snap(P, spool, stubs, fleet, rc=rc,
                 failures=dict(fleet.failures))


def sc_drain_requeues_incomplete_jobs(P, root, clk):
    spool = str(root / "spool")
    _submit(P, spool, "run1", ["-u", "1000"])
    _submit(P, spool, "wait2", ["-u", "1000"])
    fleet, spool, stubs = _mk_fleet(
        P, root, clk, {"run1": [lambda: PreemptibleProc(clk, runtime=None)]},
        max_jobs=1)
    sleeps = []
    real_sleep = fleet._sleep

    def stopping_sleep(s):
        real_sleep(s)
        sleeps.append(s)
        if len(sleeps) >= 3:
            fleet._stop = True

    fleet._sleep = stopping_sleep
    rc = fleet.run()
    assert rc == 0
    assert fleet.jobs["run1"].state == "queued"
    assert fleet.jobs["wait2"].state == "queued"
    assert stubs.spawned[0][1].returncode == 0
    first = _snap(P, spool, stubs, fleet, rc=rc)

    def finish(proc, argv, env, logf):
        ts._write_metrics(os.path.dirname(logf.name), hb=clk(),
                          preempted=0)

    stubs2 = StubChildren(
        clk, {n: [lambda: ts.FakeProc(clk, code=0, runtime=1.0,
                                      on_spawn=finish)]
              for n in ("run1", "wait2")})
    f2 = _orch(P, spool, clk, stubs2)
    rc2 = f2.run()
    assert rc2 == 0 and all(j.state == "done" for j in f2.jobs.values())
    return dict(_snap(P, spool, stubs2, f2, rc=rc2), first=first)


def sc_cancel_and_requeue_markers(P, root, clk, capsys):
    spool = str(root / "spool")
    _submit(P, spool, "c1", ["-u", "1000"])
    _submit(P, spool, "c2", ["-u", "1000"])
    scripts = {"c1": [lambda: PreemptibleProc(clk, runtime=None)],
               "c2": [lambda: ts.FakeProc(clk, code=0, runtime=1.0)]}
    fleet, spool, stubs = _mk_fleet(P, root, clk, scripts, max_jobs=1)
    fleet.poll_once()
    assert fleet.jobs["c1"].state == "running"
    rcs = [P.tool.main(["cancel", spool, "c1"]),
           P.tool.main(["cancel", spool, "c2"])]
    for _ in range(4):
        fleet.poll_once()
    assert fleet.jobs["c1"].state == "cancelled"
    assert fleet.jobs["c2"].state == "cancelled"
    assert os.path.exists(os.path.join(spool, "c2.cancelled.json"))
    rcs.append(P.tool.main(["requeue", spool, "c2"]))
    rc = fleet.run()
    assert rc == 0 and fleet.jobs["c2"].state == "done"
    capsys.readouterr()
    rcs.append(P.tool.main(["list", spool]))
    listing = capsys.readouterr().out
    assert "c1" in listing and "cancelled" in listing and "done" in listing
    rcs.append(P.tool.main(["cancel", spool, "ghost"]))
    out = capsys.readouterr().out
    assert rcs == [0, 0, 0, 0, 2]
    return _snap(P, spool, stubs, fleet, rc=rc, rcs=rcs, listing=listing,
                 ghost=out)


def _masked_status(text):
    return re.sub(r"heartbeat   [0-9.]+s ago", "heartbeat   <age>", text)


def sc_status_view_and_main_dispatch(P, root, clk, capsys):
    spool = str(root / "spool")
    _submit(P, spool, "jv", ["-u", "1"])
    fleet, spool, stubs = _mk_fleet(
        P, root, clk, {"jv": [lambda: ts.FakeProc(clk, code=0,
                                                  runtime=1.0)]})
    assert fleet.run() == 0
    main = __import__(P.module + ".__main__", fromlist=["main"]).main
    capsys.readouterr()
    rcs = [P.fleet.fleet_status_main(spool)]
    outs = [capsys.readouterr().out]
    rcs += [main(["--status", spool]),
            main(["--status", spool, "--max-age", "3600"])]
    outs.append(capsys.readouterr().out)
    mpath = os.path.join(spool, "fleet.prom")
    text = open(mpath).read()
    with open(mpath, "w") as f:
        f.write("".join(
            "avida_fleet_heartbeat_timestamp_seconds 1.0\n"
            if line.startswith("avida_fleet_heartbeat") else line + "\n"
            for line in text.splitlines()))
    rcs.append(P.fleet.fleet_status_main(spool, max_age=60.0))
    outs.append(capsys.readouterr().out)
    assert rcs == [0, 0, 0, 2]
    assert "jv" in outs[0] and "done" in outs[0] and "STALE" in outs[2]
    return _snap(P, spool, stubs, fleet, rcs=rcs,
                 outs=[re.sub(r"STALE: orchestrator heartbeat [0-9.]+s",
                              "STALE: <age>", _masked_status(o))
                       for o in outs])


def sc_main_cli_parse(P, root, clk, monkeypatch):
    monkeypatch.delenv("TPU_FLEET_DYNAMIC", raising=False)
    spool = str(root / "spool")
    rcs = [P.fleet.fleet_main(["--fleet"]),
           P.fleet.fleet_main(["--fleet", spool, "--max-jobs", "x"]),
           P.fleet.fleet_main(["--fleet", spool, "--bogus"]),
           P.fleet.fleet_main(["--fleet", spool, "--max-jobs", "3"])]
    assert rcs == [2, 2, 2, 0]
    assert not os.path.exists(os.path.join(spool, "fleet.lock"))
    return _snap(P, spool, rcs=rcs)


def sc_spec_seed_and_batch_key(P, root, clk):
    key = P.fleet.spec_seed_and_batch_key
    out = [key({"argv": ["-u", "10", "-s", "7"]}),
           key({"argv": ["-u", "10", "-set", "RANDOM_SEED", "9"]}),
           key({"argv": ["-u", "10"]}),
           key({"argv": ["-s", "7", "-set", "RANDOM_SEED", "9"]}),
           key({"argv": ["-u", "10", "-s", "7"], "env": {"A": "1"}})]
    assert out[0][0] == 7 and out[0][1].startswith("sig:")
    assert out[1][0] == 9 and out[1][1] == out[0][1]
    assert out[2][0] is None and out[3][0] == 7
    assert out[4][1] != out[0][1]
    return {"keys": [list(k) for k in out]}


def sc_batch_key_is_canonical(P, root, clk):
    key = P.fleet.spec_seed_and_batch_key
    specs = [
        ["-u", "10", "-s", "7", "-set", "WORLD_X", "60"],
        ["-d", "out/a", "-set", "TPU_CKPT_DIR", "ck/a", "-u", "10", "-s",
         "8", "-set", "WORLD_X", "60"],
        ["-set", "WORLD_X", "60", "-u", "10", "-set", "RANDOM_SEED", "9"],
        ["-u", "10", "-s", "7", "-set", "WORLD_X", "60", "-set", "WORLD_Y",
         "60"],
        ["-u", "10", "-s", "7", "-set", "WORLD_X", "50"],
        ["-u", "20", "-s", "7", "-set", "WORLD_X", "60"],
        ["-u", "10", "-s", "7", "--telemetry"],
        ["-u", "10", "-s", "7", "-set", "TPU_CKPT_EVERY", "5",
         "-set", "TPU_PACKED_CHUNK", "0"],
        ["-u", "10", "-s", "7", "-set", "NO_SUCH_VAR", "1"],
    ]
    keys = [key({"argv": a})[1] for a in specs]
    assert keys[0] == keys[1] == keys[2] == keys[3]
    assert keys[4] != keys[0] and keys[5] != keys[0]
    sig = P.serve.static_signature
    no_u = [sig({"argv": specs[0]}, with_updates=False),
            sig({"argv": specs[5]}, with_updates=False)]
    assert no_u[0] == no_u[1]
    return {"keys": keys, "no_updates": no_u}


def sc_batch_coalesces_static_equal_specs(P, root, clk):
    spool = str(root / "spool")
    for n, s in (("b1", 7), ("b2", 8), ("b3", 9)):
        _submit(P, spool, n, ["-u", "10", "-s", str(s)], batch=True)
    _submit(P, spool, "solo1",
            ["-u", "10", "-s", "4", "-set", "WORLD_X", "20"], batch=True)
    fleet, spool, stubs = _mk_fleet(
        P, root, clk,
        {"b1": [lambda: ts.FakeProc(clk, code=0, runtime=3.0)],
         "solo1": [lambda: ts.FakeProc(clk, code=0, runtime=3.0)]},
        max_jobs=2)
    rc = fleet.run()
    assert rc == 0
    assert sorted(n for n, _, _ in stubs.spawned) == ["b1", "solo1"]
    argv = next(a for n, _, a in stubs.spawned if n == "b1")
    with open(argv[argv.index("--worlds") + 1]) as f:
        manifest = json.load(f)
    assert [e["name"] for e in manifest] == ["b1", "b2", "b3"]
    assert [e["seed"] for e in manifest] == [7, 8, 9]
    assert "-s" not in argv and "--resume" in argv
    events, recs = _events(P, spool)
    assert ("coalesce", "b1") in events
    assert [r["job"] for r in recs if r["event"] == "batch_fallback"] \
        == ["solo1"]
    return _snap(P, spool, stubs, fleet, rc=rc, manifest=manifest)


def sc_batch_member_cancel_preempts_and_requeues(P, root, clk):
    spool = str(root / "spool")
    for n, s in (("p1", 3), ("p2", 5)):
        _submit(P, spool, n, ["-u", "1000", "-s", str(s)], batch=True)
    fleet, spool, stubs = _mk_fleet(
        P, root, clk,
        {"p1": [lambda: PreemptibleProc(clk, runtime=None),
                lambda: ts.FakeProc(
                    clk, code=0, runtime=1.0,
                    on_spawn=lambda p, a, e, lf: ts._write_metrics(
                        os.path.dirname(lf.name), hb=clk(),
                        preempted=0))]},
        max_jobs=2)
    fleet.poll_once()
    assert fleet.jobs["p2"].state == "batched"
    assert fleet.jobs["p1"].batch_members == ["p2"]
    os.makedirs(os.path.join(spool, "p1", "data"), exist_ok=True)
    with open(os.path.join(spool, "p1", "data", "multiworld.prom"),
              "w") as f:
        f.write('avida_update{world="p1"} 12\n'
                'avida_update{world="p2"} 12\n'
                'avida_organisms{world="p1"} 3\n'
                'avida_organisms{world="p2"} 4\n')
    view = P.fleet.format_fleet_status(spool, now=clk())
    assert "(batch x2)" in view and "u12 organisms 4" in view
    assert "\n  p2 " not in view
    live = P.fleet.journal_states(os.path.join(spool, JOURNAL))[0]
    leaders = P.fleet.journal_batch_leaders(os.path.join(spool, JOURNAL))
    assert live == {"p1": "running", "p2": "batched"}
    assert leaders == {"p2": "p1"}
    replay = _orch(P, spool, clk, StubChildren(clk, {}))
    replayed = {n: j.state for n, j in sorted(replay.jobs.items())}
    assert replayed == {"p1": "queued", "p2": "queued"}
    assert P.tool.main(["cancel", spool, "p2"]) == 0
    for _ in range(4):
        fleet.poll_once()
    assert fleet.jobs["p2"].state == "cancelled"
    assert stubs.spawned[0][1].returncode == 0
    rc = fleet.run()
    assert rc == 0 and fleet.jobs["p1"].state == "done"
    return _snap(P, spool, stubs, fleet, rc=rc,
                 view=_masked_status(view), leaders=leaders,
                 replayed=replayed)


def sc_batch_groups_by_resume_progress(P, root, clk):
    spool = str(root / "spool")
    for n, s in (("r1", 3), ("r2", 5)):
        _submit(P, spool, n, ["-u", "1000", "-s", str(s)], batch=True)
    os.makedirs(os.path.join(spool, "r1", "ck", "ckpt-000000000008"))
    fleet, spool, stubs = _mk_fleet(
        P, root, clk,
        {n: [lambda: ts.FakeProc(clk, code=0, runtime=2.0)]
         for n in ("r1", "r2")},
        max_jobs=2)
    rc = fleet.run()
    assert rc == 0
    assert all("--worlds" not in a for _, _, a in stubs.spawned)
    return _snap(P, spool, stubs, fleet, rc=rc)


def sc_batch_width_cap_splits_groups(P, root, clk):
    spool = str(root / "spool")
    names = [f"c{i}" for i in range(1, 6)]
    for i, n in enumerate(names):
        _submit(P, spool, n, ["-u", "10", "-s", str(i + 1)], batch=True)
    fleet, spool, stubs = _mk_fleet(
        P, root, clk,
        {n: [lambda: ts.FakeProc(clk, code=0, runtime=2.0)]
         for n in ("c1", "c3", "c5")},
        max_jobs=3, max_batch=2)
    rc = fleet.run()
    assert rc == 0
    assert sorted(n for n, _, _ in stubs.spawned) == ["c1", "c3", "c5"]
    widths = []
    for leader in ("c1", "c3"):
        argv = next(a for n, _, a in stubs.spawned if n == leader)
        with open(argv[argv.index("--worlds") + 1]) as f:
            widths.append(len(json.load(f)))
    assert widths == [2, 2]
    return _snap(P, spool, stubs, fleet, rc=rc, widths=widths)


# ---------------------------------------------------------------------------
# the fleet scenarios of tests/test_serve.py that need no serve pool
# ---------------------------------------------------------------------------

def sc_spec_argv_parsing(P, root, clk):
    pa = P.serve.SpecArgv(["-s", "7", "-set", "RANDOM_SEED", "9", "-u",
                           "50", "-d", "out", "-c", "cfgdir", "-v"])
    assert pa.effective_seed == 7 and pa.max_updates == 50
    assert pa.residual == ["-v"]
    cases = [["-set", "RANDOM_SEED", "9"], ["-u", "10"], ["-s", "x"],
             ["-u", "y", "-s"], ["--seed", "3", "--updates", "4",
                                 "--data-dir", "d", "--config-dir", "c"]]
    return {"full": vars(pa), "effective": pa.effective_seed,
            "max_updates": pa.max_updates,
            "cases": [[vars(P.serve.SpecArgv(c)),
                       P.serve.SpecArgv(c).effective_seed,
                       P.serve.SpecArgv(c).max_updates] for c in cases]}


def sc_signature_resolves_config_dir_contents(P, root, clk):
    d1, d2 = root / "c1", root / "c2"
    for d in (d1, d2):
        os.makedirs(d)
        with open(d / "avida.cfg", "w") as f:
            f.write("WORLD_X 8\nWORLD_Y 8\n")
    sig = P.serve.static_signature
    s1 = sig({"argv": ["-c", str(d1), "-s", "1"]})
    s2 = sig({"argv": ["-c", str(d2), "-s", "2"]})
    assert s1 == s2
    with open(d2 / "avida.cfg", "a") as f:
        f.write("COPY_MUT_PROB 0.01\n")
    s3 = sig({"argv": ["-c", str(d2), "-s", "2"]})
    assert s3 != s1
    # a config dir without avida.cfg, an unreadable one (the raw key)
    os.makedirs(root / "c3")
    s4 = sig({"argv": ["-c", str(root / "c3"), "-set", "WORLD_X", "9"]})
    s5 = sig({"argv": ["-c", "no/such/config/dir"]})
    s6 = sig({"argv": ["-set", "WORLD_X", "not-a-number"]})
    return {"sigs": [s1, s2, s3, s4, s5, s6]}


def sc_member_argv_strips_routing(P, root, clk):
    spec = {"argv": ["-s", "3", "-d", "out", "-set", "TPU_CKPT_DIR", "ck",
                     "-set", "WORLD_X", "8", "-u", "40"]}
    out = P.serve.member_argv(spec)
    assert out == ["-set", "WORLD_X", "8", "-u", "40"]
    return {"out": out, "more": [
        P.serve.member_argv({"argv": a}) for a in (
            ["--seed", "1", "--data-dir", "d", "-set", "RANDOM_SEED", "2",
             "-c", "cfg"], ["-s"], ["-set", "RANDOM_SEED"], [])]}


def sc_tenant_quota_holds_overflow(P, root, clk):
    spool = str(root / "spool")
    for n in ("q1", "q2"):
        _submit(P, spool, n, ["-u", "10"], tenant="acme")
    fleet, spool, stubs = _mk_fleet(
        P, root, clk, {n: [lambda: ts.FakeProc(clk, code=0, runtime=3.0)]
                       for n in ("q1", "q2")},
        env=SERVE_ENV, tenant_max=1, max_jobs=4)
    running = []
    real_poll = fleet.poll_once

    def poll():
        active = real_poll()
        running.append(sum(1 for j in fleet.jobs.values()
                           if j.state == "running"))
        return active

    fleet.poll_once = poll
    _drive(fleet, clk)
    assert max(running) == 1
    assert all(j.state == "done" for j in fleet.jobs.values())
    return _snap(P, spool, stubs, fleet, running=running)


def sc_queue_backpressure_bounds_ingestion(P, root, clk):
    spool = str(root / "spool")
    for i in range(5):
        _submit(P, spool, f"b{i}", ["-u", "10"])
    fleet, spool, stubs = _mk_fleet(
        P, root, clk, {f"b{i}": [lambda: ts.FakeProc(clk, code=0,
                                                     runtime=1.0)]
                       for i in range(5)},
        env=SERVE_ENV, queue_max=2, max_jobs=1)
    fleet.poll_once()
    ingested = sum(1 for j in fleet.jobs.values()
                   if j.state in ("queued", "running"))
    assert ingested <= 3
    _drive(fleet, clk)
    assert all(j.state == "done" for j in fleet.jobs.values())
    return _snap(P, spool, stubs, fleet, ingested=ingested)


def sc_shard_dirs_scanned_round_robin(P, root, clk):
    spool = str(root / "spool")
    paths = [_submit(P, spool, f"s{i}", ["-u", "10"], shard=3)
             for i in range(4)]
    assert all(p.startswith("shard-") for p in paths)
    fleet, spool, stubs = _mk_fleet(
        P, root, clk, {f"s{i}": [lambda: ts.FakeProc(clk, code=0,
                                                     runtime=1.0)]
                       for i in range(4)},
        env=SERVE_ENV, max_jobs=2)
    _drive(fleet, clk)
    assert all(j.state == "done" for j in fleet.jobs.values())
    for i in range(4):
        assert os.path.isdir(os.path.join(spool, f"s{i}"))
    return _snap(P, spool, stubs, fleet, paths=paths)


# ---------------------------------------------------------------------------
# the fleet scenarios of tests/test_alerts.py
# ---------------------------------------------------------------------------

def sc_reads_degrade_hints_from_job_supervisors(P, root, clk):
    spool = str(root / "spool")
    clk.t = 3000.0
    fl = P.fleet.FleetOrchestrator(
        spool, cfg=P.fleet.FleetConfig(breaker_k=1, breaker_sec=60.0),
        env={}, clock=clk, sleep=clk.sleep)
    rule = next(r for r in P.alerts.default_rules()
                if r.name == "integrity_mismatch")
    assert rule.action == "degrade-hint"
    plane = P.alerts.AlertPlane([rule])
    plane.firing["integrity_mismatch"] = 2990.0
    job = P.fleet.Job("sick", spool)
    job.sup = SimpleNamespace(alerts=plane, last_outcome=None,
                              _xla_fallback=False)
    counts = []
    fl._note_alert_hints(job)
    counts.append(fl.failures["alert:integrity_mismatch"])
    assert fl.breaker.open_class == "alert:integrity_mismatch"
    fl._note_alert_hints(job)
    counts.append(fl.failures["alert:integrity_mismatch"])
    plane.firing.clear()
    fl._note_alert_hints(job)
    plane.firing["integrity_mismatch"] = 2995.0
    fl._note_alert_hints(job)
    counts.append(fl.failures["alert:integrity_mismatch"])
    assert counts == [1, 1, 2]
    return _snap(P, spool, fleet=fl, counts=counts,
                 xla=job.sup._xla_fallback)


def sc_degrade_hint_breadcrumb_and_breaker(P, root, clk):
    spool = str(root / "spool")
    os.makedirs(spool)
    with open(os.path.join(spool, "alerts.json"), "w") as f:
        json.dump([{"name": "queue_hot",
                    "family": "avida_fleet_queue_depth",
                    "kind": "threshold", "op": ">", "value": 3.0,
                    "severity": "warn", "action": "degrade-hint"}], f)
    clk.t = 2000.0
    fl = P.fleet.FleetOrchestrator(
        spool, cfg=P.fleet.FleetConfig(breaker_k=1, breaker_sec=60.0),
        env={}, clock=clk, sleep=clk.sleep)
    ring = P.history.hist_path(fl.metrics_path)
    for t in range(1900, 2001, 10):
        P.history.append_sample(ring, {"avida_fleet_queue_depth": 9.0},
                                now=float(t))
    fl._eval_alerts(clk())
    assert fl.failures["alert:queue_hot"] == 1
    assert fl.breaker.open_class == "alert:queue_hot"
    fl.publish_metrics()
    m = P.read_metrics(fl.metrics_path)
    assert m['avida_alerts_firing{rule="queue_hot"}'] == 1
    clk.t += 10
    fl._eval_alerts(clk())
    assert fl.failures["alert:queue_hot"] == 1
    alert_recs = P.alerts.read_alert_records(
        os.path.join(spool, "alerts.jsonl"))
    return _snap(P, spool, fleet=fl, failures=dict(fl.failures),
                 alerts=[{k: v for k, v in r.items() if k != "time"}
                         for r in alert_recs])


# name -> scenario; those taking capsys / monkeypatch get them by name
SCENARIOS = {
    "validate_spec_rejects_garbage": sc_validate_spec_rejects_garbage,
    "quarantines_malformed_specs_once": sc_quarantines_malformed_specs_once,
    "fleet_tool_submit_validates": sc_fleet_tool_submit_validates,
    "reserved_name_spec_is_quarantined_not_fatal":
        sc_reserved_name_spec_is_quarantined_not_fatal,
    "runs_spool_to_completion_within_budget":
        sc_runs_spool_to_completion_within_budget,
    "replay_resumes_without_double_spawn":
        sc_replay_resumes_without_double_spawn,
    "replay_completes_half_done_admission":
        sc_replay_completes_half_done_admission,
    "replay_honors_in_flight_cancellation":
        sc_replay_honors_in_flight_cancellation,
    "rotation_snapshot_keeps_replay_whole":
        sc_rotation_snapshot_keeps_replay_whole,
    "supervisor_exception_is_terminal": sc_supervisor_exception_is_terminal,
    "terminal_states_survive_replay": sc_terminal_states_survive_replay,
    "breaker_trips_on_k_same_class": sc_breaker_trips_on_k_same_class,
    "breaker_needs_same_class_in_window":
        sc_breaker_needs_same_class_in_window,
    "breaker_pauses_admissions_then_recovers":
        sc_breaker_pauses_admissions_then_recovers,
    "drain_requeues_incomplete_jobs": sc_drain_requeues_incomplete_jobs,
    "cancel_and_requeue_markers": sc_cancel_and_requeue_markers,
    "status_view_and_main_dispatch": sc_status_view_and_main_dispatch,
    "main_cli_parse": sc_main_cli_parse,
    "spec_seed_and_batch_key": sc_spec_seed_and_batch_key,
    "batch_key_is_canonical": sc_batch_key_is_canonical,
    "batch_coalesces_static_equal_specs":
        sc_batch_coalesces_static_equal_specs,
    "batch_member_cancel_preempts_and_requeues":
        sc_batch_member_cancel_preempts_and_requeues,
    "batch_groups_by_resume_progress": sc_batch_groups_by_resume_progress,
    "batch_width_cap_splits_groups": sc_batch_width_cap_splits_groups,
    "spec_argv_parsing": sc_spec_argv_parsing,
    "signature_resolves_config_dir_contents":
        sc_signature_resolves_config_dir_contents,
    "member_argv_strips_routing": sc_member_argv_strips_routing,
    "tenant_quota_holds_overflow": sc_tenant_quota_holds_overflow,
    "queue_backpressure_bounds_ingestion":
        sc_queue_backpressure_bounds_ingestion,
    "shard_dirs_scanned_round_robin": sc_shard_dirs_scanned_round_robin,
    "reads_degrade_hints_from_job_supervisors":
        sc_reads_degrade_hints_from_job_supervisors,
    "degrade_hint_breadcrumb_and_breaker":
        sc_degrade_hint_breadcrumb_and_breaker,
}


def _run(tmp_path, monkeypatch, scenario, fixtures=None):
    """The scenario through both packages, each in a directory of its own
    with its own fake clock; wall time pinned (quarantine names, history
    rows, the alert plane)."""
    monkeypatch.setattr(time, "time", lambda: PINNED)
    fixtures = fixtures or {}
    kw_names = scenario.__code__.co_varnames[
        3:scenario.__code__.co_argcount]
    got = {}
    for name, P in PKGS.items():
        root = tmp_path / name
        os.makedirs(root)
        got[name] = scenario(P, root, ts.FakeClock(),
                             **{k: fixtures[k] for k in kw_names})
    return got


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_equals_reference(tmp_path, monkeypatch, capsys, name):
    """Each scenario through both packages' orchestrator and tools: the
    same exit codes, journal, job states, fleet.prom, spool and spawns
    (each side also passing the reference test's own assertions)."""
    got = _run(tmp_path, monkeypatch, SCENARIOS[name],
               {"capsys": capsys, "monkeypatch": monkeypatch})
    assert got["port"] == got["ref"]


def _storm(P, root, clk):
    spool = str(root / "spool")
    for n in ("p1", "p2", "z-late"):
        _submit(P, spool, n, ["-u", "10"])

    def pallas_boom(proc, argv, env, logf):
        logf.write("jax._src.pallas.mosaic.lowering.LoweringError: bad\n")
        logf.flush()

    def pallas_pair():
        return [lambda: ts.FakeProc(clk, code=1, runtime=0.5,
                                    on_spawn=pallas_boom),
                lambda: ts.FakeProc(clk, code=0, runtime=1.0)]

    scripts = {"p1": pallas_pair(), "p2": pallas_pair(),
               "z-late": [lambda: ts.FakeProc(clk, code=0, runtime=1.0)]}
    fleet, spool, stubs = _mk_fleet(P, root, clk, scripts, max_jobs=2,
                                    breaker_k=2, breaker_sec=20.0)
    rc = fleet.run()
    sups = {n: P.read_records(os.path.join(spool, n, "data",
                                           "supervisor.jsonl"))
            for n in ("p1", "p2")}
    return _snap(P, spool, stubs, fleet, rc=rc,
                 trips=fleet.breaker.trips,
                 suspect=[[r["pallas_suspect"] for r in recs
                           if r["event"] == "exit"]
                          for recs in sups.values()])


def _without_override(argv):
    out = list(argv)
    for i in range(len(out) - 2):
        if out[i:i + 3] == ["-set", "TPU_USE_PALLAS", "2"]:
            return out[:i] + out[i + 3:]
    return out


def test_kernel_storm_pauses_without_degrading(tmp_path, monkeypatch):
    """The reference's fleet-wide degradation scenario (two jobs crash
    with a kernel-implicating log, breaker K = 2): the reference journals
    `xla_fallback` once and relaunches with `-set TPU_USE_PALLAS 2`, the
    late job's first boot included; the port's breaker opens, pauses
    admissions and closes exactly as the reference's, with nothing else
    of that degradation."""
    got = _run(tmp_path, monkeypatch, _storm)
    ref, port = got["ref"], got["port"]
    # the reference's degradation, as its own test holds it
    assert [r["event"] for r in ref["journal"]].count("xla_fallback") == 1
    late = next(a for n, *a in [s for s in ref["spawns"]]
                if n == "z-late")
    assert _without_override(late) != late
    assert ref["prom"]["avida_fleet_xla_fallback"] == 1
    assert ref["journal_states"][2] is True
    # the port: the same storm, no degradation
    assert port["rc"] == ref["rc"] == 0 and port["trips"] == 1
    assert port["suspect"] == ref["suspect"] == [[True, False]] * 2
    assert not any(r["event"] == "xla_fallback" for r in port["journal"])
    assert not any("TPU_USE_PALLAS" in s for s in port["spawns"])
    assert port["prom"]["avida_fleet_xla_fallback"] == 0
    assert port["journal_states"][2] is False
    events = [(r["event"], r.get("job")) for r in port["journal"]]
    assert [e for e, _ in events].count("breaker_open") == 1
    assert events.index(("breaker_close", None)) \
        < events.index(("admit", "z-late"))
    # everything else equal: the journal minus the reference's record,
    # the spawns minus its override, fleet.prom minus its gauge
    assert port["journal"] == [r for r in ref["journal"]
                               if r["event"] != "xla_fallback"]
    assert port["spawns"] == [_without_override(s) for s in ref["spawns"]]
    for res in (ref, port):
        res["prom"].pop("avida_fleet_xla_fallback")
    for key in ("jobs", "prom", "bad", "files"):
        assert port[key] == ref[key], key


# ---------------------------------------------------------------------------
# one spool, either package's tools
# ---------------------------------------------------------------------------

def _mixed_spool(P, root, clk):
    """A spool exercising every job state: two coalesced riders, a
    solo success, a crash loop, a cancel, a queued spec, a quarantine."""
    spool = str(root / "spool")
    for n, s in (("b1", 7), ("b2", 8)):
        _submit(P, spool, n, ["-u", "10", "-s", str(s)], batch=True)
    _submit(P, spool, "ok", ["-u", "10"])
    _submit(P, spool, "boom", ["-u", "10"])
    _submit(P, spool, "gone", ["-u", "10"])
    with open(os.path.join(spool, "junk.json"), "w") as f:
        f.write("[1,")
    scripts = {"b1": [lambda: ts.FakeProc(clk, code=0, runtime=2.0)],
               "ok": [lambda: ts.FakeProc(clk, code=0, runtime=1.0)],
               "boom": [lambda: ts.FakeProc(clk, code=1, runtime=0.5)
                        for _ in range(9)]}
    fleet, spool, stubs = _mk_fleet(P, root, clk, scripts, max_jobs=2)
    P.tool.main(["cancel", spool, "gone"])
    fleet.run()
    _submit(P, spool, "later", ["-u", "10"])
    return spool


def _read_back(P, spool, capsys):
    jp = os.path.join(spool, JOURNAL)
    state, pids, xla = P.fleet.journal_states(jp)
    capsys.readouterr()
    rc = P.tool.main(["list", spool])
    listing = capsys.readouterr().out
    return {"journal_states": [state, sorted(pids.values()), xla],
            "leaders": P.fleet.journal_batch_leaders(jp),
            "spool_states": P.fleet.spool_job_states(spool),
            "status": _masked_status(P.fleet.format_fleet_status(
                spool, now=PINNED)),
            "list": [rc, listing]}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_spool_read_alike_by_both_packages(tmp_path, monkeypatch, capsys,
                                           writer):
    """A spool one package's orchestrator wrote (every job state, a live
    batch's leaders included) reads the same through either package's
    journal_states, format_fleet_status and fleet_tool list."""
    monkeypatch.setattr(time, "time", lambda: PINNED)
    spool = _mixed_spool(PKGS[writer], tmp_path, ts.FakeClock())
    got = {name: _read_back(P, spool, capsys) for name, P in PKGS.items()}
    assert got["port"] == got["ref"]
    states = got["port"]["spool_states"]
    assert states == {"b1": "done", "b2": "done", "ok": "done",
                      "boom": "failed", "gone": "cancelled",
                      "junk": "quarantined", "later": "queued"}


def test_reference_degraded_spool_read_but_not_acted_on(
        tmp_path, monkeypatch, capsys):
    """A reference spool whose journal holds `xla_fallback` (its storm
    scenario, then a new job): both packages report the record alike;
    the port's orchestrator, replaying it, relaunches nothing off the
    kernel and publishes avida_fleet_xla_fallback 0."""
    monkeypatch.setattr(time, "time", lambda: PINNED)
    clk = ts.FakeClock()
    _storm(PKGS["ref"], tmp_path, clk)
    spool = str(tmp_path / "spool")
    _submit(PKGS["ref"], spool, "after", ["-u", "10"])
    got = {name: _read_back(P, spool, capsys) for name, P in PKGS.items()}
    assert got["port"] == got["ref"]
    assert got["port"]["journal_states"][2] is True
    assert "degraded    fleet-wide XLA fallback active" \
        in got["port"]["status"]
    stubs = StubChildren(clk, {"after": [lambda: ts.FakeProc(
        clk, code=0, runtime=1.0)]})
    fleet = _orch(PKGS["port"], spool, clk, stubs)
    assert fleet.run() == 0
    (name, _, argv), = stubs.spawned
    assert name == "after" and "TPU_USE_PALLAS" not in argv
    assert tread_metrics(os.path.join(spool, "fleet.prom"))[
        "avida_fleet_xla_fallback"] == 0
    assert "degraded" not in tfleet.format_fleet_status(spool)
    # the port's own records stay free of the reference's degradation
    recs = tread(os.path.join(spool, JOURNAL))
    assert [r["event"] for r in recs].count("xla_fallback") == 1


def test_config_from_env_equals_reference():
    """FleetConfig.from_env reads the reference's knobs to the same
    values, the serve pool's TPU_SERVE_MIN_WIDTH included."""
    env = {"TPU_FLEET_MAX_JOBS": "5", "TPU_FLEET_POLL_SEC": "0.1",
           "TPU_FLEET_BREAKER_K": "4", "TPU_FLEET_BREAKER_SEC": "9",
           "TPU_FLEET_DRAIN_SEC": "7", "TPU_RUNLOG_MAX_BYTES": "4096",
           "TPU_FLEET_MAX_BATCH": "1", "TPU_FLEET_DYNAMIC": "1",
           "TPU_FLEET_TENANT_MAX": "2", "TPU_FLEET_QUEUE_MAX": "3",
           "TPU_SERVE_MIN_WIDTH": "0"}
    for e in ({}, env, {"TPU_FLEET_MAX_JOBS": "0"}):
        ref = vars(rfleet.FleetConfig.from_env(e))
        assert vars(tfleet.FleetConfig.from_env(e)) == ref


# ---------------------------------------------------------------------------
# the CLI: no torch in the orchestrator's process
# ---------------------------------------------------------------------------

_FLEET_CLI = r"""
import subprocess, sys
from avida_tpu_torch.tools import fleet_tool
for name, seed in (("a", 1), ("b", 2), ("c", 3)):
    fleet_tool.submit({spool!r}, name, ["-u", "4", "-s", str(seed),
                                        "--device", "cpu"],
                      batch=name != "c")
real = subprocess.Popen


def popen(argv, **kw):
    # a stand-in child: exits 0 at once, in its own session like a run
    print("SPAWN", "torch" in sys.modules, argv[1:3],
          "--worlds" in argv, kw.get("start_new_session"), flush=True)
    return real([sys.executable, "-c", "pass"], **kw)


subprocess.Popen = popen
from avida_tpu_torch.__main__ import main
rc = main(["--fleet", {spool!r}, "--max-jobs", "2"])
print("RC", rc, sorted(m for m in sys.modules
                       if m in ("torch", "jax", "avida_tpu")
                       or m.startswith(("torch.", "jax.", "avida_tpu."))))
"""


def test_fleet_cli_runs_without_torch(tmp_path):
    """`python -m avida_tpu_torch --fleet SPOOL` over three specs (two
    coalescing into one --worlds child) with stand-in children: exit 0,
    every job done, each child spawned as `-m avida_tpu_torch` in its own
    session, and no torch, jax or avida_tpu in the orchestrator."""
    spool = str(tmp_path / "spool")
    res = subprocess.run(
        [sys.executable, "-c", _FLEET_CLI.format(spool=spool)], cwd=REPO,
        env=dict(os.environ, TPU_FLEET_POLL_SEC="0.02",
                 TPU_SUPERVISE_POLL_SEC="0.02"),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    spawns = [ln for ln in res.stdout.splitlines() if ln.startswith("SPAWN")]
    assert sorted(spawns) == [
        "SPAWN False ['-m', 'avida_tpu_torch'] False True",
        "SPAWN False ['-m', 'avida_tpu_torch'] True True"]
    assert "RC 0 []" in res.stdout
    state, pids, _ = tfleet.journal_states(os.path.join(spool, JOURNAL))
    assert state == {"a": "done", "b": "done", "c": "done"}
    assert sorted(pids) == ["a", "c"]


# ---------------------------------------------------------------------------
# real children on the CPU: the orchestrator SIGKILLed mid-flight
# ---------------------------------------------------------------------------

_UPDATES = 10


def _child_argv(seed):
    return ["-s", str(seed), "-u", str(_UPDATES), "-set", "WORLD_X", "6",
            "-set", "WORLD_Y", "6", "-set", "TPU_SYSTEMATICS", "0",
            "-set", "TPU_MAX_STRETCH", "2", "-set", "TPU_CKPT_EVERY", "4",
            "-set", "TPU_CKPT_FINAL", "1", "--device", "cpu"]


def _child_env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               TPU_FLEET_POLL_SEC="0.05", TPU_SUPERVISE_POLL_SEC="0.05",
               TPU_SUPERVISE_BACKOFF_BASE="0.05",
               TPU_SUPERVISE_BACKOFF_CAP="0.2", TPU_WATCHDOG_SEC="120",
               TPU_SUPERVISE_GRACE_SEC="300")
    env.pop("TPU_FAULT", None)
    env.pop("TPU_FLEET_DYNAMIC", None)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def _npy(gen):
    out = {}
    for f in sorted(os.listdir(gen)):
        if f.endswith(".npy"):
            with open(os.path.join(gen, f), "rb") as fh:
                out[f] = fh.read()
    return out


def _owned(spool, name, pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return os.path.join(spool, name).encode() in f.read()
    except OSError:
        return False


def test_fleet_orchestrator_sigkill_resumes_real_children(tmp_path):
    """Two jobs (6x6 worlds, 10 updates, saves every 4) under `python -m
    avida_tpu_torch --fleet` on the CPU.  Each child is frozen (SIGSTOP)
    once its first generation is published, so it is provably alive when
    the orchestrator is SIGKILLed; a second orchestrator must reap both
    orphans (`orphan_killed`) before it respawns their jobs, resume each
    from its newest generation and drain the spool with exit 0; each
    job's final generation equals an uninterrupted `python -m
    avida_tpu_torch` run of the same argv byte for byte."""
    env = _child_env()
    jobs = {"j1": 13, "j2": 17}
    refs = {}
    procs = []
    for name, seed in jobs.items():
        d = tmp_path / f"ref-{name}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "avida_tpu_torch"] + _child_argv(seed)
            + ["-d", str(d / "data"), "-set", "TPU_CKPT_DIR", str(d / "ck")],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE))
        refs[name] = str(d / "ck")
    spool = os.path.realpath(str(tmp_path / "spool"))
    for name, seed in jobs.items():
        ttool.submit(spool, name, _child_argv(seed))
    cmd = [sys.executable, "-m", "avida_tpu_torch", "--fleet", spool,
           "--max-jobs", "2"]
    frozen = {}
    log = open(os.path.join(str(tmp_path), "orch1.log"), "w")
    orch = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log, stderr=log)
    try:
        deadline = time.time() + 120
        while len(frozen) < len(jobs) and time.time() < deadline \
                and orch.poll() is None:
            pids = tfleet.journal_states(os.path.join(spool, JOURNAL))[1]
            for name in jobs:
                if name not in frozen and name in pids and \
                        tckpt.list_generations(os.path.join(spool, name,
                                                            "ck")):
                    os.killpg(pids[name], signal.SIGSTOP)
                    frozen[name] = pids[name]
            time.sleep(0.01)
        assert orch.poll() is None, "orchestrator ended before the kill"
        orch.kill()
        orch.wait()
        assert sorted(frozen) == sorted(jobs)
        assert all(_owned(spool, n, p) for n, p in frozen.items())
        newest = {n: tckpt.generation_update(tckpt.list_generations(
            os.path.join(spool, n, "ck"))[-1]) for n in jobs}
        res = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                             text=True, timeout=180)
    finally:
        log.close()
        for pid in frozen.values():
            try:
                os.killpg(pid, signal.SIGKILL)
            except OSError:
                pass
        if orch.poll() is None:
            orch.kill()
    assert res.returncode == 0, res.stderr[-3000:]
    for p in procs:
        assert p.wait(timeout=120) == 0, p.stderr.read()[-2000:]
    recs = tread(os.path.join(spool, JOURNAL))
    events = [(r["event"], r.get("job")) for r in recs]
    assert sorted(j for e, j in events if e == "orphan_killed") \
        == sorted(jobs)
    assert sorted(j for e, j in events if e == "replay_resume") \
        == sorted(jobs)
    # each orphan reaped before its job's next spawn
    for name in jobs:
        i = events.index(("orphan_killed", name))
        assert ("spawn", name) in events[i:]
    state, _, _ = tfleet.journal_states(os.path.join(spool, JOURNAL))
    assert state == {n: "done" for n in jobs}
    for name in jobs:
        log_text = open(os.path.join(spool, name, "data",
                                     "supervised.log")).read()
        restored = re.findall(r"checkpoint_restored.*?update=(\d+)",
                              log_text)
        assert restored and int(restored[0]) == newest[name], log_text[-2000:]
        gens = tckpt.list_generations(os.path.join(spool, name, "ck"))
        ref = tckpt.list_generations(refs[name])
        assert tckpt.generation_update(gens[-1]) == _UPDATES \
            == tckpt.generation_update(ref[-1])
        a, b = _npy(gens[-1]), _npy(ref[-1])
        assert a.keys() == b.keys() and a, name
        for f in a:
            assert a[f] == b[f], (name, f)
    assert not any(_owned(spool, n, p) for n, p in frozen.items())
