"""The port's streaming serve pool (service/serve.py: width_class,
batch_ineligible_reason, ServeClass, ServePool; the `--fleet --dynamic`
hooks of service/fleet.py) against avida_tpu's: the serve-pool scenarios
of the reference's tests/test_serve.py, plus one scenario each for the
`sdc` and `rejected` branches of ServePool._settle_members, driven
through both packages with the same spool contents, the same
protocol-level stub class children (test_serve.StubServeProc /
ServeStubs: control.json in, serve.json and a heartbeat out) and the same
fake clock; a spool with a live class written by one package and rebuilt
by the other; and `python -m avida_tpu_torch --fleet --dynamic` never
importing torch.  Host-only: no world runs here (the serving batch itself
is tests/test_torch_serve_batch.py).

Tolerance: exact -- the normalised journals (times and pids removed, the
spool root masked), the final job states, fleet.prom's values (all but
the heartbeat timestamp), the spool's files, every class's control.json
bytes and each spawn's argv (with `avida_tpu` read as
`avida_tpu_torch`) equal.
"""

import json
import os
import subprocess
import sys
import time

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import test_supervisor as ts  # noqa: E402
from test_serve import ARGS, ServeStubs, StubServeProc  # noqa: E402
from test_torch_fleet import (JOURNAL, PINNED, PKGS, REPO,  # noqa: E402
                              SERVE_ENV, _drive, _events, _run, _snap,
                              _submit)

from avida_tpu_torch.service import fleet as tfleet  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers: one package's dynamic fleet on protocol-level class children
# ---------------------------------------------------------------------------

def _serve_fleet(P, spool, clk, stubs, **cfg_kw):
    base = dict(max_jobs=2, poll_sec=0.5, breaker_k=3, breaker_sec=60.0,
                drain_sec=30.0, dynamic=True)
    base.update(cfg_kw)
    return P.fleet.FleetOrchestrator(spool, cfg=P.fleet.FleetConfig(**base),
                                     env=dict(SERVE_ENV), clock=clk,
                                     sleep=clk.sleep,
                                     spawn_factory=stubs.factory)


def _mk(P, root, clk, scripts=None, serve_kw=None, **cfg_kw):
    spool = str(root / "spool")
    stubs = ServeStubs(clk, scripts, serve_kw)
    return _serve_fleet(P, spool, clk, stubs, **cfg_kw), spool, stubs


def _ticks(fleet, clk, n):
    for _ in range(n):
        fleet.poll_once()
        clk.sleep(0.5)


def _controls(spool):
    """Every serve class's control.json, as bytes (decoded)."""
    out = {}
    for name in sorted(os.listdir(spool)):
        path = os.path.join(spool, name, "control.json")
        if name.startswith("serve-") and os.path.exists(path):
            with open(path) as f:
                out[name] = f.read()
    return out


def _serve_snap(P, spool, stubs=(), fleet=None, **extra):
    return _snap(P, spool, stubs, fleet,
                 controls=json.loads(json.dumps(_controls(spool)).replace(
                     str(spool), "<spool>")), **extra)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_serve.py (and the two settle branches)
# ---------------------------------------------------------------------------

def sc_width_class_pow2_set(P, root, clk):
    wc = P.serve.width_class
    got = [wc(n, 2, 16) for n in (1, 2, 3, 4, 5, 9, 17, 100)]
    assert got == [2, 2, 4, 4, 8, 16, 16, 16]
    assert wc(1, 4, 16) == 4 and wc(3, 2, 6) == 4
    return {"pow2": got, "floored": wc(1, 4, 16), "capped": wc(3, 2, 6),
            "grid": [[wc(n, lo, hi) for n in range(0, 20)]
                     for lo, hi in ((1, 1), (2, 16), (3, 7), (0, 0))]}


def sc_batch_ineligible_reasons(P, root, clk):
    why = P.serve.batch_ineligible_reason
    cases = [ARGS, ARGS + ["--telemetry"], ARGS + ["--trace"],
             ARGS + ["--profile-dir", "p"],
             ARGS + ["-set", "TPU_TRACE", "1"],
             ARGS + ["-set", "TPU_ANALYTICS", "1"],
             ARGS + ["-set", "TPU_FAULT", "crash"],
             ARGS + ["-set", "TPU_TRACE", "0"],
             ARGS + ["-set", "TPU_FAULT", "-"]]
    got = [why({"argv": a}) for a in cases]
    assert got[0] is None and got[-1] is None and got[-2] is None
    assert "solo" in got[1] and "per-process" in got[6]
    return got


def sc_pool_hit_miss_done_and_gauges(P, root, clk):
    spool = str(root / "spool")
    for n, s in (("t1", 7), ("t2", 8), ("t3", 9)):
        _submit(P, spool, n, ARGS + ["-s", str(s)], batch=True)
    fleet, spool, stubs = _mk(P, root, clk)
    _ticks(fleet, clk, 6)
    leaders = [n for n, j in fleet.jobs.items()
               if n.startswith("serve-") and j.state == "running"]
    assert len(leaders) == 1
    _submit(P, spool, "t4", ARGS + ["-s", "10"], batch=True)
    mid = _controls(spool)
    _drive(fleet, clk)
    states = {n: j.state for n, j in fleet.jobs.items()}
    assert states[leaders[0]] == "done"
    assert all(states[t] == "done" for t in ("t1", "t2", "t3", "t4"))
    _, recs = _events(P, spool)
    coal = [r for r in recs if r["event"] == "coalesced"]
    assert [r["cache"] for r in coal].count("hit") == 1
    assert next(r for r in coal if r["job"] == "t4")["cache"] == "hit"
    assert sum(1 for n, _, _ in stubs.spawned
               if n.startswith("serve-")) == 1
    m = P.read_metrics(os.path.join(spool, "fleet.prom"))
    assert m["avida_fleet_serve_cache_hits_total"] == 1
    assert m["avida_fleet_serve_cache_misses_total"] == 1
    assert m["avida_fleet_serve_promotions_total"] == 4
    return _serve_snap(P, spool, stubs, fleet, leaders=leaders,
                       mid_controls=mid)


def sc_cancel_demotes_member_alone(P, root, clk):
    spool = str(root / "spool")
    for n, s in (("c1", 7), ("c2", 8)):
        _submit(P, spool, n, ARGS + ["-s", str(s)], batch=True)
    fleet, spool, stubs = _mk(P, root, clk, serve_kw=[{"rate": 2.0}])
    _ticks(fleet, clk, 6)
    assert fleet.jobs["c1"].state == "batched"
    P.tool.main(["cancel", spool, "c1"])
    _drive(fleet, clk)
    states = {n: j.state for n, j in fleet.jobs.items()}
    assert states["c1"] == "cancelled" and states["c2"] == "done"
    events, _ = _events(P, spool)
    assert ("cancel_requested", "c1") in events
    assert ("cancelled", "c1") in events and ("done", "c2") in events
    m = P.read_metrics(os.path.join(spool, "fleet.prom"))
    assert m["avida_fleet_serve_demotions_total"] == 1
    return _serve_snap(P, spool, stubs, fleet)


def sc_replay_reattaches_class_after_orchestrator_kill(P, root, clk):
    spool = str(root / "spool")
    for n, s in (("r1", 7), ("r2", 8)):
        _submit(P, spool, n, ARGS + ["-s", str(s)], batch=True)
    f1, spool, stubs1 = _mk(P, root, clk, serve_kw=[{"rate": 0.5}])
    _ticks(f1, clk, 6)
    assert {f1.jobs["r1"].state, f1.jobs["r2"].state} == {"batched"}
    for _, proc, _ in stubs1.spawned:
        proc.kill()
    stubs2 = ServeStubs(clk)
    f2 = _serve_fleet(P, spool, clk, stubs2)
    f2.poll_once()
    member_sig = P.serve.static_signature(
        {"argv": ARGS + ["-s", "9"], "batch": True}, with_updates=False)
    sigs = [c.sig for c in f2.serve_pool.classes.values()]
    assert sigs == [member_sig]
    _drive(f2, clk)
    events, _ = _events(P, spool)
    assert any(e == "serve_reattach" for e, _ in events)
    states = {n: j.state for n, j in f2.jobs.items()}
    assert states["r1"] == "done" and states["r2"] == "done"
    assert [n for n, _, _ in stubs1.spawned + stubs2.spawned
            if not n.startswith("serve-")] == []
    snap = _serve_snap(P, spool, stubs2, f2, sigs=sigs)
    snap["first_spawns"] = _snap(P, spool, stubs1)["spawns"]
    return snap


def sc_leader_failure_requeues_members(P, root, clk):
    spool = str(root / "spool")
    for n, s in (("f1", 7), ("f2", 8)):
        _submit(P, spool, n, ARGS + ["-s", str(s)], batch=True)
    fleet, spool, stubs = _mk(
        P, root, clk, serve_kw=[{"crash_after": 2.0}, {"crash_after": 2.0},
                                {"crash_after": 2.0}, {}])
    _drive(fleet, clk)
    events, _ = _events(P, spool)
    assert any(e == "requeued" and j in ("f1", "f2") for e, j in events)
    states = {n: j.state for n, j in fleet.jobs.items()}
    assert states["f1"] == "done" and states["f2"] == "done"
    assert sum(1 for e, _ in events if e == "serve_class") == 2
    return _serve_snap(P, spool, stubs, fleet)


class SettleProc(StubServeProc):
    """A class child that settles chosen members with an outcome of its
    own the first time it sees them live: "sdc" (a scrub mismatch
    demoted the tenant alone, its generations past update 0
    quarantined) or "rejected" (a static mismatch the host screen
    missed)."""

    def __init__(self, clock, outcomes, **kw):
        super().__init__(clock, **kw)
        self.outcomes = dict(outcomes)

    def poll(self):
        if self.returncode is None:
            for n in list(self.members):
                st = self.outcomes.pop(n, None)
                if st == "sdc":
                    self.finished[n] = {
                        "state": "sdc",
                        "update": int(self.members.pop(n)["u"]),
                        "last_verified_update": 0, "quarantined": 1}
                elif st == "rejected":
                    del self.members[n]
                    self.finished[n] = {"state": "rejected",
                                        "reason": "WorldParams mismatch"}
        return super().poll()


class SettleStubs(ServeStubs):
    def __init__(self, clock, outcomes, scripts=None):
        super().__init__(clock, scripts)
        self.outcomes = dict(outcomes)

    def factory(self, job):
        inner = super().factory(job)

        def spawn(argv, env, logf):
            if "--serve-worlds" not in argv:
                return inner(argv, env, logf)
            proc = SettleProc(self.clock, self.outcomes, rate=2.0)
            self.outcomes = {}
            proc._spawned(argv, env, logf)
            self.spawned.append((job.name, proc, argv))
            return proc
        return spawn


def sc_settle_sdc_requeues_and_opens_breaker(P, root, clk):
    """A class child reports `sdc` for one tenant: the pool journals
    `sdc` and `requeued` (reason serve_sdc), the fleet counts the failure
    and -- with breaker_k 1 -- opens the breaker, which pauses admissions
    and degrades nothing; after the quiet window the tenant is placed
    again into the warm class (a hit) and every tenant finishes."""
    spool = str(root / "spool")
    for n, s in (("s1", 7), ("s2", 8)):
        _submit(P, spool, n, ARGS + ["-s", str(s)], batch=True)
    stubs = SettleStubs(clk, {"s1": "sdc"})
    fleet = _serve_fleet(P, spool, clk, stubs, breaker_k=1,
                         breaker_sec=5.0)
    _drive(fleet, clk)
    events, recs = _events(P, spool)
    states = {n: j.state for n, j in fleet.jobs.items()}
    assert states["s1"] == "done" and states["s2"] == "done"
    sdc = next(r for r in recs if r["event"] == "sdc")
    assert sdc["job"] == "s1" and sdc["quarantined"] == 1
    assert ("requeued", "s1") in events
    assert [e for e, _ in events].count("breaker_open") == 1
    assert not any(e == "xla_fallback" for e, _ in events)
    assert {c: n for c, n in fleet.failures.items() if n} == {"sdc": 1}
    m = P.read_metrics(os.path.join(spool, "fleet.prom"))
    assert m['avida_fleet_failures_total{class="sdc"}'] == 1
    assert m["avida_fleet_xla_fallback"] == 0
    return _serve_snap(P, spool, stubs, fleet,
                       failures=dict(fleet.failures))


def sc_settle_rejected_falls_back_solo(P, root, clk):
    """A class child rejects one tenant: the pool journals
    `batch_fallback` and `requeued` (reason serve_rejected), strips
    `batch` from the job's spec on disk, and the tenant runs solo while
    its classmate finishes in the class."""
    spool = str(root / "spool")
    for n, s in (("x1", 7), ("x2", 8)):
        _submit(P, spool, n, ARGS + ["-s", str(s)], batch=True)
    stubs = SettleStubs(
        clk, {"x1": "rejected"},
        scripts={"x1": [lambda: ts.FakeProc(clk, code=0, runtime=1.0)]})
    fleet = _serve_fleet(P, spool, clk, stubs)
    _drive(fleet, clk)
    events, recs = _events(P, spool)
    states = {n: j.state for n, j in fleet.jobs.items()}
    assert states["x1"] == "done" and states["x2"] == "done"
    fb = next(r for r in recs if r["event"] == "batch_fallback")
    assert fb["job"] == "x1" and "WorldParams" in fb["reason"]
    assert ("requeued", "x1") in events
    with open(os.path.join(spool, "x1", "job.json")) as f:
        spec = json.load(f)
    assert "batch" not in spec
    assert [n for n, _, _ in stubs.spawned].count("x1") == 1
    return _serve_snap(P, spool, stubs, fleet, x1_spec=spec)


SCENARIOS = {
    "width_class_pow2_set": sc_width_class_pow2_set,
    "batch_ineligible_reasons": sc_batch_ineligible_reasons,
    "pool_hit_miss_done_and_gauges": sc_pool_hit_miss_done_and_gauges,
    "cancel_demotes_member_alone": sc_cancel_demotes_member_alone,
    "replay_reattaches_class_after_orchestrator_kill":
        sc_replay_reattaches_class_after_orchestrator_kill,
    "leader_failure_requeues_members": sc_leader_failure_requeues_members,
    "settle_sdc_requeues_and_opens_breaker":
        sc_settle_sdc_requeues_and_opens_breaker,
    "settle_rejected_falls_back_solo": sc_settle_rejected_falls_back_solo,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_serve_pool_equals_reference(tmp_path, monkeypatch, name):
    """Each scenario through both packages' serve pool: the same
    journal, job states, fleet.prom, spool files, controls and spawns
    (each side also passing the reference test's own assertions)."""
    got = _run(tmp_path, monkeypatch, SCENARIOS[name])
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# one spool, a live class written by one package and rebuilt by the other
# ---------------------------------------------------------------------------

def _live_class(P, root, clk):
    """Two tenants placed into one class child; the orchestrator then
    abandoned with the class live (its stub child dies with it)."""
    spool = str(root / "spool")
    for n, s in (("l1", 7), ("l2", 8)):
        _submit(P, spool, n, ARGS + ["-s", str(s)], batch=True)
    f1, spool, stubs = _mk(P, root, clk, serve_kw=[{"rate": 0.5}])
    _ticks(f1, clk, 6)
    assert {f1.jobs["l1"].state, f1.jobs["l2"].state} == {"batched"}
    for _, proc, _ in stubs.spawned:
        proc.kill()
    return spool


def _rebuild(P, spool, clk):
    stubs = ServeStubs(clk)
    f2 = _serve_fleet(P, spool, clk, stubs)
    f2.poll_once()
    classes = {n: (c.sig, c.width, sorted(c.members))
               for n, c in f2.serve_pool.classes.items()}
    _drive(f2, clk)
    return _serve_snap(P, spool, stubs, f2, classes=classes)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_live_class_rebuilt_by_either_package(tmp_path, monkeypatch,
                                              writer):
    """A spool whose serve class one package's orchestrator left live is
    rebuilt by either package's: the same reattached class (signature,
    width, members), then the same journal, states, fleet.prom, files,
    controls and spawns to the end."""
    monkeypatch.setattr(time, "time", lambda: PINNED)
    got = {}
    for reader, P in PKGS.items():
        root = tmp_path / reader
        os.makedirs(root)
        clk = ts.FakeClock()
        got[reader] = _rebuild(P, _live_class(PKGS[writer], root, clk), clk)
    assert got["port"]["classes"] and got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# the CLI: --fleet --dynamic never imports torch
# ---------------------------------------------------------------------------

_DYNAMIC_CLI = r"""
import json, os, subprocess, sys
from avida_tpu_torch.tools import fleet_tool
for name, seed in (("a", 1), ("b", 2)):
    fleet_tool.submit({spool!r}, name, ["-u", "4", "-s", str(seed),
                                        "--device", "cpu"], batch=True)
real = subprocess.Popen


def popen(argv, **kw):
    # a stand-in class child: finishes every member of its control at
    # once, then exits 0 on the shutdown the idle class is sent
    print("SPAWN", "torch" in sys.modules, argv[1:3],
          "--serve-worlds" in argv, flush=True)
    ctl = argv[argv.index("--serve-worlds") + 1]
    data = argv[argv.index("-d") + 1]
    code = ("import json, os, time\n"
            "while True:\n"
            "    d = json.load(open(%r))\n"
            "    fin = dict((e['name'], dict(state='done', update=4))"
            " for e in d['members'])\n"
            "    os.makedirs(%r, exist_ok=True)\n"
            "    json.dump(dict(width=d['width'], live=0, members={{}},"
            " finished=fin), open(os.path.join(%r, 'serve.json'), 'w'))\n"
            "    if d.get('shutdown'):\n"
            "        break\n"
            "    time.sleep(0.02)\n") % (ctl, data, data)
    return real([sys.executable, "-c", code], **kw)


subprocess.Popen = popen
from avida_tpu_torch.__main__ import main
rc = main(["--fleet", {spool!r}, "--max-jobs", "2", "--dynamic"])
print("RC", rc, sorted(m for m in sys.modules
                       if m in ("torch", "jax", "avida_tpu")
                       or m.startswith(("torch.", "jax.", "avida_tpu."))))
"""


def test_fleet_dynamic_cli_runs_without_torch(tmp_path):
    """`python -m avida_tpu_torch --fleet SPOOL --dynamic` over two batch
    specs with a stand-in class child: exit 0, both tenants done through
    ONE `--serve-worlds` child spawned as `-m avida_tpu_torch`, and no
    torch, jax or avida_tpu in the orchestrator."""
    spool = str(tmp_path / "spool")
    res = subprocess.run(
        [sys.executable, "-c", _DYNAMIC_CLI.format(spool=spool)], cwd=REPO,
        env=dict(os.environ, TPU_FLEET_POLL_SEC="0.02",
                 TPU_SUPERVISE_POLL_SEC="0.02"),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    spawns = [ln for ln in res.stdout.splitlines() if ln.startswith("SPAWN")]
    assert spawns == ["SPAWN False ['-m', 'avida_tpu_torch'] True"]
    assert "RC 0 []" in res.stdout
    state, _, _ = tfleet.journal_states(os.path.join(spool, JOURNAL))
    assert state["a"] == state["b"] == "done"
    assert [s for n, s in state.items() if n.startswith("serve-")] \
        == ["done"]
