"""The port's run supervisor (service/) against avida_tpu's: each policy
scenario of the reference's tests/test_supervisor.py and
tests/test_integrity.py, and each supervisor scenario of
tests/test_alerts.py, driven through both packages' `Supervisor` with the
same scripted fake children, the same fake clock and the same seed;
`RetryPolicy`, `classify` and the kernel matcher on the same inputs; the
supervisor's process never importing torch.

Inputs: the reference tests' fakes (FakeClock, FakeProc, metrics.prom
writers; ForeverProc and history rings for the alert plane) and
generations written by the reference's checkpoint store into each
package's own directory.

Tolerance: exact -- exit codes, outcome sequences, every
supervisor.jsonl record field for field, supervisor.prom and the alert
journal byte for byte, the quarantined `.bad-*` names, each child's argv
and environment (apart from the module the child runs) equal.

One difference is deliberate.  The reference relaunches a crash whose
log names its kernel once off the kernel (`-set TPU_USE_PALLAS 2`,
counted in avida_supervisor_pallas_fallbacks_total); the port never
routes a run around its kernel: such a crash is counted in
avida_supervisor_kernel_crashes_total and takes the ladder of any other
crash.  So supervisor.prom is compared without those two families and
the launch records without the reference's `xla_fallback` (false in
every shared scenario), and the port's kernel crash is held to the
reference's run of the same children with a tail its matcher does not
see.
"""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import avida_tpu.service as rservice  # noqa: E402
from avida_tpu.observability import history as rhistory  # noqa: E402
from avida_tpu.service import backoff as rbackoff  # noqa: E402
from avida_tpu.service import supervisor as rsup  # noqa: E402
from avida_tpu.utils import checkpoint as rckpt  # noqa: E402
from avida_tpu.utils import integrity as rintegrity  # noqa: E402

import avida_tpu_torch.service as tservice  # noqa: E402
from avida_tpu_torch.observability import records  # noqa: E402
from avida_tpu_torch.service import backoff as tbackoff  # noqa: E402
from avida_tpu_torch.service import supervisor as tsup  # noqa: E402

from test_supervisor import FakeClock, FakeProc, _write_metrics  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = 1_700_000_000.0
PKGS = {"ref": SimpleNamespace(sup=rsup, service=rservice, module="avida_tpu"),
        "port": SimpleNamespace(sup=tsup, service=tservice,
                                module="avida_tpu_torch")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the scenarios: each builds its supervisor from one package's module in
# `root` and drives it on the fake clock; returns (sup, spawned, rc)
# ---------------------------------------------------------------------------

def _gen(base, update, keep=4, value=None, tamper=False):
    """A generation written by the reference's store (the same input
    files for both packages)."""
    if value is None:
        arrays = {"state.merit": np.linspace(0, 1, 64).astype(np.float32),
                  "state.alive": np.ones(64, bool)}
        return rckpt.write_generation(str(base), update, arrays,
                                      {"update": update}, keep=keep)
    arrays = {"state.x": np.full(4, value, np.int32)}
    digest = rintegrity.digest_arrays(rintegrity.state_arrays_of(arrays))
    if tamper:
        digest ^= 0x10
    return rckpt.write_generation(str(base), update, arrays, host={},
                                  keep=99, extra={"state_digest": digest})


def _mk(root, S, clk, procs, env=None, **cfg_kw):
    data, ck = root / "data", root / "ck"
    os.makedirs(ck, exist_ok=True)
    seq = list(procs)
    spawned = []

    def spawn(argv, env, logf):
        proc = seq.pop(0)
        proc._spawned(argv, env, logf)
        spawned.append(proc)
        return proc

    kw = dict(watchdog_sec=10.0, poll_sec=0.5, grace_sec=30.0,
              max_retries=4, backoff_base=0.1, backoff_cap=1.0,
              healthy_sec=1e9, seed=2)
    kw.update(cfg_kw)
    sup = S.sup.Supervisor(
        ["-d", str(data), "-set", "TPU_CKPT_DIR", str(ck), "-u", "100"],
        cfg=S.sup.SupervisorConfig(**kw), env={} if env is None else env,
        spawn=spawn, clock=clk, sleep=clk.sleep)
    return sup, spawned


def _beat(clk, **kw):
    def on_spawn(proc, argv, env, logf):
        _write_metrics(os.path.dirname(logf.name), hb=clk(), **kw)
    return on_spawn


def _log(text, clk=None):
    def on_spawn(proc, argv, env, logf):
        logf.write(text)
        logf.flush()
        if clk is not None:
            _write_metrics(os.path.dirname(logf.name), hb=clk())
    return on_spawn


def sc_success(root, S, clk):
    sup, sp = _mk(root, S, clk, [FakeProc(clk, code=0, runtime=0.0,
                                          on_spawn=_beat(clk))])
    return sup, sp, sup.run()


def sc_crash_budget(root, S, clk):
    sup, sp = _mk(root, S, clk, [FakeProc(clk, code=1, runtime=0.0)
                                 for _ in range(5)], max_retries=4)
    return sup, sp, sup.run()


def sc_watchdog(root, S, clk):
    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, runtime=None, on_spawn=_beat(clk)),
        FakeProc(clk, code=0, runtime=0.0, on_spawn=_beat(clk))])
    return sup, sp, sup.run()


def sc_boot_grace(root, S, clk):
    data = str(root / "data")

    def late_beat(proc, elapsed):
        if elapsed >= 20.0:
            _write_metrics(data, hb=clk())
            if elapsed >= 21.0:
                proc.returncode = 0

    sup, sp = _mk(root, S, clk, [FakeProc(clk, runtime=None,
                                          poll_hook=late_beat)],
                  watchdog_sec=5.0, grace_sec=60.0)
    return sup, sp, sup.run()


def sc_stale_previous_heartbeat(root, S, clk):
    data = str(root / "data")
    _write_metrics(data, hb=clk() - 500.0)

    def slow_finish(proc, elapsed):
        if elapsed >= 15.0:
            _write_metrics(data, hb=clk())
            proc.returncode = 0

    sup, sp = _mk(root, S, clk, [FakeProc(clk, runtime=None,
                                          poll_hook=slow_finish)],
                  watchdog_sec=5.0, grace_sec=60.0)
    return sup, sp, sup.run()


def sc_preempt(root, S, clk):
    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, code=0, runtime=0.0, on_spawn=_beat(clk, preempted=1)),
        FakeProc(clk, code=0, runtime=0.0, on_spawn=_beat(clk))])
    return sup, sp, sup.run()


def sc_audit_rollback(root, S, clk):
    _gen(root / "ck", 10)
    _gen(root / "ck", 20)
    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, code=S.service.EXIT_AUDIT, runtime=0.0),
        FakeProc(clk, code=0, runtime=0.0, on_spawn=_beat(clk))])
    return sup, sp, sup.run()


def sc_audit_sole_generation(root, S, clk):
    _gen(root / "ck", 10)
    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, code=S.service.EXIT_AUDIT, runtime=0.0),
        FakeProc(clk, code=0, runtime=0.0)])
    return sup, sp, sup.run()


def sc_anomaly_onset(root, S, clk):
    _gen(root / "ck", 10)
    _gen(root / "ck", 20)
    data = str(root / "data")

    def evolving(proc, elapsed):
        _write_metrics(data, hb=clk(), anomalies=0 if elapsed < 3.0 else 1)

    def finish(proc, argv, env, logf):
        _write_metrics(data, hb=clk(), anomalies=1)

    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, runtime=None, poll_hook=evolving),
        FakeProc(clk, code=0, runtime=0.0, on_spawn=finish)])
    return sup, sp, sup.run()


def sc_kernel_crash(root, S, clk,
                    tail="jax._src.pallas.mosaic.lowering.LoweringError: "
                         "bad\n"):
    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, code=1, runtime=0.0, on_spawn=_log(tail)),
        FakeProc(clk, code=0, runtime=0.0, on_spawn=_beat(clk))])
    return sup, sp, sup.run()


def sc_plain_crash(root, S, clk):
    return sc_kernel_crash(root, S, clk, tail="ValueError: boom\n")


def sc_corrupt_ckpt_on_success(root, S, clk):
    sup, sp = _mk(root, S, clk, [FakeProc(
        clk, code=0, runtime=0.0, on_spawn=_log(
            "[avida_tpu_torch] checkpoint_corrupt: path=gen error=CRC\n"
            + "chatter\n" * 4000, clk))])
    return sup, sp, sup.run()


def sc_corrupt_ckpt_once(root, S, clk):
    line = "[avida_tpu_torch] checkpoint_corrupt: path=/ck/gen-8 error=CRC\n"
    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, code=1, runtime=0.0, on_spawn=_log(line, clk)),
        FakeProc(clk, code=0, runtime=0.0, on_spawn=_log(line, clk))])
    return sup, sp, sup.run()


def sc_fault_plan(root, S, clk):
    sup, sp = _mk(root, S, clk, [FakeProc(clk, code=1, runtime=0.0)
                                 for _ in range(3)], max_retries=2)
    sup.fault_plan = ["sigkill@update=5", "sigkill@update=9"]
    return sup, sp, sup.run()


def sc_healthy_reset(root, S, clk):
    data = str(root / "data")

    def long_healthy(proc, elapsed):
        _write_metrics(data, hb=clk())
        if elapsed >= 50.0:
            proc.returncode = 0

    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, code=1, runtime=0.0),
        FakeProc(clk, runtime=None, poll_hook=long_healthy)],
        healthy_sec=20.0, poll_sec=2.0)
    return sup, sp, sup.run()


def sc_progress_kills(root, S, clk):
    data = str(root / "data")

    def livelocked(proc, elapsed):
        _write_metrics(data, hb=clk(), update=42)

    def finish(proc, argv, env, logf):
        _write_metrics(data, hb=clk(), update=100)

    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, runtime=None, poll_hook=livelocked),
        FakeProc(clk, code=0, runtime=0.0, on_spawn=finish)],
        watchdog_sec=30.0, progress_sec=5.0)
    return sup, sp, sup.run()


def sc_progress_spares(root, S, clk):
    data = str(root / "data")

    def advancing(proc, elapsed):
        _write_metrics(data, hb=clk(), update=int(elapsed))
        if elapsed >= 20.0:
            proc.returncode = 0

    sup, sp = _mk(root, S, clk, [FakeProc(clk, runtime=None,
                                          poll_hook=advancing)],
                  watchdog_sec=30.0, progress_sec=5.0)
    return sup, sp, sup.run()


def sc_progress_off(root, S, clk):
    """Progress watchdog off (the default): a frozen update counter
    under fresh heartbeats runs to its own exit."""
    data = str(root / "data")

    def frozen(proc, elapsed):
        _write_metrics(data, hb=clk(), update=42)
        if elapsed >= 40.0:
            proc.returncode = 0

    sup, sp = _mk(root, S, clk, [FakeProc(clk, runtime=None,
                                          poll_hook=frozen)],
                  watchdog_sec=30.0, poll_sec=2.0)
    return sup, sp, sup.run()


def sc_backwards_heartbeat(root, S, clk):
    data = str(root / "data")

    def stepped_clock(proc, elapsed):
        _write_metrics(data, hb=clk() if elapsed < 3.0 else clk() - 15.0)

    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, runtime=None, poll_hook=stepped_clock),
        FakeProc(clk, code=0, runtime=0.0, on_spawn=_beat(clk))])
    return sup, sp, sup.run()


def sc_backwards_transient(root, S, clk):
    data = str(root / "data")

    def small_step(proc, elapsed):
        _write_metrics(data, hb=clk() if elapsed < 5.0 else clk() - 3.0)
        if elapsed >= 15.0:
            proc.returncode = 0

    sup, sp = _mk(root, S, clk, [FakeProc(clk, runtime=None,
                                          poll_hook=small_step)])
    return sup, sp, sup.run()


def sc_stderr_tail(root, S, clk):
    text = "".join(f"{'x' * 120} line {i}\n" for i in range(64)) \
        + "FATAL: the actual traceback\n"
    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, code=1, runtime=0.0, on_spawn=_log(text)),
        FakeProc(clk, code=0, runtime=0.0)])
    return sup, sp, sup.run()


def sc_runlog_rotation(root, S, clk):
    sup, sp = _mk(root, S, clk, [FakeProc(clk, code=1, runtime=0.0)
                                 for _ in range(9)],
                  env={"TPU_RUNLOG_MAX_BYTES": "2000"}, max_retries=8,
                  backoff_cap=0.2, seed=0)
    return sup, sp, sup.run()


def sc_sigterm_in_backoff(root, S, clk):
    sup, sp = _mk(root, S, clk, [FakeProc(clk, code=1, runtime=0.0)
                                 for _ in range(3)],
                  backoff_base=5.0, backoff_cap=10.0)
    real_sleep = sup._sleep

    def preempting_sleep(s):
        real_sleep(s)
        sup._stop = True

    sup._sleep = preempting_sleep
    return sup, sp, sup.run()


def sc_sdc_exit(root, S, clk):
    """A child exits EXIT_SDC naming its verified horizon: generations
    past it and digest mismatches are quarantined, the restart resumes
    from the newest digest-verified one."""
    ck = root / "ck"
    _gen(ck, 8, value=1)
    _gen(ck, 16, value=2, tamper=True)
    _gen(ck, 24, value=3)
    sup, sp = _mk(root, S, clk, [
        FakeProc(clk, code=S.service.EXIT_SDC, runtime=0.0, on_spawn=_log(
            "StateDivergenceError: scrub digest mismatch at update 20 "
            "(last_verified_update=16)\n")),
        FakeProc(clk, code=0, runtime=0.0, on_spawn=_beat(clk))])
    return sup, sp, sup.run()


def sc_sdc_no_marker(root, S, clk):
    ck = root / "ck"
    _gen(ck, 8, value=1)
    _gen(ck, 16, value=2)
    sup, sp = _mk(root, S, clk, [])
    sup._sdc_rollback(verified_update=None)
    return sup, sp, None


def sc_sdc_never_strands(root, S, clk):
    ck = root / "ck"
    _gen(ck, 16, value=2)
    _gen(ck, 24, value=3)
    sup, sp = _mk(root, S, clk, [])
    sup._sdc_rollback(verified_update=8)
    return sup, sp, None


# name -> (scenario, expected exit classes, expected rc)
SCENARIOS = {
    "success": (sc_success, ["success"], 0),
    "crash_budget": (sc_crash_budget, ["crash"] * 5, 1),
    "watchdog": (sc_watchdog, ["hang", "success"], 0),
    "boot_grace": (sc_boot_grace, ["success"], 0),
    "stale_previous_heartbeat": (sc_stale_previous_heartbeat,
                                 ["success"], 0),
    "preempt": (sc_preempt, ["preempt", "success"], 0),
    "audit_rollback": (sc_audit_rollback, ["audit_violation", "success"], 0),
    "audit_sole_generation": (sc_audit_sole_generation,
                              ["audit_violation", "success"], 0),
    "anomaly_onset": (sc_anomaly_onset, ["audit_violation", "success"], 0),
    "kernel_crash": (sc_kernel_crash, ["crash", "success"], 0),
    "corrupt_ckpt_on_success": (sc_corrupt_ckpt_on_success, ["success"], 0),
    "corrupt_ckpt_once": (sc_corrupt_ckpt_once, ["crash", "success"], 0),
    "fault_plan": (sc_fault_plan, ["crash"] * 3, 1),
    "healthy_reset": (sc_healthy_reset, ["crash", "success"], 0),
    "progress_kills": (sc_progress_kills, ["hang", "success"], 0),
    "progress_spares": (sc_progress_spares, ["success"], 0),
    "progress_off": (sc_progress_off, ["success"], 0),
    "backwards_heartbeat": (sc_backwards_heartbeat, ["hang", "success"], 0),
    "backwards_transient": (sc_backwards_transient, ["success"], 0),
    "stderr_tail": (sc_stderr_tail, ["crash", "success"], 0),
    "runlog_rotation": (sc_runlog_rotation, ["crash"] * 9, 1),
    "sigterm_in_backoff": (sc_sigterm_in_backoff, ["crash"], 0),
    "sdc_exit": (sc_sdc_exit, ["sdc", "success"], 0),
    "sdc_no_marker": (sc_sdc_no_marker, [], None),
    "sdc_never_strands": (sc_sdc_never_strands, [], None),
}


# the port's deliberate difference: the reference side of these cases
# runs the same children with a crash tail its matcher does not see
REF_AS = {"kernel_crash": sc_plain_crash}
# the counter each package keeps alone
OWN_FAMILIES = ("avida_supervisor_pallas_fallbacks_total",
                "avida_supervisor_kernel_crashes_total")


def _shared_prom(text):
    """supervisor.prom without the family each package keeps alone."""
    return "".join(ln for ln in text.splitlines(True)
                   if not any(f in ln for f in OWN_FAMILIES))


def _norm(obj, root):
    """JSON text of obj with the package's directory replaced."""
    return json.loads(json.dumps(obj).replace(str(root), "<root>"))


def _collect(root, sup, spawned, rc):
    data, ck = root / "data", root / "ck"
    recs = records.read_records(str(data / "supervisor.jsonl"))
    for r in recs:
        if r["event"] == "launch":
            # the reference's launch field; it never degrades here
            assert r.pop("xla_fallback", False) is False
    # the port's counter, and the reference's kernel-implicated exits
    kernel_crashes = getattr(sup, "kernel_crashes", None)
    if kernel_crashes is None:
        kernel_crashes = sum(bool(r.get("pallas_suspect")) for r in recs
                             if r["event"] == "exit")
    prom = data / "supervisor.prom"
    journal = data / "alerts.jsonl"
    children = []
    for p in spawned:
        children.append({"argv": p.argv[3:], "launcher": p.argv[1:2],
                         "module": p.argv[2],
                         "env": {k: v for k, v in p.env.items()
                                 if k != "PYTHONPATH"},
                         "returncode": p.returncode})
    return _norm({
        "rc": rc, "state": sup.state,
        # what a fleet orchestrator reads of its jobs' supervisors
        "succeeded": sup.succeeded,
        "last_outcome": (None if sup.last_outcome is None
                         else vars(sup.last_outcome)),
        "counts": [sup.boots, sup.restarts, dict(sup.failures),
                   sup.watchdog_kills, sup.rollbacks, sup.ckpt_fallbacks, sup.policy.failures,
                   sup.policy.budget_left()],
        "records": recs,
        "kernel_crashes": kernel_crashes,
        "rotated": os.path.exists(str(data / "supervisor.jsonl.1")),
        "prom": _shared_prom(prom.read_text()) if prom.exists() else None,
        "journal": journal.read_text() if journal.exists() else None,
        "dir": sorted(os.listdir(ck)) if ck.exists() else None,
        "children": children}, root)


def _drive(tmp_path, monkeypatch, scenario, ref_scenario=None):
    # quarantine_after names its renames by the wall clock, the history
    # ring stamps its rows by it: pinned, both packages see one time
    monkeypatch.setattr(time, "time", lambda: PINNED)
    got = {}
    for name, S in PKGS.items():
        root = tmp_path / name
        os.makedirs(root)
        run = ref_scenario if name == "ref" and ref_scenario else scenario
        sup, spawned, rc = run(root, S, FakeClock())
        got[name] = _collect(root, sup, spawned, rc)
    return got


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_supervisor_policy_equals_reference(tmp_path, monkeypatch, name):
    """Each scenario through both packages' Supervisor: the same exit
    code, outcomes, records, counters file, checkpoint directory and
    children."""
    scenario, classes, rc = SCENARIOS[name]
    got = _drive(tmp_path, monkeypatch, scenario, REF_AS.get(name))
    for pkg, res in got.items():
        for child in res["children"]:
            assert child.pop("module") == PKGS[pkg].module
    ref, port = got["ref"], got["port"]
    if name in REF_AS:
        # the kernel-implicated exit is the only one that differs: its
        # flag, its tail and the port's counter
        suspect = {}
        for pkg, res in got.items():
            suspect[pkg] = [(r.pop("pallas_suspect"),
                             r.pop("stderr_tail", None) is not None)
                            for r in res["records"] if r["event"] == "exit"]
            suspect[pkg].append(res.pop("kernel_crashes"))
        assert suspect == {"ref": [(False, True), (False, False), 0],
                           "port": [(True, True), (False, False), 1]}
    assert port == ref
    assert port["rc"] == rc
    assert [r["class"] for r in port["records"]
            if r["event"] == "exit"] == classes
    for child in port["children"]:
        assert "--resume" in child["argv"]
        assert child["argv"][child["argv"].index("TPU_METRICS") + 1] == "1"


def test_scenarios_reach_their_policies(tmp_path, monkeypatch):
    """The evidence each scenario exists for, read off the port's run
    (the parity test above holds the reference to the same)."""
    def port(name):
        d = tmp_path / name
        got = _drive(d, monkeypatch, SCENARIOS[name][0],
                     REF_AS.get(name))["port"]
        return got, [r["event"] for r in got["records"]]

    got, ev = port("audit_rollback")
    assert [d for d in got["dir"] if d.startswith(".bad-ckpt-000000000020")]
    assert "rollback" in ev
    got, ev = port("kernel_crash")
    assert got["children"][1]["argv"] == got["children"][0]["argv"]
    assert "TPU_USE_PALLAS" not in got["children"][1]["argv"]
    assert "pallas_fallback" not in ev and "backoff" in ev
    assert got["kernel_crashes"] == 1 and got["counts"][6] == 1
    got, ev = port("sdc_exit")
    assert [d for d in got["dir"] if d.startswith("ckpt-")] \
        == ["ckpt-000000000008"] and "sdc_rollback" in ev
    got, ev = port("corrupt_ckpt_once")
    assert got["counts"][2]["corrupt_ckpt"] == 1
    got, ev = port("healthy_reset")
    assert "budget_reset" in ev and got["counts"][6] == 0
    got, ev = port("runlog_rotation")
    assert got["rotated"]
    got, ev = port("sigterm_in_backoff")
    assert "supervisor_preempted" in ev and got["counts"][0] == 1
    got, ev = port("fault_plan")
    assert [c["env"].get("TPU_FAULT") for c in got["children"]] \
        == ["sigkill@update=5", "sigkill@update=9", None]
    got, ev = port("stderr_tail")
    crash = [r for r in got["records"] if r["event"] == "exit"][0]
    assert len(crash["stderr_tail"].encode()) \
        <= tsup.STDERR_TAIL_RECORD_BYTES
    assert "FATAL: the actual traceback" in crash["stderr_tail"]


@pytest.mark.parametrize("argv, match", [
    (["-set", "TPU_CKPT_DIR", "{d}"], "data dir"),
    (["-d", "{d}"], "TPU_CKPT_DIR"),
    (["-d", "{d}", "-set", "TPU_CKPT_DIR", "{d}", "-set", "TPU_FAULT",
      "crash"], "fault-plan"),
    (["-d", "{d}", "-set", "TPU_CKPT_DIR", "{d}", "-set", "TPU_METRICS",
      "0"], "heartbeat"),
])
def test_unsupervisable_argv_refused_as_reference(tmp_path, argv, match):
    argv = [a.format(d=tmp_path) for a in argv]
    msgs = []
    for S in PKGS.values():
        with pytest.raises(ValueError, match=match) as e:
            S.sup.Supervisor(argv, env={})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the alert plane inside the poll loop (tests/test_alerts.py's scenarios)
# ---------------------------------------------------------------------------

class ForeverProc:
    """A child that never exits unless told to."""
    pid = 777

    def __init__(self):
        self.returncode = None
        self.exit_now = False

    def poll(self):
        if self.exit_now:
            self.returncode = 0
        return self.returncode

    def kill(self):
        self.returncode = -9

    def wait(self, timeout=None):
        return -9

    def terminate(self):
        self.returncode = 0

    def send_signal(self, sig):
        pass


def _ring(data, rows):
    ring = rhistory.hist_path(os.path.join(data, "metrics.prom"))
    for t, v in sorted(rows.items()):
        rhistory.append_sample(ring, v, now=t)


def _alert_sup(root, S, clk, procs):
    data, ck = str(root / "data"), str(root / "ck")
    os.makedirs(data, exist_ok=True)
    os.makedirs(ck, exist_ok=True)

    def spawn(argv, env, logf):
        procs.append(ForeverProc())
        return procs[-1]

    return S.sup.Supervisor(
        ["-d", data, "-set", "TPU_CKPT_DIR", ck, "-u", "100"],
        cfg=S.sup.SupervisorConfig(watchdog_sec=1e6, poll_sec=0.5,
                                   grace_sec=1e6, max_retries=2,
                                   backoff_base=0.1, backoff_cap=1.0,
                                   healthy_sec=1e9, seed=2),
        env={}, spawn=spawn, clock=clk, sleep=clk.sleep), data


def _snap(sup, data, steps):
    journal = os.path.join(data, "alerts.jsonl")
    steps.append({
        "state": sup.state,
        "firing": sorted(sup.alerts.firing) if sup.alerts else None,
        "journal": (open(journal).read()
                    if os.path.exists(journal) else None),
        "prom": _shared_prom(
            open(os.path.join(data, "supervisor.prom")).read())})


def al_poll_loop(root, S, clk):
    procs, steps = [], []
    sup, data = _alert_sup(root, S, clk, procs)
    _ring(data, {float(t): {"avida_update": 42.0,
                            "avida_heartbeat_timestamp_seconds": float(t)}
                 for t in range(900, 1001, 5)})
    sup.poll()                  # idle -> launch (no eval pre-launch)
    _snap(sup, data, steps)
    sup.poll()                  # running -> stall fires on the ring
    _snap(sup, data, steps)
    _ring(data, {float(t): {"avida_update": 42.0 + t - 1000.0}
                 for t in range(1001, 1011)})
    clk.t = 1010.0
    sup.poll()                  # the counter advances -> resolved
    _snap(sup, data, steps)
    return steps


def al_terminal_sweep(root, S, clk):
    procs, steps = [], []
    sup, data = _alert_sup(root, S, clk, procs)
    _ring(data, {float(t): {"avida_update": 42.0}
                 for t in range(900, 1001, 5)})
    sup.poll()
    sup.poll()
    _snap(sup, data, steps)
    _ring(data, {float(t): {"avida_update": 42.0 + t - 1000.0}
                 for t in range(1001, 1011)})
    clk.t = 1010.0
    sup._alerts_next = clk.t + 100.0    # the throttle closed
    procs[0].exit_now = True
    sup.poll()                          # exit -> the terminal sweep
    _snap(sup, data, steps)
    return steps


def al_previous_ring(root, S, clk):
    procs, steps = [], []
    sup, data = _alert_sup(root, S, clk, procs)
    _ring(data, {float(t): {"avida_update": 42.0,
                            "avida_heartbeat_timestamp_seconds": float(t)}
                 for t in range(300, 401, 5)})
    sup.poll()
    clk.t = 1006.0
    sup.poll()                          # compile window: frozen
    _snap(sup, data, steps)
    _ring(data, {float(t): {"avida_update": 50.0 + t,
                            "avida_heartbeat_timestamp_seconds": float(t)}
                 for t in range(1007, 1013)})
    clk.t = 1012.0
    sup.poll()
    _snap(sup, data, steps)
    return steps


def al_disabled_and_bad_rules(root, S, clk):
    data, ck = str(root / "data"), str(root / "ck")
    os.makedirs(data)
    os.makedirs(ck)
    argv = ["-d", data, "-set", "TPU_CKPT_DIR", ck]
    out = [S.sup.Supervisor(argv, env={"TPU_ALERT_EVAL_SEC": "0"},
                            spawn=lambda *a: ForeverProc()).alerts]
    for text in ("{}", json.dumps([{"name": "x", "family": "f",
                                    "kind": "threshold", "value": None}])):
        with open(os.path.join(data, "alerts.json"), "w") as f:
            f.write(text)
        out.append(S.sup.Supervisor(argv, env={},
                                    spawn=lambda *a: ForeverProc()).alerts)
    return out


ALERT_SCENARIOS = {
    "poll_loop": al_poll_loop,
    "terminal_sweep": al_terminal_sweep,
    "previous_ring": al_previous_ring,
    "disabled_and_bad_rules": al_disabled_and_bad_rules,
}


@pytest.mark.parametrize("name", list(ALERT_SCENARIOS))
def test_supervisor_alerts_equal_reference(tmp_path, monkeypatch, capsys,
                                           name):
    """The poll loop's alert evaluation, the terminal sweep, the previous
    incarnation's ring and the disabled / malformed rule files: the same
    firing sets, alert journal and supervisor.prom after each step, and
    the same stderr."""
    monkeypatch.setattr(time, "time", lambda: PINNED)
    got, err = {}, {}
    for pkg, S in PKGS.items():
        root = tmp_path / pkg
        got[pkg] = _norm(ALERT_SCENARIOS[name](root, S, FakeClock(1000.0)),
                         root)
        # the reference's launch field (it never degrades here)
        err[pkg] = capsys.readouterr().err.replace(str(root), "<root>") \
            .replace(" xla_fallback=False", "")
    assert got["port"] == got["ref"] and err["port"] == err["ref"]
    if name == "poll_loop":
        assert [s["firing"] for s in got["port"]] == [[], ["stall"], []]
    elif name == "terminal_sweep":
        assert got["port"][-1]["state"] == "done"
        assert got["port"][-1]["journal"].count('"resolved"') == 1
    elif name == "previous_ring":
        assert got["port"][0]["journal"] is None
    else:
        assert got["port"] == [None, None, None]
        assert err["port"].count("alert rules disabled") == 2


# ---------------------------------------------------------------------------
# backoff, classify, the kernel matcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 8, 11, 12345])
def test_retry_policy_equals_reference(seed):
    """The same delays, budget and refills for the same seed and calls."""
    trail = {}
    for name, mod in (("ref", rbackoff), ("port", tbackoff)):
        p = mod.RetryPolicy(max_retries=6, base=0.25 + seed % 3,
                            cap=20.0, healthy_sec=60.0, seed=seed)
        out = []
        for step in range(14):
            if p.can_retry():
                out.append(("delay", p.next_delay(), p.budget_left()))
            else:
                out.append(("healthy", p.note_healthy(30.0 * step),
                            p.budget_left()))
        trail[name] = out
    assert trail["port"] == trail["ref"]
    with pytest.raises(ValueError):
        tbackoff.RetryPolicy(base=0.0)
    with pytest.raises(ValueError):
        tbackoff.RetryPolicy(base=2.0, cap=1.0)


def test_exit_codes_and_classify_equal_reference():
    for k in ("EXIT_AUDIT", "EXIT_CKPT", "EXIT_SDC", "FAILURE_CLASSES"):
        assert getattr(tservice, k) == getattr(rservice, k)
    from avida_tpu_torch import __main__ as tmain
    assert (tmain.EXIT_AUDIT, tmain.EXIT_CKPT, tmain.EXIT_SDC) == (65, 66, 67)
    for code in (-15, -9, -6, 0, 1, 2, 3, 64, 65, 66, 67, 68, 137):
        for wd in (False, True):
            for an in (False, True):
                for pre in (False, True):
                    kw = dict(watchdog_killed=wd, anomaly_killed=an,
                              preempted=pre)
                    assert tsup.classify(code, **kw) \
                        == rsup.classify(code, **kw), (code, kw)


REF_TAILS = [
    "jax._src.pallas.mosaic.lowering: boom",
    "Mosaic failed to compile",
    "ValueError: seed genome length",
    "jax._src.pallas.mosaic.lowering.LoweringError: bad\n",
    "[avida-tpu] checkpoint_corrupt: path=gen error=CRC\n",
    "FATAL: the actual traceback\n",
    "StateDivergenceError: scrub digest mismatch (last_verified_update=16)",
    "Traceback (most recent call last):\n  ...\nMemoryError\n",
]


def _kernel_messages():
    """The constant text of every RuntimeError ops/cycles.py raises, and
    the message its nvcc lookup gives where there is no nvcc."""
    import ast
    path = os.path.join(REPO, "avida_tpu_torch", "ops", "cycles.py")
    msgs = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call) \
                and getattr(node.exc.func, "id", None) == "RuntimeError":
            arg = node.exc.args[0]
            parts = arg.values if isinstance(arg, ast.JoinedStr) else [arg]
            msgs.append("".join(p.value for p in parts
                                if isinstance(p, ast.Constant)))
    return msgs


def test_kernel_matcher():
    """kernel_suspect agrees with the reference's pallas_suspect on the
    reference's tails, and names every kernel failure of the port."""
    assert tsup.pallas_suspect is tsup.kernel_suspect
    for tail in REF_TAILS:
        assert tsup.kernel_suspect(tail) == rsup.pallas_suspect(tail), tail
    msgs = _kernel_messages()
    assert len(msgs) >= 6, msgs
    for m in msgs:
        assert tsup.kernel_suspect(m), m
    import shutil

    from avida_tpu_torch.ops import cycles
    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError) as e:
            cycles._nvcc()
        assert tsup.kernel_suspect(str(e.value))
    assert tsup.kernel_suspect("RuntimeError: CUDA error: an illegal "
                               "memory access was encountered")
    assert tsup.kernel_suspect("OSError: avida_tpu_torch/_build/"
                               "libcycles-0123abcd.so: cannot open")


@pytest.mark.parametrize("last, rc", [("success", 0), ("crash", 1)])
def test_port_kernel_crash_stays_on_the_kernel(tmp_path, last, rc):
    """The port's own kernel failure in a crash log: counted (the exit
    record's pallas_suspect, avida_supervisor_kernel_crashes_total),
    then relaunched on the kernel route after a backoff, with the
    child's argv unchanged and one unit of retry budget spent a crash;
    kernel crashes past the budget give up as any crash does."""
    clk = FakeClock()
    line = "RuntimeError: cycle kernel launch failed (CUDA error 719)\n"
    crash = dict(code=1, runtime=0.0, on_spawn=_log(line))
    sup, spawned = _mk(tmp_path, PKGS["port"], clk, [
        FakeProc(clk, **crash), FakeProc(clk, **crash),
        FakeProc(clk, **crash) if last == "crash"
        else FakeProc(clk, code=0, runtime=0.0, on_spawn=_beat(clk))],
        max_retries=2)
    assert sup.run() == rc
    recs = records.read_records(str(tmp_path / "data" / "supervisor.jsonl"))
    events = [r["event"] for r in recs]
    assert "pallas_fallback" not in events
    assert events.count("backoff") == 2
    assert events[-1] == ("done" if last == "success" else "giving_up")
    assert all("xla_fallback" not in r for r in recs)
    n = 3 if last == "crash" else 2
    assert [r["pallas_suspect"] for r in recs if r["event"] == "exit"] \
        == [True] * n + [False] * (3 - n)
    assert sup.kernel_crashes == sup.failures["crash"] == n
    assert sup.policy.failures == 2 and sup.policy.budget_left() == 0
    assert len(spawned) == 3
    for p in spawned:
        assert p.argv[1:3] == ["-m", "avida_tpu_torch"]
        assert p.argv[3:] == spawned[0].argv[3:]
        assert "TPU_USE_PALLAS" not in p.argv
    from avida_tpu_torch.observability.exporter import read_metrics
    m = read_metrics(str(tmp_path / "data" / "supervisor.prom"))
    assert m["avida_supervisor_kernel_crashes_total"] == n
    assert not any("pallas_fallbacks" in k for k in m)


def test_config_from_env_equals_reference():
    env = {"TPU_WATCHDOG_SEC": "40", "TPU_SUPERVISE_POLL_SEC": "0.3",
           "TPU_SUPERVISE_GRACE_SEC": "100", "TPU_SUPERVISE_MAX_RETRIES": "3",
           "TPU_SUPERVISE_BACKOFF_BASE": "0.5",
           "TPU_SUPERVISE_BACKOFF_CAP": "4", "TPU_SUPERVISE_HEALTHY_SEC": "9",
           "TPU_SUPERVISE_SEED": "5", "TPU_SUPERVISE_ANOM": "0",
           "TPU_PROGRESS_SEC": "7.5"}
    for e in ({}, env, {"TPU_WATCHDOG_SEC": "400"}):
        a = vars(rsup.SupervisorConfig.from_env(e))
        b = vars(tsup.SupervisorConfig.from_env(e))
        assert a == b
    assert tsup.SupervisorConfig.from_env({}).progress_sec == 0.0


# ---------------------------------------------------------------------------
# no torch in the supervisor's process; the CLI's dispatch
# ---------------------------------------------------------------------------

_NO_TORCH = r"""
import sys
import avida_tpu_torch.service.supervisor
import avida_tpu_torch.service.fleet
import avida_tpu_torch.service.serve
import avida_tpu_torch.tools.ckpt_tool
import avida_tpu_torch.tools.fleet_tool
import avida_tpu_torch.tools.metrics_tool
import avida_tpu_torch.utils.churntrace
from avida_tpu_torch.service.fleet import spec_seed_and_batch_key
spec_seed_and_batch_key({"argv": ["-u", "4", "-s", "7"]})
bad = sorted(m for m in sys.modules
             if m in ("torch", "jax", "avida_tpu")
             or m.startswith(("torch.", "jax.", "avida_tpu.")))
print(bad)
assert not bad, bad
"""

_SUPERVISE_CLI = r"""
import sys
from avida_tpu_torch.service import supervisor as s


class Done:
    returncode = 0

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0


def spawn(argv, env, logf):
    print("SPAWN", "torch" in sys.modules, argv[1:3], argv[-1])
    return Done()


s.Supervisor._spawn_default = staticmethod(spawn)
from avida_tpu_torch.__main__ import main
rc = main(["--supervise", "--fault-plan", "sigkill@update=3", "-d", {d!r},
           "-set", "TPU_CKPT_DIR", {c!r}, "-u", "4", "--device", "cpu"])
print("RC", rc, "torch" in sys.modules)
"""


def test_supervisor_and_tools_import_no_torch():
    res = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_supervise_cli_runs_without_torch(tmp_path):
    """`python -m avida_tpu_torch --supervise ...` up to and past its
    first child spawn (a stand-in child that exits 0): no torch in the
    supervisor's process, the child launched as `-m avida_tpu_torch`
    with --resume appended and --device cpu passed through."""
    d, c = str(tmp_path / "d"), str(tmp_path / "c")
    res = subprocess.run(
        [sys.executable, "-c", _SUPERVISE_CLI.format(d=d, c=c)], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "SPAWN False ['-m', 'avida_tpu_torch'] --resume" in res.stdout
    assert "RC 0 False" in res.stdout
    recs = records.read_records(os.path.join(d, "supervisor.jsonl"))
    assert recs[0]["event"] == "launch"
    assert recs[0]["fault"] == "sigkill@update=3"
    log = open(os.path.join(d, "supervised.log")).read()
    assert "--- supervisor boot 0 ---" in log


def test_fleet_refused_and_fault_plan_needs_argument(tmp_path, capsys,
                                                     monkeypatch):
    """The fleet's argument checks, equal to the reference's fleet_main
    (a spool, an integer --max-jobs, nothing unknown); the streaming
    serve pool (--dynamic, TPU_FLEET_DYNAMIC=1) runs as the reference's
    does, and a bare --dynamic is the parser's usage error in both; and
    --supervise's own checks."""
    from avida_tpu.service.fleet import fleet_main as ref_fleet_main

    from avida_tpu_torch.__main__ import main
    monkeypatch.delenv("TPU_FLEET_DYNAMIC", raising=False)
    spool = str(tmp_path / "spool")
    for argv in (["--fleet"], ["--fleet", spool, "--max-jobs", "x"],
                 ["--fleet", spool, "--bogus"]):
        assert main(argv) == ref_fleet_main(argv) == 2
    assert not os.path.exists(spool)
    capsys.readouterr()
    from avida_tpu.__main__ import main as ref_main
    codes = []
    for m in (main, ref_main):
        with pytest.raises(SystemExit) as e:
            m(["--dynamic"])
        codes.append(e.value.code)
    assert codes == [2, 2]
    for k, argv in enumerate((["--fleet", "{}", "--dynamic"],
                              ["--fleet", "{}"])):
        if k:
            monkeypatch.setenv("TPU_FLEET_DYNAMIC", "1")
        runs = [[a.format(tmp_path / f"dyn{k}{who}") for a in argv]
                for who in ("port", "ref")]
        assert main(runs[0]) == ref_fleet_main(runs[1]) == 0
    monkeypatch.delenv("TPU_FLEET_DYNAMIC")
    assert "item 16c" not in capsys.readouterr().err
    assert main(["--supervise", "-d", str(tmp_path), "--fault-plan"]) == 2
    assert main(["--supervise", "-d", str(tmp_path)]) == 2
    assert "TPU_CKPT_DIR" in capsys.readouterr().err
