"""Self-healing run supervisor: `python -m avida_tpu_torch --supervise ...`.

Counterpart of avida_tpu/service/supervisor.py, with the same policies,
records and counters, except for a crash that implicates the kernel
(below).  A single run is crash-SAFE on its own (bit-exact
checkpoints with CRC fallback, SIGTERM preemption, `--resume`, the
metrics.prom heartbeat); this module makes it crash-SURVIVING.  The
supervisor launches the world run as a child process
(`python -m avida_tpu_torch`, on `cuda` unless the child's argv says
`--device cpu`) and watches it entirely from OUTSIDE -- it never imports
torch, so a wedged CUDA runtime, an OOM-killed child or a corrupted
interpreter state cannot take the watchdog down with it:

  * liveness: the age of the `avida_heartbeat_timestamp_seconds` sample
    in DATA_DIR/metrics.prom (republished by the child at every chunk
    boundary).  Stale past TPU_WATCHDOG_SEC -> SIGKILL (a hung chunk
    ignores SIGTERM by definition).  A boot grace period
    (TPU_SUPERVISE_GRACE_SEC) covers the child's start (torch import,
    CUDA context, world build, resume) before the first heartbeat.
  * restart: exponential backoff with decorrelated jitter and a capped
    retry budget (service/backoff.py); the budget refills after
    TPU_SUPERVISE_HEALTHY_SEC of continuous health.  Every relaunch
    appends `--resume`, so recovery is bit-exact from the newest
    CRC-valid generation (utils/checkpoint.py).
  * failure taxonomy, recorded as {"record": "supervisor"} runlog lines
    in DATA_DIR/supervisor.jsonl and exported as Prometheus counters in
    DATA_DIR/supervisor.prom:

      crash            nonzero exit / signal death (incl. SIGKILL)
      hang             watchdog-killed stale heartbeat
      audit_violation  StateInvariantError (child exit EXIT_AUDIT) or a
                       flight-recorder anomaly onset seen in metrics
      corrupt_ckpt     resume found no valid generation (EXIT_CKPT), or
                       the child logged a checkpoint_corrupt fallback
      sdc              a scrub caught a state divergence (EXIT_SDC)
      preempt          clean SIGTERM preemption (exit 0 + heartbeat
                       preempted=1): relaunched immediately, consuming
                       NO retry budget

  * recovery policies:
      - audit_violation -> ROLLBACK: quarantine the newest checkpoint
        generation (renamed to `.bad-*`, invisible to resume) so the
        child restarts from the previous good one instead of replaying
        the corrupt state.
      - sdc -> quarantine every generation past the child's last
        scrub-verified update, then digest-verify the survivors.
      - a crash whose log implicates the cycle kernel (`kernel_suspect`:
        the reference's "pallas" / "mosaic", and the port's own "cycle
        kernel", "nvcc", "CUDA error" and "libcycles" failures) is
        recorded (the exit record's `pallas_suspect`, the
        avida_supervisor_kernel_crashes_total counter) and then takes
        the backoff and retry budget of any other crash, on the kernel
        route.  Unlike the reference, which relaunches such a crash
        once with `-set TPU_USE_PALLAS 2`, the port never routes a run
        around its kernel.

Fault injection rides the same interface: the supervisor's `fault_plan`
hands boot i the i-th TPU_FAULT spec (utils/faultinject.py) via the
child environment and strips it from every later boot, so an injected
failure fires exactly once.

All timing dependencies (clock, sleep, process spawn) are injectable,
so the policy logic is unit-testable with a fake clock and fake
children -- no real sleeps, no real processes
(tests/test_torch_supervisor.py).
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import sys
import time

from avida_tpu_torch.observability import alerts as alerts_mod
from avida_tpu_torch.observability import history
from avida_tpu_torch.observability.exporter import (METRICS_FILE,
                                                    MULTIWORLD_METRICS_FILE,
                                                    read_metrics,
                                                    render_families,
                                                    write_metrics)
from avida_tpu_torch.observability.records import append_record
from avida_tpu_torch.service import (EXIT_AUDIT, EXIT_CKPT, EXIT_SDC,
                                     FAILURE_CLASSES)
from avida_tpu_torch.service.backoff import RetryPolicy
from avida_tpu_torch.utils import integrity
from avida_tpu_torch.utils.checkpoint import (list_generations,
                                              quarantine_after)

RUNLOG_FILE = "supervisor.jsonl"
SUPERVISOR_METRICS_FILE = "supervisor.prom"

# the kernel's words in a crash log: the reference's Pallas/Mosaic path,
# and the port's own failures -- ops/cycles.py raises "cycle kernel ..."
# (occupancy query, no cluster fits, launch failed with a CUDA error
# code) and "nvcc ..." (not found, compile or link failed); torch
# reports an asynchronous fault of a launch as "CUDA error: ...", and a
# missing or broken library names libcycles-<digest>.so
_KERNEL_RE = re.compile(
    r"pallas|mosaic|cycle kernel|nvcc|CUDA error|libcycles", re.IGNORECASE)
_HEARTBEAT = "avida_heartbeat_timestamp_seconds"
_ANOM_RE = re.compile(r'^avida_trace_code_total\{code="anom_')


def classify(exit_code: int, *, watchdog_killed: bool = False,
             anomaly_killed: bool = False, preempted: bool = False) -> str:
    """Map one child exit to the failure taxonomy ('success' when the
    run completed).  Supervisor-initiated kills take precedence over the
    exit code they caused."""
    if watchdog_killed:
        return "hang"
    if anomaly_killed:
        return "audit_violation"
    if exit_code == 0:
        return "preempt" if preempted else "success"
    if exit_code == EXIT_AUDIT:
        return "audit_violation"
    if exit_code == EXIT_CKPT:
        return "corrupt_ckpt"
    if exit_code == EXIT_SDC:
        return "sdc"
    return "crash"


def kernel_suspect(stderr_tail: str) -> bool:
    """Does a crash's log implicate the cycle kernel (the reference's
    Pallas/Mosaic words or the port's CUDA kernel and its build)?"""
    return bool(_KERNEL_RE.search(stderr_tail))


pallas_suspect = kernel_suspect     # the reference's name


def _anomaly_total(metrics: dict) -> float:
    """Sum of the flight recorder's anom_* event counters in a parsed
    metrics.prom dict (0 when tracing is off)."""
    return sum(v for k, v in metrics.items() if _ANOM_RE.match(k))


class SupervisorConfig:
    """Knobs, all overridable via the environment (documented in the
    README's supervised-runs section)."""

    def __init__(self, watchdog_sec: float = 120.0,
                 poll_sec: float | None = None, grace_sec: float = 900.0,
                 max_retries: int = 8, backoff_base: float = 1.0,
                 backoff_cap: float = 60.0, healthy_sec: float = 300.0,
                 seed: int = 0, anomaly_watch: bool = True,
                 progress_sec: float = 0.0):
        self.watchdog_sec = float(watchdog_sec)
        self.poll_sec = (min(max(self.watchdog_sec / 8, 0.2), 5.0)
                         if poll_sec is None else float(poll_sec))
        self.grace_sec = float(grace_sec)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.healthy_sec = float(healthy_sec)
        self.seed = int(seed)
        self.anomaly_watch = bool(anomaly_watch)
        # livelock watchdog (default OFF): a child can wedge while still
        # republishing its heartbeat file -- with progress_sec > 0 the
        # watchdog also requires the avida_update counter to ADVANCE
        # within this window once heartbeats have started
        self.progress_sec = float(progress_sec)

    @classmethod
    def from_env(cls, env) -> "SupervisorConfig":
        def f(name, default):
            return float(env.get(name, default))
        return cls(
            watchdog_sec=f("TPU_WATCHDOG_SEC", 120.0),
            poll_sec=(float(env["TPU_SUPERVISE_POLL_SEC"])
                      if "TPU_SUPERVISE_POLL_SEC" in env else None),
            grace_sec=f("TPU_SUPERVISE_GRACE_SEC", 900.0),
            max_retries=int(f("TPU_SUPERVISE_MAX_RETRIES", 8)),
            backoff_base=f("TPU_SUPERVISE_BACKOFF_BASE", 1.0),
            backoff_cap=f("TPU_SUPERVISE_BACKOFF_CAP", 60.0),
            healthy_sec=f("TPU_SUPERVISE_HEALTHY_SEC", 300.0),
            seed=int(f("TPU_SUPERVISE_SEED", 0)),
            anomaly_watch=bool(int(f("TPU_SUPERVISE_ANOM", 1))),
            progress_sec=f("TPU_PROGRESS_SEC", 0.0),
        )


def _child_setting(argv: list, name: str):
    """The LAST `-set NAME VALUE` in a child argv (None when absent)."""
    val = None
    for i in range(len(argv) - 2):
        if argv[i] == "-set" and argv[i + 1] == name:
            val = argv[i + 2]
    return val


def _child_data_dir(argv: list):
    val = None
    for i, a in enumerate(argv):
        if a in ("-d", "--data-dir") and i + 1 < len(argv):
            val = argv[i + 1]
    return val


class Outcome:
    """One boot's result: classification + the evidence behind it."""

    def __init__(self, cls: str, exit_code, *, pallas: bool = False,
                 corrupt_seen: bool = False, update=None,
                 verified_update=None):
        self.cls = cls
        self.exit_code = exit_code
        self.pallas = pallas
        self.corrupt_seen = corrupt_seen
        self.update = update
        # newest scrub-verified update the child reported in its
        # divergence error (None when the tail carried no marker):
        # the sdc rollback's quarantine horizon
        self.verified_update = verified_update


# postmortem context: failure-class exit records carry this much of the
# child's log tail (bytes, utf-8) so the crash evidence survives log
# truncation/rotation alongside the taxonomy class
STDERR_TAIL_RECORD_BYTES = 2048


class _Boot:
    """Per-boot watch state for the non-blocking poll() machine: one
    instance lives from _launch() to _finish()."""

    __slots__ = ("proc", "logf", "log_start", "t0", "hb0",
                 "watchdog_killed", "anomaly_killed", "anom0",
                 "healthy_since", "term_deadline", "hb_max", "hb_fresh_t",
                 "prog_val", "prog_t")

    def __init__(self, proc, logf, log_start, t0, hb0):
        self.proc = proc
        self.logf = logf
        self.log_start = log_start
        self.t0 = t0
        self.hb0 = hb0
        self.watchdog_killed = False
        self.anomaly_killed = False
        self.anom0 = None
        self.healthy_since = None
        self.term_deadline = None       # set after a graceful SIGTERM
        self.hb_max = None              # newest heartbeat timestamp seen
        self.hb_fresh_t = None          # our clock at its last advance
        self.prog_val = None            # last avida_update counter value
        self.prog_t = None              # our clock at its last advance


class Supervisor:
    def __init__(self, child_argv, *, data_dir=None, ckpt_dir=None,
                 fault_plan=(), cfg: SupervisorConfig | None = None,
                 env=None, spawn=None, clock=time.time,
                 sleep=time.sleep):
        self.child_argv = list(child_argv)
        base_env = dict(os.environ if env is None else env)
        self.cfg = cfg or SupervisorConfig.from_env(base_env)
        self.data_dir = data_dir or _child_data_dir(self.child_argv)
        self.ckpt_dir = ckpt_dir or _child_setting(self.child_argv,
                                                   "TPU_CKPT_DIR")
        if not self.data_dir:
            raise ValueError("--supervise needs the child's data dir "
                             "(-d DIR) to read its heartbeat")
        if not self.ckpt_dir:
            raise ValueError("--supervise needs -set TPU_CKPT_DIR DIR in "
                             "the child args (restart recovery resumes "
                             "from native checkpoints)")
        if _child_setting(self.child_argv, "TPU_FAULT") is not None:
            raise ValueError("pass injected faults via --fault-plan, not "
                             "-set TPU_FAULT (a fault baked into the child "
                             "args would re-fire on every restart)")
        # the heartbeat is the watchdog's only liveness signal -- force
        # the exporter on (idempotent when the user already set it) and
        # refuse an explicit opt-out, which would reduce every healthy
        # boot to a grace-period timeout kill
        metrics_set = _child_setting(self.child_argv, "TPU_METRICS")
        if metrics_set is not None and not int(metrics_set):
            raise ValueError("-set TPU_METRICS 0 disables the heartbeat "
                             "the supervisor's watchdog lives on; drop it "
                             "(supervised children always export metrics)")
        if metrics_set is None and "--trace" not in self.child_argv:
            self.child_argv += ["-set", "TPU_METRICS", "1"]
        if "--resume" not in self.child_argv:
            self.child_argv.append("--resume")
        self.fault_plan = list(fault_plan)
        self._base_env = base_env
        self._base_env.pop("TPU_FAULT", None)
        self.policy = RetryPolicy(
            max_retries=self.cfg.max_retries, base=self.cfg.backoff_base,
            cap=self.cfg.backoff_cap, healthy_sec=self.cfg.healthy_sec,
            seed=self.cfg.seed)
        self._spawn = spawn or self._spawn_default
        self._clock = clock
        self._sleep = sleep
        self.boots = 0
        self.restarts = 0
        self.failures = {c: 0 for c in FAILURE_CLASSES}
        self.watchdog_kills = 0
        self.rollbacks = 0
        self.kernel_crashes = 0
        self.ckpt_fallbacks = 0
        self.last_exit_code = 0
        self._proc = None
        self._stop = False
        self._corrupt_counted = set()   # generation paths already tallied
        # ---- poll() state machine ----
        # "idle" (next poll launches) -> "running" -> "backoff" -> ... ->
        # "done" (exit_rc 0) | "failed" (exit_rc 1).  The blocking run()
        # is a thin sleep-between-polls wrapper; a fleet orchestrator
        # (service/fleet.py) multiplexes many supervisors by calling
        # poll() round-robin instead.
        self.state = "idle"
        self.exit_rc = None
        self._ctx = None                # _Boot while state == "running"
        self._backoff_until = 0.0
        self.succeeded = False          # True only after a "done" record
        self.last_outcome = None        # newest Outcome (a fleet reads it)
        self.runlog_path = os.path.join(self.data_dir, RUNLOG_FILE)
        self.metrics_path = os.path.join(self.data_dir,
                                         SUPERVISOR_METRICS_FILE)
        self.child_log_path = os.path.join(self.data_dir, "supervised.log")
        # size-capped rotation (runlog.append_record): a long heal loop
        # must not grow supervisor.jsonl without bound
        self.runlog_max_bytes = int(
            self._base_env.get("TPU_RUNLOG_MAX_BYTES", 16 << 20))
        # alert plane (observability/alerts.py): the poll loop -- which
        # already reads the child's heartbeat -- additionally evaluates
        # the declarative rule set over the history rings beside it.
        # Firing/resolving edges journal to DATA_DIR/alerts.jsonl and
        # export on supervisor.prom; detection only, the watchdog stays
        # the sole kill authority.  TPU_ALERT_EVAL_SEC=0 disables.
        self.alert_eval_sec = float(
            self._base_env.get("TPU_ALERT_EVAL_SEC", 5.0))
        self.alerts = None
        if self.alert_eval_sec > 0:
            try:
                self.alerts = alerts_mod.AlertPlane(
                    alerts_mod.load_rules(self.data_dir),
                    journal_path=os.path.join(self.data_dir,
                                              alerts_mod.ALERTS_FILE),
                    max_bytes=self.runlog_max_bytes)
            except (OSError, ValueError) as e:
                # a malformed alerts.json must be loud but must not
                # take supervision down with it
                print(f"[supervisor] alert rules disabled: {e}",
                      file=sys.stderr)
        self._alerts_next = 0.0
        self._hist = history.HistorySink(self.metrics_path,
                                         env=self._base_env)

    # ---- plumbing ----

    @staticmethod
    def _spawn_default(argv, env, log_file):
        return subprocess.Popen(argv, env=env, stdout=log_file,
                                stderr=log_file)

    def record(self, event: str, **fields):
        rec = {"record": "supervisor", "event": event,
               "time": self._clock(), "boot": self.boots, **fields}
        try:
            append_record(self.runlog_path, rec,
                          max_bytes=self.runlog_max_bytes)
        except OSError:
            pass                        # logging must not kill recovery
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[supervisor] {event}" + (f": {detail}" if detail else ""),
              file=sys.stderr)
        self.publish_metrics(child_up=self._proc is not None
                             and self._proc.poll() is None)

    def publish_metrics(self, child_up: bool = False):
        fams = [
            ("avida_supervisor_boots_total", "counter",
             "child launches (first boot + every restart)", self.boots),
            ("avida_supervisor_restarts_total", "counter",
             "relaunches after a failure or preemption", self.restarts),
            ("avida_supervisor_failures_total", "counter",
             "classified child failures",
             {f'class="{c}"': n for c, n in self.failures.items()}),
            ("avida_supervisor_watchdog_kills_total", "counter",
             "children SIGKILLed for a stale heartbeat",
             self.watchdog_kills),
            ("avida_supervisor_rollbacks_total", "counter",
             "newest-generation quarantines after audit violations",
             self.rollbacks),
            ("avida_supervisor_kernel_crashes_total", "counter",
             "crashes whose log implicates the cycle kernel",
             self.kernel_crashes),
            ("avida_supervisor_ckpt_fallbacks_total", "counter",
             "corrupt-checkpoint fallbacks observed in child logs",
             self.ckpt_fallbacks),
            ("avida_supervisor_retry_budget", "gauge",
             "failures left before the supervisor gives up",
             self.policy.budget_left()),
            ("avida_supervisor_child_up", "gauge",
             "1 while a child process is running", int(child_up)),
            ("avida_supervisor_last_exit_code", "gauge",
             "the previous child's exit code (negative = signal)",
             self.last_exit_code),
        ]
        if self.alerts is not None:
            fams += self.alerts.families()
        try:
            text = render_families(fams)
            write_metrics(self.metrics_path, text, durable=False)
            self._hist.publish(text)
        except OSError:
            pass

    def _eval_alerts(self):
        """Evaluate the alert rules over the child's history rings, at
        most every alert_eval_sec.  Runs while a child is alive or
        backing off -- a hung or backing-off child keeps its
        staleness/stall alerts honest -- but NOT in the idle state
        (nothing has launched yet; a resume's leftover ring from the
        previous incarnation is evidence of the past, not of a child
        that does not exist), and not against a ring that predates the
        current boot (the compile window of a resumed run would
        otherwise page `stall` on the old incarnation's final samples;
        alert state is FROZEN, not resolved, while evaluation is
        paused, so an alert that fired before a restart stays firing
        until post-launch samples clear it)."""
        if self.alerts is None or self.state == "idle":
            return
        now = self._clock()
        if now < self._alerts_next:
            return
        self._alerts_next = now + self.alert_eval_sec
        # rings are handed to the evaluator SEPARATELY (never merged):
        # on a serve child metrics.prom carries the batch-max counter
        # while multiworld.prom carries per-tenant rows -- one family,
        # two meanings (alerts.samples_for)
        samples = {
            "metrics": history.read_samples(
                history.hist_path(os.path.join(self.data_dir,
                                               METRICS_FILE)),
                tail_bytes=256 << 10),
            "multiworld": history.read_samples(
                history.hist_path(os.path.join(
                    self.data_dir, MULTIWORLD_METRICS_FILE)),
                tail_bytes=256 << 10),
        }
        if self.state == "running" and self._ctx is not None:
            newest = max((s.get("time", 0.0) for rows in samples.values()
                          for s in rows), default=None)
            if newest is not None and newest < self._ctx.t0:
                return          # previous incarnation's ring (see above)
        transitions = self.alerts.observe(samples, now)
        for name, state, res in transitions:
            val = res.get("value")
            print(f"[supervisor] alert {name} {state}"
                  + (f" (value {val})" if val is not None else ""),
                  file=sys.stderr)
        if transitions:
            self.publish_metrics(child_up=self._proc is not None
                                 and self._proc.poll() is None)

    def _read_heartbeat(self):
        path = os.path.join(self.data_dir, METRICS_FILE)
        try:
            return read_metrics(path)
        except OSError:
            return None

    def _stderr_tail(self, start: int = 0, nbytes: int = 8192) -> str:
        """The current boot's log HEAD + TAIL: the head (right after
        `start`, the log offset at launch) holds the resume-time markers
        (checkpoint_corrupt fallbacks fire before the first update), the
        tail holds the death traceback.  Never reads before `start`, so
        one boot's failure markers cannot be re-classified against a
        later boot; a long-lived chatty child cannot push the head
        markers out of the classification window."""
        try:
            with open(self.child_log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(start)
                head = f.read(min(2 * nbytes, size - start))
                tail_from = max(size - nbytes, start + len(head))
                tail = b""
                if tail_from < size:
                    f.seek(tail_from)
                    tail = f.read()
                return (head + b"\n...\n" + tail if tail
                        else head).decode("utf-8", "replace")
        except OSError:
            return ""

    def _kill_child(self, proc):
        try:
            proc.kill()
        except OSError:
            pass
        return proc.wait()

    # ---- one boot, decomposed for the poll() machine ----

    def _launch(self):
        boot = self.boots
        self.boots += 1
        fault = self.fault_plan[boot] if boot < len(self.fault_plan) else None
        env = dict(self._base_env)
        if fault:
            env["TPU_FAULT"] = fault
        # the child must import avida_tpu_torch the same way we did
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        argv = [sys.executable, "-m", "avida_tpu_torch"] + self.child_argv
        self.record("launch", fault=fault or "")

        os.makedirs(self.data_dir, exist_ok=True)
        # a restarted child inherits the PREVIOUS boot's metrics.prom --
        # its heartbeat is stale by construction until the child's first
        # own export, so liveness only switches from the boot-grace
        # clock to the heartbeat clock once the timestamp ADVANCES
        hb0 = (self._read_heartbeat() or {}).get(_HEARTBEAT)
        logf = open(self.child_log_path, "a")
        try:
            logf.write(f"--- supervisor boot {boot} ---\n")
            logf.flush()
            log_start = logf.tell()
            proc = self._spawn(argv, env, logf)
        except BaseException:
            logf.close()
            raise
        self._proc = proc
        self._ctx = _Boot(proc, logf, log_start, self._clock(), hb0)
        self.state = "running"

    def _watch(self):
        """One non-blocking watch step: poll the child, enforce the
        liveness/anomaly policies.  Returns the exit code once the boot
        is over (child exited or was killed), None while it runs."""
        ctx = self._ctx
        proc = ctx.proc
        rc = proc.poll()
        if rc is not None:
            return rc
        now = self._clock()
        if ctx.term_deadline is not None:
            # graceful anomaly stop in flight: the child got SIGTERM and
            # is writing its final checkpoint -- only the kill deadline
            # still applies
            if now > ctx.term_deadline:
                return self._kill_child(proc)
            return None
        metrics = self._read_heartbeat()
        hb = None if metrics is None else metrics.get(_HEARTBEAT)
        if hb is None or (ctx.hb0 is not None and hb <= ctx.hb0):
            if now - ctx.t0 > self.cfg.grace_sec:
                self.record("watchdog_kill", reason="no heartbeat",
                            grace_sec=self.cfg.grace_sec)
                ctx.watchdog_killed = True
                return self._kill_child(proc)
            return None
        if ctx.hb_max is not None and hb < ctx.hb_max:
            # the heartbeat timestamp moved BACKWARDS (a stepped host
            # clock): that is never evidence of freshness -- measure
            # staleness from OUR clock at the last true advance
            if now - ctx.hb_fresh_t > self.cfg.watchdog_sec:
                self.record("watchdog_kill",
                            reason="heartbeat moved backwards",
                            last_advance_sec=round(now - ctx.hb_fresh_t, 3),
                            watchdog_sec=self.cfg.watchdog_sec)
                ctx.watchdog_killed = True
                return self._kill_child(proc)
            return None
        if ctx.hb_max is None or hb > ctx.hb_max:
            ctx.hb_max = hb
            ctx.hb_fresh_t = now
        age = now - hb
        if age > self.cfg.watchdog_sec:
            self.record("watchdog_kill", reason="stale heartbeat",
                        age_sec=round(age, 3),
                        watchdog_sec=self.cfg.watchdog_sec)
            ctx.watchdog_killed = True
            return self._kill_child(proc)
        if self.cfg.progress_sec > 0:
            # livelock watchdog: fresh heartbeats whose update counter
            # never advances are a wedged scheduler, not a live run
            upd = metrics.get("avida_update")
            if ctx.prog_val is None or (upd is not None
                                        and upd > ctx.prog_val):
                ctx.prog_val = upd
                ctx.prog_t = now
            elif now - ctx.prog_t > self.cfg.progress_sec:
                self.record("watchdog_kill", reason="no progress",
                            update=ctx.prog_val,
                            progress_sec=self.cfg.progress_sec)
                ctx.watchdog_killed = True
                return self._kill_child(proc)
        if self.cfg.anomaly_watch:
            anom = _anomaly_total(metrics)
            if ctx.anom0 is None:
                ctx.anom0 = anom
            elif anom > ctx.anom0:
                # flight-recorder anomaly onset: stop the run
                # GRACEFULLY (SIGTERM -> final checkpoint) and
                # roll back -- by the time a NaN shows up in
                # the trace it is already in the state
                self.record("anomaly_detected", anomalies=anom - ctx.anom0)
                try:
                    proc.terminate()
                except OSError:
                    pass
                ctx.anomaly_killed = True
                ctx.term_deadline = now + max(self.cfg.watchdog_sec, 30)
                return proc.poll()
        if ctx.healthy_since is None:
            ctx.healthy_since = now
        elif self.policy.note_healthy(now - ctx.healthy_since):
            self.record("budget_reset",
                        healthy_sec=round(now - ctx.healthy_since, 1))
            ctx.healthy_since = now
        return None

    def _finish(self, rc) -> Outcome:
        ctx, self._ctx = self._ctx, None
        try:
            ctx.logf.close()
        except OSError:
            pass
        self._proc = None
        self.last_exit_code = rc

        tail = self._stderr_tail(start=ctx.log_start)
        metrics = self._read_heartbeat() or {}
        preempted = bool(metrics.get("avida_preempted", 0)) \
            or "] preempted at update" in tail
        cls = classify(rc, watchdog_killed=ctx.watchdog_killed,
                       anomaly_killed=ctx.anomaly_killed,
                       preempted=preempted)
        if ctx.watchdog_killed:
            self.watchdog_kills += 1
        # CRC/manifest fallbacks the child logged at resume time: count
        # each corrupt GENERATION once, not once per boot -- the corrupt
        # generation stays on disk after fallback, so every later resume
        # re-logs the same path and would otherwise inflate the counter
        corrupt_paths = set(
            re.findall(r"checkpoint_corrupt: path=(\S+)", tail))
        new_corrupt = corrupt_paths - self._corrupt_counted
        self._corrupt_counted |= new_corrupt
        verified = None
        if cls == "sdc":
            # the divergence error names the newest scrub-verified
            # update -- everything saved past it is suspect
            m = re.search(r"last_verified_update=(\d+)", tail)
            verified = int(m.group(1)) if m else None
        out = Outcome(cls, rc,
                      # an sdc whose divergence error names the kernel
                      # is kernel-implicated like a kernel crash
                      pallas=(cls in ("crash", "sdc")
                              and kernel_suspect(tail)),
                      corrupt_seen=bool(new_corrupt),
                      update=metrics.get("avida_update"),
                      verified_update=verified)
        if new_corrupt:
            # the child survived via CRC fallback -- record the class
            # even though this boot may otherwise have succeeded
            self.ckpt_fallbacks += len(new_corrupt)
            self.failures["corrupt_ckpt"] += len(new_corrupt)
            self.record("checkpoint_fallback_observed",
                        paths=sorted(new_corrupt))
        if cls in self.failures and not (cls == "corrupt_ckpt"
                                         and out.corrupt_seen):
            self.failures[cls] += 1
        if out.pallas:
            self.kernel_crashes += 1
        exit_fields = {"class": cls, "code": rc, "update": out.update,
                       "pallas_suspect": out.pallas}
        if cls in FAILURE_CLASSES and cls != "preempt":
            # postmortem context rides the taxonomy record: the tail end
            # of this boot's log (bounded, so a heal loop cannot bloat
            # the runlog), where the death traceback lands
            exit_fields["stderr_tail"] = tail.encode(
                "utf-8", "replace")[-STDERR_TAIL_RECORD_BYTES:].decode(
                "utf-8", "replace")
        self.record("exit", **exit_fields)
        self.last_outcome = out
        return out

    def _dispatch(self, out: Outcome):
        """Recovery policy: decide the next state from one boot's
        outcome.  Exactly the decision ladder the blocking loop ran --
        the relaunch-now path (preempt) launches inline so run()
        behavior is unchanged.  A kernel-implicated crash takes the
        ladder of any other crash: the port never relaunches off its
        kernel."""
        if out.cls == "success":
            self.record("done", update=out.update)
            self.succeeded = True
            self._terminal("done", 0)
            return
        if self._stop:
            # our own SIGTERM, forwarded: the child saved its
            # preemption checkpoint; leave cleanly so the next
            # supervisor invocation resumes bit-exactly
            self.record("supervisor_preempted", update=out.update)
            self._terminal("done", 0)
            return
        if out.cls == "preempt":
            self.restarts += 1
            self.record("restart", reason="preempt")
            self._launch()
            return
        if out.cls == "audit_violation":
            self._rollback()
        if out.cls == "sdc":
            self._sdc_rollback(out.verified_update)
        if not self.policy.can_retry():
            self.record("giving_up", failures=dict(self.failures),
                        max_retries=self.cfg.max_retries)
            self._terminal("failed", 1)
            return
        delay = self.policy.next_delay()
        self.restarts += 1
        self.record("backoff", delay_sec=round(delay, 3),
                    budget_left=self.policy.budget_left())
        self._backoff_until = self._clock() + delay
        self.state = "backoff"

    def _terminal(self, state: str, rc: int):
        self.state = state
        self.exit_rc = rc
        # final alert sweep, throttle bypassed: the child's last
        # durable export is on disk BEFORE its exit is observable, so
        # evaluating here deterministically resolves a stall/staleness
        # alert the recovery cleared -- without it, a child that exits
        # within one alert_eval_sec of resolving leaves the journal
        # (and avida_alerts_firing) claiming a live alert forever.
        # Only once a boot actually ran: a supervisor preempted before
        # its first launch has no child evidence to sweep
        if self.alerts is not None and self.boots > 0:
            self._alerts_next = 0.0
            self._eval_alerts()

    # ---- the non-blocking interface (one supervisor among many) ----

    def poll(self) -> str:
        """Advance the supervision state machine one non-blocking step
        and return the current state ("idle"/"running"/"backoff" are
        live, "done"/"failed" terminal with the exit code in
        `exit_rc`).  Never sleeps: callers own the pacing -- run()
        sleeps poll_sec between steps, a fleet orchestrator round-robins
        many supervisors through one loop."""
        if self.state in ("done", "failed"):
            return self.state
        self._eval_alerts()
        if self.state == "idle":
            if self._stop:
                # preempted before the first boot: exit NOW -- launching
                # a boot would outlive the cluster's grace window
                self.record("supervisor_preempted")
                self._terminal("done", 0)
            else:
                self._launch()
            return self.state
        if self.state == "backoff":
            if self._stop:
                # preempted while no child was alive (mid-backoff)
                self.record("supervisor_preempted")
                self._terminal("done", 0)
            elif self._clock() >= self._backoff_until:
                self._launch()
            return self.state
        rc = self._watch()
        if rc is None:
            return self.state
        self._dispatch(self._finish(rc))
        return self.state

    def request_stop(self):
        """Graceful drain (a fleet's SIGTERM forwarding): exactly what
        the supervisor's own signal handler does -- flag the stop and
        SIGTERM the live child so it writes a preemption checkpoint."""
        self._stop = True
        proc = self._proc
        if proc is not None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass

    # ---- recovery policies ----

    def _rollback(self):
        """Audit violation: quarantine the newest generation so --resume
        restores the previous good one.  The rename prefix `.bad-` is
        invisible to list_generations/restore_candidates; `ckpt_tool
        --prune` sweeps quarantined generations later.  With fewer than
        two generations there is nothing to fall back to -- leave the
        only (audited-at-save, so good) checkpoint in place."""
        gens = list_generations(self.ckpt_dir)
        if len(gens) < 2:
            self.record("rollback_skipped",
                        reason=f"{len(gens)} generation(s) on disk")
            return
        newest = gens[-1]
        dst = os.path.join(
            os.path.dirname(newest),
            f".bad-{os.path.basename(newest)}.{int(self._clock())}")
        try:
            os.rename(newest, dst)
        except OSError as e:
            self.record("rollback_failed", error=str(e))
            return
        self.rollbacks += 1
        self.record("rollback", quarantined=newest,
                    resumed_from=os.path.basename(gens[-2]))

    def _ckpt_dirs(self) -> list:
        """The checkpoint dirs this child writes: the configured dir
        itself when it holds generations, else any immediate per-world
        subdirs that do (a --worlds batched child keeps one dir per
        member under the root TPU_CKPT_DIR)."""
        if list_generations(self.ckpt_dir):
            return [self.ckpt_dir]
        try:
            subs = sorted(os.path.join(self.ckpt_dir, d)
                          for d in os.listdir(self.ckpt_dir)
                          if os.path.isdir(os.path.join(self.ckpt_dir, d)))
        except OSError:
            return [self.ckpt_dir]
        return [d for d in subs if list_generations(d)] or [self.ckpt_dir]

    def _sdc_rollback(self, verified_update):
        """Silent-data-corruption recovery (child exit EXIT_SDC): the
        scrub caught a divergence, so state saved since the last
        verified update may embed the corruption -- WITH a
        self-consistent manifest digest (the digest was computed from
        the already-corrupt state), which is why recency alone cannot
        be trusted.  Two passes per checkpoint dir:

          1. quarantine every generation saved PAST the child's
             reported verified horizon (suspect by timing);
          2. digest-verify what remains newest-first (recompute from
             the .npy leaves vs the manifest's state_digest --
             utils/integrity.py, numpy only, no torch) and quarantine
             mismatches until a verified generation is newest.

        With no horizon marker in the child's tail, fall back to the
        audit-violation policy: quarantine the newest generation."""
        if verified_update is None:
            self._rollback()
            return
        quarantined = []
        for base in self._ckpt_dirs():
            quarantined += quarantine_after(base, verified_update)
            for gen in reversed(list_generations(base)):
                if len(list_generations(base)) < 2:
                    break       # never strand the run without a resume
                try:
                    stored, recomputed = integrity.generation_digest(gen)
                except (OSError, ValueError, KeyError):
                    continue    # torn/verifying is the CRC path's job
                if stored is None or stored == recomputed:
                    break       # newest surviving generation verifies
                dst = os.path.join(
                    base, f".bad-{os.path.basename(gen)}."
                          f"{int(self._clock())}")
                try:
                    os.rename(gen, dst)
                    quarantined.append(gen)
                    self.record("sdc_digest_quarantine", path=gen,
                                stored=f"{stored:#010x}",
                                recomputed=f"{recomputed:#010x}")
                except OSError:
                    break
        if quarantined:
            self.rollbacks += 1
            self.record("sdc_rollback",
                        verified_update=verified_update,
                        quarantined=[os.path.basename(p)
                                     for p in quarantined],
                        resumable={base: [os.path.basename(g) for g in
                                          list_generations(base)[-1:]]
                                   for base in self._ckpt_dirs()})
        else:
            self.record("sdc_rollback_noop",
                        verified_update=verified_update,
                        detail="no generation postdates the verified "
                               "horizon; resume replays from the "
                               "newest retained generation")

    # ---- the supervision loop ----

    def _install_signal_forwarding(self):
        saved = {}

        def forward(signum, frame):
            self.request_stop()

        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                saved[s] = signal.signal(s, forward)
            except ValueError:
                pass
        return saved

    def run(self) -> int:
        """Supervise to completion (the blocking `--supervise` entry, a
        thin sleep-between-polls wrapper over the poll() machine).
        Returns 0 on run success (or when the supervisor itself was
        preempted after a clean child checkpoint), 1 when the retry
        budget is exhausted."""
        saved = self._install_signal_forwarding()
        self.publish_metrics()
        try:
            while True:
                state = self.poll()
                if state in ("done", "failed"):
                    return self.exit_rc
                if state == "running":
                    self._sleep(self.cfg.poll_sec)
                elif state == "backoff":
                    # chunked so a SIGTERM mid-backoff is honored within
                    # a second, not after the full (up to backoff_cap)
                    # sleep
                    remaining = self._backoff_until - self._clock()
                    if remaining > 0 and not self._stop:
                        self._sleep(min(remaining, 0.5))
        finally:
            for s, h in saved.items():
                try:
                    signal.signal(s, h)
                except (ValueError, OSError):
                    pass
            self.publish_metrics()


def supervise_main(argv: list) -> int:
    """CLI entry (dispatched from avida_tpu_torch/__main__.py before any
    torch import): strip the supervisor's own flags, everything else is
    the child command line."""
    argv = list(argv)
    argv.remove("--supervise")
    fault_plan = ()
    if "--fault-plan" in argv:
        i = argv.index("--fault-plan")
        if i + 1 >= len(argv):
            print("--fault-plan needs an argument "
                  "(per-boot TPU_FAULT specs separated by '/')",
                  file=sys.stderr)
            return 2
        fault_plan = tuple(argv[i + 1].split("/"))
        del argv[i:i + 2]
    try:
        sup = Supervisor(argv, fault_plan=fault_plan)
    except ValueError as e:
        print(f"[supervisor] {e}", file=sys.stderr)
        return 2
    return sup.run()
