"""Fleet orchestrator: `python -m avida_tpu_torch --fleet SPOOL_DIR`.

Counterpart of avida_tpu/service/fleet.py, with the same spool, journal,
metrics and policies, except for the departures listed at the end.  The
supervisor (service/supervisor.py) heals ONE run; many-seed sweeps and
many tenants' runs on one card need a fleet.  This module is the
robustness layer for the fleet: a host-only orchestrator (it never
imports torch, the same rule as the supervisor) that drains a spool
directory of JSON job specs and multiplexes up to `max_jobs` concurrent
supervised runs through one poll loop -- each job a poll()-mode
Supervisor in its own fault domain, so one tenant's crash loop cannot
take out another's run or the orchestrator itself.  Each child is
`python -m avida_tpu_torch`: a solo run launches the cycle kernel (K1)
once an update, a coalesced `--worlds` batch its stacked launch (K3b).

Spool layout (everything lives under SPOOL_DIR)::

    <name>.json         queued job spec (tools/fleet_tool.py submit, or
                        any atomic writer)
    shard-<k>/<name>.json  the same, spread over shards (submit --shard)
    <name>/             the job's fault domain, created at admission:
      job.json            the admitted spec (moved from the spool root)
      data/               child data dir (metrics.prom heartbeat,
                          supervised.log, supervisor.jsonl, .dat files)
      ck/                 checkpoint generations (utils/checkpoint.py)
      worlds.json         a coalesced batch's manifest (leader only)
    .bad-<name>.json.*  quarantined malformed specs (never retried)
    <name>.cancelled.json  specs parked by `fleet_tool cancel`
    <name>.cancel / <name>.requeue   operator marker files, consumed by
                        the orchestrator on its next poll
    fleet.jsonl[.1]     the crash-safe journal (records.append_record,
                        size-capped rotation)
    fleet.prom          aggregate Prometheus metrics
    fleet.lock          single-orchestrator guard (pid)

Job spec schema (README "Fleet runs")::

    {"argv": ["-u", "20000", "-s", "7", "-set", "TPU_CKPT_EVERY", "500"],
     "fault_plan": ["sigkill@update=5"],      # optional, chaos testing
     "env": {"TPU_WATCHDOG_SEC": "60"},       # optional, per-job knobs
     "batch": true,                           # optional, coalescing
     "tenant": "org1"}                        # optional, quota label

The fleet appends `-d <job>/data -set TPU_CKPT_DIR <job>/ck` AFTER the
spec's argv (last value wins), so a spec cannot escape its fault
domain; the Supervisor then appends `--resume` and forces the metrics
heartbeat as it always does -- one fixed spec both starts and restarts
a job bit-exactly.

Robustness properties (tests/test_torch_fleet.py holds each against the
reference's run of the same scenario):

  * crash-safe journal + replay: every state transition is an fsync'd
    `{"record": "fleet"}` line.  A killed orchestrator replays the
    journal on restart and resumes every admitted job from its newest
    checkpoint WITHOUT double-spawning: admission is transactional
    (journal the admit first, then atomically move the spec into the
    job dir -- replay completes a half-done move), and children run in
    their own sessions with journaled pids so an orphan left by a
    SIGKILLed orchestrator is reaped (after a /proc identity check)
    before its job is respawned.
  * admission control: jobs past `max_jobs` queue in the spool rather
    than spawn; per-tenant quotas (TPU_FLEET_TENANT_MAX) and queue
    backpressure (TPU_FLEET_QUEUE_MAX) hold the overflow; malformed
    specs are quarantined to `.bad-*` once, not retried forever.
  * the static coalescer: queued `"batch": true` specs of one
    batchability class (service/serve.static_signature) and one resume
    progress run as ONE supervised `--worlds` child on one admission
    slot (TPU_FLEET_MAX_BATCH worlds at most), each world keeping its
    own data and solo-format checkpoints.
  * crash-storm circuit breaker: `TPU_FLEET_BREAKER_K` same-class
    failures across jobs within `TPU_FLEET_BREAKER_SEC` seconds opens
    the breaker -- admissions pause and fleet.prom shows it.  The
    breaker closes after a full quiet window.
  * graceful drain: SIGTERM forwards to every child (preemption
    checkpoints), completed jobs finish as `done`, incomplete ones are
    journaled `requeued` so the next orchestrator resumes them.

Departures from the reference, each deliberate:

  * no fleet-wide degradation.  The reference answers a crash storm
    that implicates its kernel by relaunching every job with `-set
    TPU_USE_PALLAS 2` (its XLA path) and journaling `xla_fallback`.
    The port's supervisor never routes a run around its kernel, and
    its fleet keeps that policy: such a storm opens the breaker,
    journals `breaker_open` and pauses admissions like any other.  No
    `xla_fallback` record is written, a reference journal's is read
    and ignored, and `avida_fleet_xla_fallback` stays in fleet.prom at
    0 so the metric families match the reference's.
  * the streaming serve pool (`--dynamic` / TPU_FLEET_DYNAMIC=1,
    service/serve.ServePool) is the reference's, with the breaker rule
    above: a storm of `sdc` demotions its class children report opens
    the breaker and pauses admissions, and degrades nothing.
  * the journal is written through the torch-free
    observability/records.py.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time

from avida_tpu_torch.observability import alerts as alerts_mod
from avida_tpu_torch.observability import history
from avida_tpu_torch.observability.exporter import (
    analytics_census_digest, read_metrics, render_families, write_metrics)
from avida_tpu_torch.observability.records import (append_record,
                                                   read_records)
from avida_tpu_torch.service import FAILURE_CLASSES
from avida_tpu_torch.service.supervisor import Supervisor, SupervisorConfig

JOURNAL_FILE = "fleet.jsonl"
FLEET_METRICS_FILE = "fleet.prom"
LOCK_FILE = "fleet.lock"
JOB_SPEC_FILE = "job.json"

JOB_STATES = ("queued", "running", "batched", "done", "failed",
              "quarantined", "cancelled")

# job names become directory names and metric labels; the whole
# "fleet"/"fleet.*" namespace is the orchestrator's own (fleet.jsonl,
# fleet.prom, fleet.lock) -- a job named after any of those would
# wedge the spool
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


def legal_name(name: str) -> bool:
    # also reserved: the operator-marker / parked-spec suffixes -- a job
    # named "foo.cancelled" would write a spec the scanner must skip
    # (and requeue would later resurrect it under the wrong name)
    return bool(_NAME_RE.match(name)) and name != "fleet" \
        and not name.startswith("fleet.") \
        and not name.endswith((".cancel", ".cancelled", ".requeue"))


class FleetLockedError(RuntimeError):
    """Another live orchestrator already owns this spool."""


def validate_spec(spec) -> None:
    """Schema check for one job spec; raises ValueError on anything a
    Supervisor could not safely run.  Malformed specs are quarantined
    at scan time, BEFORE they consume an admission slot."""
    if not isinstance(spec, dict):
        raise ValueError("job spec must be a JSON object")
    argv = spec.get("argv")
    if (not isinstance(argv, list) or not argv
            or not all(isinstance(a, str) for a in argv)):
        raise ValueError("job spec needs a non-empty 'argv' list of "
                         "strings (the child run's command line)")
    plan = spec.get("fault_plan", [])
    if (not isinstance(plan, list)
            or not all(isinstance(s, str) for s in plan)):
        raise ValueError("'fault_plan' must be a list of TPU_FAULT "
                         "spec strings")
    env = spec.get("env", {})
    if (not isinstance(env, dict)
            or not all(isinstance(k, str) and isinstance(v, str)
                       for k, v in env.items())):
        raise ValueError("'env' must be a string-to-string object")
    if not isinstance(spec.get("batch", False), bool):
        raise ValueError("'batch' must be a boolean (device-lane "
                         "packing opt-in)")
    if not isinstance(spec.get("tenant", ""), str):
        raise ValueError("'tenant' must be a string (per-tenant "
                         "admission quota label)")


def spec_seed_and_batch_key(spec) -> tuple:
    """(seed, static-key) for device-lane packing: the seed is lifted
    out of the spec argv (`-s`/`--seed`/`-set RANDOM_SEED`, with the
    solo CLI's precedence), and the key is the CANONICAL static-config
    signature (service/serve.static_signature): the spec's argv is
    resolved the way the child CLI would resolve it -- config files
    loaded, overrides applied -- and hashed with seeds and output/
    checkpoint dirs stripped.  Two specs that differ only in spelling
    (output dirs, `-s` position vs `-set RANDOM_SEED`, override order)
    therefore share one batchability class and one `--worlds` child.
    seed is None when the spec never names one explicitly
    (unbatchable: the worlds manifest needs a concrete per-world
    seed)."""
    from avida_tpu_torch.service.serve import SpecArgv, static_signature
    seed = SpecArgv(spec.get("argv")).effective_seed
    return seed, static_signature(spec, with_updates=True)


class FleetConfig:
    """Knobs, all overridable via the environment (README "Fleet
    runs")."""

    def __init__(self, max_jobs: int = 2, poll_sec: float = 0.5,
                 breaker_k: int = 3, breaker_sec: float = 300.0,
                 drain_sec: float = 600.0, serve: bool = False,
                 journal_max_bytes: int = 64 << 20,
                 max_batch: int = 16, dynamic: bool = False,
                 tenant_max: int = 0, queue_max: int = 0,
                 serve_min_width: int = 2):
        self.max_jobs = max(int(max_jobs), 1)
        self.poll_sec = float(poll_sec)
        self.breaker_k = int(breaker_k)
        self.breaker_sec = float(breaker_sec)
        self.drain_sec = float(drain_sec)
        self.serve = bool(serve)
        self.journal_max_bytes = int(journal_max_bytes)
        # device-lane packing width cap (TPU_FLEET_MAX_BATCH): one
        # batched child stacks W full PopulationStates on the device,
        # so an unbounded W would let a 100-spec sweep bypass the
        # resource bounding max_jobs exists for -- wider groups split
        # into multiple batches
        self.max_batch = max(int(max_batch), 2)
        # the streaming serve layer (service/serve.py): batchable specs
        # route into warm ghost-padded --serve-worlds children instead
        # of the static coalescer
        self.dynamic = bool(dynamic)
        # per-tenant admission quota (0 = unlimited): max concurrent
        # running/batched jobs per spec "tenant" label
        self.tenant_max = max(int(tenant_max), 0)
        # queue-depth backpressure (0 = unlimited): once this many jobs
        # sit queued, the spool scanner stops ingesting new specs --
        # they wait on disk, unscanned, until the queue drains
        self.queue_max = max(int(queue_max), 0)
        # smallest serve-class width: even a lone arrival gets one
        # ghost slot of instant-admission capacity
        self.serve_min_width = max(int(serve_min_width), 1)

    @classmethod
    def from_env(cls, env) -> "FleetConfig":
        def f(name, default):
            return float(env.get(name, default))
        return cls(
            max_jobs=int(f("TPU_FLEET_MAX_JOBS", 2)),
            poll_sec=f("TPU_FLEET_POLL_SEC", 0.5),
            breaker_k=int(f("TPU_FLEET_BREAKER_K", 3)),
            breaker_sec=f("TPU_FLEET_BREAKER_SEC", 300.0),
            drain_sec=f("TPU_FLEET_DRAIN_SEC", 600.0),
            journal_max_bytes=int(f("TPU_RUNLOG_MAX_BYTES", 64 << 20)),
            max_batch=int(f("TPU_FLEET_MAX_BATCH", 16)),
            dynamic=bool(int(f("TPU_FLEET_DYNAMIC", 0))),
            tenant_max=int(f("TPU_FLEET_TENANT_MAX", 0)),
            queue_max=int(f("TPU_FLEET_QUEUE_MAX", 0)),
            serve_min_width=int(f("TPU_SERVE_MIN_WIDTH", 2)),
        )


class CircuitBreaker:
    """Crash-storm detector: K failures of ONE class (across jobs)
    within a sliding window opens the breaker; it closes again after a
    full quiet window with no same-class failure.  Pure host state
    driven by an injected clock value -- fake-clock unit-testable."""

    def __init__(self, k: int, window_sec: float):
        self.k = max(int(k), 1)
        self.window_sec = float(window_sec)
        self._times: dict = {}          # class -> recent failure times
        self.open_class = None
        self.opened_at = None
        self.last_failure_t = None
        self.trips = 0

    def note_failure(self, cls: str, now: float) -> bool:
        """Record one classified failure at `now`; True exactly when
        this failure trips the breaker open (rising edge)."""
        times = [t for t in self._times.get(cls, ())
                 if now - t < self.window_sec]
        times.append(now)
        self._times[cls] = times
        if self.open_class is not None:
            if cls == self.open_class:
                self.last_failure_t = now    # the storm continues
            return False
        if len(times) >= self.k:
            self.open_class = cls
            self.opened_at = now
            self.last_failure_t = now
            self.trips += 1
            return True
        return False

    def is_open(self, now: float) -> bool:
        return (self.open_class is not None
                and now - self.last_failure_t < self.window_sec)

    def maybe_close(self, now: float):
        """Close after a quiet window; returns the failure class just
        closed (None when nothing changed)."""
        if self.open_class is not None \
                and now - self.last_failure_t >= self.window_sec:
            cls, self.open_class = self.open_class, None
            self._times.pop(cls, None)
            return cls
        return None


class Job:
    """One tenant run: its fault domain paths + orchestration state."""

    def __init__(self, name: str, spool: str):
        self.name = name
        self.spool = spool
        self.dir = os.path.join(spool, name)
        self.state = "queued"
        self.spec = None
        self.sup: Supervisor | None = None
        self.pid = None                 # newest child pid (journaled)
        self.cancel_requested = False
        self._fail_snapshot: dict = {}
        # degrade-hint rules currently firing in this job's embedded
        # supervisor that have already dropped their breadcrumb
        # (fleet._note_alert_hints; re-armed on resolve)
        self._alert_hints: set = set()
        # device-lane packing (spec "batch": true): a LEADER job runs
        # one MultiWorld child serving every member; members park in
        # state "batched" with no supervisor of their own
        self.batch_members: list = []   # member names (leader only)
        self.batch_leader = None        # leader name (members only)
        self._batch_fallback_logged = False
        self._batch_progress = None     # cached resume-progress key
        #                                 (None = rescan; reset whenever
        #                                 the job re-enters the queue)
        self._batch_key = None          # cached (seed, static key)
        self._serve_sig = None          # cached serve-class signature
        self.spool_src = None           # where the queued spec file
        #                                 lives (spool root, or a
        #                                 shard-* subdir)

    @property
    def data_dir(self):
        return os.path.join(self.dir, "data")

    @property
    def ckpt_dir(self):
        return os.path.join(self.dir, "ck")

    @property
    def spec_path(self):
        return os.path.join(self.dir, JOB_SPEC_FILE)

    @property
    def spool_spec_path(self):
        return os.path.join(self.spool, self.name + ".json")


def journal_states(journal_path: str) -> tuple:
    """Replay the fleet journal into (job_state, job_pid, xla_fallback).
    Shared by the orchestrator's restart replay, `fleet_tool list` and
    the --status fleet view; reads the rotation pair.  The third item
    says whether the journal holds the reference's fleet-wide
    degradation (an `xla_fallback` record, or a snapshot flagging it):
    reported so both packages read one spool alike, and never acted
    on -- the port's orchestrator journals no such record and replays
    none (_replay)."""
    state: dict = {}
    pids: dict = {}
    xla = False
    for rec in read_records(journal_path):
        if rec.get("record") != "fleet":
            continue
        ev = rec.get("event")
        name = rec.get("job")
        if ev == "snapshot":
            # compaction record written at rotation: authoritative full
            # state at that instant -- replay survives every older
            # record being gone (the .1 aside is clobbered per rotation)
            state = {n: v.get("state") for n, v in rec["jobs"].items()}
            pids = {n: v.get("pid") for n, v in rec["jobs"].items()
                    if v.get("pid")}
            xla = bool(rec.get("xla_fallback"))
        elif ev == "admit":
            state[name] = "running"
        elif ev == "spawn":
            pids[name] = rec.get("pid")
        elif ev == "coalesced":
            # device-lane packing: the member rides a leader's
            # MultiWorld child; its own checkpoints stay solo-format,
            # so replay can requeue it standalone
            state[name] = "batched"
        elif ev == "cancel_requested":
            # a cancel whose graceful stop was still in flight: must not
            # be resurrected as "running" if the orchestrator dies here
            state[name] = "cancelling"
        elif ev in ("done", "failed", "cancelled", "quarantined",
                    "requeued"):
            state[name] = ev
        elif ev == "xla_fallback":
            xla = True
    return state, pids, xla


def journal_batch_leaders(journal_path: str) -> dict:
    """{member: leader} for every LIVE coalescing in the journal --
    terminal member events (done/failed/cancelled/requeued) dissolve
    the pairing.  Status/list views group member sub-rows under their
    leader with this."""
    leaders: dict = {}
    for rec in read_records(journal_path):
        if rec.get("record") != "fleet":
            continue
        ev = rec.get("event")
        name = rec.get("job")
        if ev == "snapshot":
            leaders = {n: v["leader"] for n, v in rec["jobs"].items()
                       if v.get("leader")}
        elif ev == "coalesced" and rec.get("leader"):
            leaders[name] = rec["leader"]
        elif ev in ("done", "failed", "cancelled", "quarantined",
                    "requeued"):
            leaders.pop(name, None)
    return leaders


def spool_job_states(spool: str) -> dict:
    """{job: state} for one spool: the journal replay merged with a
    scan for not-yet-admitted specs (queued) and parked ones
    (cancelled).  The single source for every read-only job table --
    the --status fleet view and `fleet_tool list` both render
    this."""
    state, _, _ = journal_states(os.path.join(spool, JOURNAL_FILE))
    if os.path.isdir(spool):
        for fn in sorted(os.listdir(spool)):
            if fn.startswith("."):
                continue
            if fn.endswith(".cancelled.json"):
                state.setdefault(fn[:-len(".cancelled.json")],
                                 "cancelled")
            elif fn.endswith(".json"):
                state.setdefault(fn[:-len(".json")], "queued")
    return state


class FleetOrchestrator:
    def __init__(self, spool: str, cfg: FleetConfig | None = None,
                 env=None, clock=time.time, sleep=time.sleep,
                 spawn_factory=None):
        # canonical spool path: children's command lines embed it, and
        # the orphan reaper's /proc identity check compares against it
        # -- a restart from a differently-spelled path ("runs" vs
        # "./runs" vs a symlink) must still recognize its own orphans
        self.spool = os.path.realpath(str(spool))
        base_env = dict(os.environ if env is None else env)
        self.cfg = cfg or FleetConfig.from_env(base_env)
        self._base_env = base_env
        self._clock = clock
        self._sleep = sleep
        # tests inject stub children here: factory(job) -> spawn fn with
        # the Supervisor._spawn_default signature (argv, env, logf)
        self._spawn_factory = spawn_factory or self._make_spawn
        self.jobs: dict = {}
        self._stop = False
        self.breaker = CircuitBreaker(self.cfg.breaker_k,
                                      self.cfg.breaker_sec)
        self.admissions_paused = False
        self.failures = {c: 0 for c in FAILURE_CLASSES}
        self.journal_path = os.path.join(self.spool, JOURNAL_FILE)
        self.metrics_path = os.path.join(self.spool, FLEET_METRICS_FILE)
        os.makedirs(self.spool, exist_ok=True)
        # fleet-level alert plane (observability/alerts.py): evaluated
        # over the orchestrator's OWN history ring (fleet.hist.jsonl --
        # queue depth, breaker state) each poll; per-job rules run in
        # each job's embedded Supervisor, whose firing set the poll
        # loop reads in-process (_note_alert_hints).  Rules marked
        # degrade-hint feed a breadcrumb into the failure tally +
        # circuit breaker from EITHER layer (admission pause at worst
        # -- never a kill).
        self._hist = history.HistorySink(self.metrics_path,
                                         env=self._base_env)
        self.alert_eval_sec = float(
            self._base_env.get("TPU_ALERT_EVAL_SEC", 5.0))
        self.alerts = None
        if self.alert_eval_sec > 0:
            try:
                self.alerts = alerts_mod.AlertPlane(
                    alerts_mod.load_rules(self.spool),
                    journal_path=os.path.join(self.spool,
                                              alerts_mod.ALERTS_FILE),
                    max_bytes=self.cfg.journal_max_bytes,
                    on_transition=self._on_alert)
            except (OSError, ValueError) as e:
                print(f"[fleet] alert rules disabled: {e}",
                      file=sys.stderr)
        self._alerts_next = 0.0
        self._pending_recovery: dict = {}
        self._recovered = False
        self._shard_cursor = 0
        self._replay()
        # the streaming serve layer (--dynamic / TPU_FLEET_DYNAMIC):
        # batchable specs route into warm ghost-padded serve children
        self.serve_pool = None
        if self.cfg.dynamic:
            from avida_tpu_torch.service.serve import ServePool
            self.serve_pool = ServePool(self)

    # ---- journal ----

    def journal(self, event: str, **fields):
        rec = {"record": "fleet", "event": event, "time": self._clock(),
               **fields}
        try:
            # rotation is done here rather than via append_record's
            # max_bytes: the fresh file must START with a compaction
            # snapshot, or a second rotation would clobber the .1 aside
            # holding a live job's admit/spawn records and replay would
            # lose the job (and its orphan's pid) entirely
            try:
                size = os.path.getsize(self.journal_path)
            except OSError:
                size = 0
            if size and size + len(json.dumps(rec)) + 1 \
                    > self.cfg.journal_max_bytes:
                os.replace(self.journal_path, self.journal_path + ".1")
                append_record(self.journal_path, {
                    "record": "fleet", "event": "snapshot",
                    "time": self._clock(),
                    # the reference's snapshot field, kept so its reader
                    # sees a fleet that never degraded
                    "xla_fallback": False,
                    "jobs": {n: {"state": j.state, "pid": j.pid,
                                 "leader": j.batch_leader}
                             for n, j in self.jobs.items()}})
            append_record(self.journal_path, rec)
        except OSError:
            pass                        # logging must not kill the fleet
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[fleet] {event}" + (f": {detail}" if detail else ""),
              file=sys.stderr)

    def _replay(self):
        """Rebuild job state from the journal -- READ-ONLY: no journal
        writes, no process kills, so constructing an orchestrator (or a
        status/list view over its guts) cannot disturb a live fleet.
        The destructive half (orphan reaping, half-done spec moves,
        replay_resume records) is _recover(), which runs behind the
        fleet.lock at the first poll.  A reference journal's
        `xla_fallback` record is read and ignored: the port never
        routes a job around its kernel."""
        state, pids, _xla = journal_states(self.journal_path)
        for name, st in state.items():
            job = Job(name, self.spool)
            self.jobs[name] = job
            if st in ("done", "failed", "cancelled", "quarantined"):
                job.state = st
                continue
            if st == "cancelling":
                # the cancel's graceful stop was mid-flight when the
                # last orchestrator died: honor it (never resurrect),
                # but the child may still be alive -- reap at recovery
                job.state = "cancelled"
            else:
                # admitted (or drained-requeued): back to the queue;
                # the Supervisor always appends --resume, so the job
                # continues from its newest checkpoint
                job.state = "queued"
            self._pending_recovery[name] = (pids.get(name), st)

    def _recover(self):
        """The destructive half of replay, run once behind fleet.lock:
        reap orphans left by a killed orchestrator, complete half-done
        admission moves, journal what was resumed."""
        if self._recovered:
            return
        self._recovered = True
        for name, (pid, st) in self._pending_recovery.items():
            job = self.jobs[name]
            self._reap_orphan(name, pid)
            if st == "cancelling":
                self.journal("cancelled", job=name, reason="replayed")
                continue
            src = self._find_spool_spec(name)
            if not os.path.exists(job.spec_path) and src:
                os.makedirs(job.dir, exist_ok=True)
                os.replace(src, job.spec_path)
            if st == "running":
                self.journal("replay_resume", job=name)
        self._pending_recovery = {}

    def _reap_orphan(self, name: str, pid):
        """A SIGKILLed orchestrator leaves children running detached; a
        resumed job must never have TWO children writing one checkpoint
        dir.  Children are spawned in their own session (pgid == pid),
        so kill the group -- but only after /proc confirms the pid
        still belongs to this job (pid reuse must not kill an
        innocent)."""
        if not pid:
            return
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode("utf-8",
                                                           "replace")
        except OSError:
            return                      # gone (or no /proc): nothing up
        if os.path.join(self.spool, name) not in cmd:
            return                      # pid reused by someone else
        self.journal("orphan_killed", job=name, pid=pid)
        try:
            os.killpg(pid, signal.SIGKILL)
        except OSError:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        deadline = time.time() + 5.0
        while os.path.exists(f"/proc/{pid}") and time.time() < deadline:
            time.sleep(0.05)

    # ---- admission ----

    def _shard_dirs(self) -> list:
        """Spool shards (`shard-*` subdirs, fleet_tool submit --shard):
        a thousands-deep queue splits across shards so one poll tick
        never stats the whole backlog."""
        try:
            return sorted(
                d for d in os.listdir(self.spool)
                if d.startswith("shard-")
                and os.path.isdir(os.path.join(self.spool, d)))
        except OSError:
            return []

    def _find_spool_spec(self, name: str) -> str | None:
        """Where a queued spec file for `name` lives right now: the
        spool root, or one of the shard subdirs."""
        p = os.path.join(self.spool, name + ".json")
        if os.path.exists(p):
            return p
        for d in self._shard_dirs():
            p = os.path.join(self.spool, d, name + ".json")
            if os.path.exists(p):
                return p
        return None

    def _scan_spool(self):
        """Pick up newly submitted specs; quarantine malformed ones NOW
        (a spec that cannot run must not be retried forever, and must
        not wait for an admission slot to be found out).  Scales to
        thousands of queued specs two ways: shard subdirs are visited
        round-robin (one per tick, plus the root), and with
        TPU_FLEET_QUEUE_MAX set the scan stops ingesting once that many
        jobs sit queued -- later specs wait ON DISK, unscanned (the
        backpressure surface), until the queue drains."""
        dirs = [self.spool]
        shards = self._shard_dirs()
        if shards:
            dirs.append(os.path.join(
                self.spool, shards[self._shard_cursor % len(shards)]))
            self._shard_cursor += 1
        queued = sum(1 for j in self.jobs.values()
                     if j.state == "queued")
        for d in dirs:
            try:
                entries = sorted(os.listdir(d))
            except OSError:
                continue
            for fn in entries:
                if not fn.endswith(".json") or fn.startswith(".") \
                        or fn.endswith(".cancelled.json"):
                    continue
                name = fn[:-len(".json")]
                if name in self.jobs:
                    continue            # known: admitted jobs moved
                                        # their spec, so this is a
                                        # resubmit race -- never a
                                        # double spawn
                if self.cfg.queue_max and queued >= self.cfg.queue_max:
                    return              # backpressure: stop ingesting
                path = os.path.join(d, fn)
                job = Job(name, self.spool)
                job.spool_src = path
                try:
                    if not legal_name(name):
                        raise ValueError(f"illegal job name {name!r}")
                    with open(path) as f:
                        spec = json.load(f)
                    validate_spec(spec)
                except (ValueError, OSError) as e:
                    self._quarantine_spec(job, path, str(e))
                    continue
                job.spec = spec
                self.jobs[name] = job
                queued += 1

    def _quarantine_spec(self, job: Job, path: str, error: str):
        dst = os.path.join(
            self.spool,
            f".bad-{os.path.basename(path)}.{int(self._clock())}")
        try:
            os.replace(path, dst)
        except OSError:
            dst = ""
        job.state = "quarantined"
        self.jobs[job.name] = job
        self.journal("quarantined", job=job.name, error=error,
                     moved_to=os.path.basename(dst))

    def _admit(self, now: float):
        """Admission control: batch placement first (serve-pool routing
        under --dynamic, else the static coalescer -- either way a
        batch serves W tenants on one slot), then fill the remaining
        slots from the queue, unless the circuit breaker holds
        admissions.  Per-tenant quotas (TPU_FLEET_TENANT_MAX) hold a
        tenant's overflow in the queue without blocking others."""
        self.admissions_paused = self.breaker.is_open(now)
        if self.admissions_paused:
            return
        running = sum(1 for j in self.jobs.values()
                      if j.state == "running")
        tenants = self._tenant_load() if self.cfg.tenant_max else None
        if self.serve_pool is not None:
            running = self._admit_serve(running, tenants)
        else:
            for members in self._form_batches():
                if running >= self.cfg.max_jobs:
                    break
                if tenants is not None:
                    # the quota covers batched riders too: over-quota
                    # members stay queued; a batch needs >= 2 in-quota
                    # members to still be a batch this tick
                    members = [(j, s) for j, s in members
                               if not self._over_quota(j, tenants)]
                    if len(members) < 2:
                        continue
                if self._start_batch(members):
                    running += 1
                    for j, _ in members:
                        if j.state in ("running", "batched"):
                            self._tenant_note(tenants, j)
        for name in sorted(self.jobs):
            if running >= self.cfg.max_jobs:
                break
            job = self.jobs[name]
            if job.state != "queued":
                continue
            if self.serve_pool is not None and job._serve_sig is not None:
                # a serve-eligible spec the pool could not place THIS
                # tick (class full / no free slot): it waits for a
                # ghost slot or the next class spawn -- starting it
                # solo here would pay the child start the serve layer
                # exists to remove
                continue
            if self._over_quota(job, tenants):
                continue
            if self._start(job):
                running += 1
                self._tenant_note(tenants, job)

    # ---- the streaming serve layer (service/serve.py) ----

    def _admit_serve(self, running: int, tenants) -> int:
        """Serve-pool admission: warm-class placements (cache hits)
        cost NO admission slot -- the class child is already running --
        while each cold class spawn costs one.  Ineligible batch specs
        fall back to the ordinary solo queue with the reason
        journaled."""
        from avida_tpu_torch.service.serve import (
            SpecArgv, batch_ineligible_reason)
        pool = self.serve_pool
        groups: dict = {}
        for name in sorted(self.jobs):
            job = self.jobs[name]
            if job.state != "queued":
                continue
            spec = self._load_spec(job)
            if spec is None or not spec.get("batch"):
                continue
            if spec.get("fault_plan"):
                self._batch_fallback(job, "fault_plan is per-process")
                continue
            reason = batch_ineligible_reason(spec)
            if reason is not None:
                self._batch_fallback(job, reason)
                continue
            if SpecArgv(spec.get("argv")).effective_seed is None:
                self._batch_fallback(job, "no explicit seed in argv")
                continue
            if self._over_quota(job, tenants):
                continue
            if pool.offer(job, spec):
                self._tenant_note(tenants, job)
                continue
            if job.state != "queued":
                continue                # quarantined by a failed place
            groups.setdefault(job._serve_sig, []).append((job, spec))
        for sig in sorted(groups):
            if running >= self.cfg.max_jobs:
                break
            if pool.spawn_class(groups[sig]):
                running += 1
                for job, _ in groups[sig]:
                    if job.state == "batched":
                        self._tenant_note(tenants, job)
        return running

    # ---- per-tenant quotas ----

    def _spec_tenant(self, job: Job) -> str:
        spec = self._load_spec(job)
        return str((spec or {}).get("tenant") or "")

    def _tenant_load(self) -> dict:
        load: dict = {}
        for j in self.jobs.values():
            if j.state in ("running", "batched"):
                t = self._spec_tenant(j)
                if t:
                    load[t] = load.get(t, 0) + 1
        return load

    def _over_quota(self, job: Job, tenants) -> bool:
        if tenants is None:
            return False
        t = self._spec_tenant(job)
        return bool(t) and tenants.get(t, 0) >= self.cfg.tenant_max

    def _tenant_note(self, tenants, job: Job):
        if tenants is None:
            return
        t = self._spec_tenant(job)
        if t:
            tenants[t] = tenants.get(t, 0) + 1

    # ---- device-lane packing (spec "batch": true) ----

    def _load_spec(self, job: Job):
        """Best-effort spec read for a queued job (spool root or its
        already-moved job.json); None when unreadable -- the normal
        admission path surfaces the error."""
        if job.spec is not None:
            return job.spec
        src = (job.spool_src if job.spool_src
               and os.path.exists(job.spool_src)
               else self._find_spool_spec(job.name))
        for path in filter(None, (job.spec_path, src)):
            try:
                with open(path) as f:
                    spec = json.load(f)
                validate_spec(spec)
                job.spec = spec
                return spec
            except (OSError, ValueError):
                continue
        return None

    def _batch_fallback(self, job: Job, reason: str):
        """Journal (once) why a '"batch": true' spec runs as an
        ordinary process-per-job instead -- the documented clean
        fallback.  The job stays queued and batchable: a static-equal
        peer arriving before a slot frees can still pick it up."""
        if job._batch_fallback_logged:
            return
        job._batch_fallback_logged = True
        self.journal("batch_fallback", job=job.name, reason=reason)

    def _form_batches(self) -> list:
        """Group queued '"batch": true' specs by their static key
        (service/serve.static_signature: identical keys run one update
        program).  Returns a list of batches, each a [(job,
        seed)] list sorted by name (the first member leads).  Specs
        that cannot batch -- a fault plan (per-process chaos), no
        explicit seed, no static-equal peer -- fall back to
        process-per-job with the reason journaled."""
        groups: dict = {}
        for name in sorted(self.jobs):
            job = self.jobs[name]
            if job.state != "queued":
                continue
            spec = self._load_spec(job)
            if spec is None or not spec.get("batch"):
                continue
            if spec.get("fault_plan"):
                self._batch_fallback(job, "fault_plan is per-process")
                continue
            # the signature now resolves config files and hashes the
            # config dir's contents -- cache it per job like
            # _batch_progress below (a queued spec cannot change, and
            # re-hashing thousands of parked specs' config dirs every
            # poll tick would hammer the disk)
            if job._batch_key is None:
                job._batch_key = spec_seed_and_batch_key(spec)
            seed, key = job._batch_key
            if seed is None:
                self._batch_fallback(job, "no explicit seed in argv")
                continue
            # resume-progress compatibility: the child resumes a batch
            # aligned on ONE update, so a requeued member with
            # checkpoints must not coalesce with a fresh spec (the
            # mixed set would refuse to resume on every boot).  Key on
            # the newest published generation's update (-1 = fresh),
            # cached per job -- it cannot change while the job sits
            # queued, and rescanning 100 parked specs' dirs every
            # poll tick would hammer the disk for nothing
            if job._batch_progress is None:
                from avida_tpu_torch.utils.checkpoint import (
                    generation_update, list_generations)
                gens = list_generations(job.ckpt_dir)
                job._batch_progress = (generation_update(gens[-1])
                                       if gens else -1)
            groups.setdefault((key, job._batch_progress),
                              []).append((job, seed))
        batches = []
        for key in sorted(groups, key=str):
            members = groups[key]
            if len(members) < 2:
                self._batch_fallback(members[0][0],
                                     "no static-equal peer queued")
                continue
            # width cap: split wide groups so one batched child never
            # stacks more than max_batch worlds (TPU_FLEET_MAX_BATCH)
            for i in range(0, len(members), self.cfg.max_batch):
                chunk = members[i:i + self.cfg.max_batch]
                if len(chunk) >= 2:
                    batches.append(chunk)
                else:
                    self._batch_fallback(chunk[0][0],
                                         "width-cap remainder")
        return batches

    def _start_batch(self, members: list) -> bool:
        """Admit one coalesced batch: every member's spec moves into
        its own fault domain (per-world data + checkpoints survive in
        solo-compatible form), a worlds.json manifest lands in the
        leader's domain, and ONE supervised `--worlds` child serves
        them all.  Occupies one admission slot."""
        admitted = [(job, seed) for job, seed in members
                    if self._admit_spec_move(job)]
        if not admitted:
            return False
        if len(admitted) == 1:
            return self._start(admitted[0][0])
        leader, _ = admitted[0]
        manifest = [{"name": j.name, "seed": s,
                     "data_dir": j.data_dir, "ckpt_dir": j.ckpt_dir}
                    for j, s in admitted]
        mpath = os.path.join(leader.dir, "worlds.json")
        tmp = f"{mpath}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1)
                f.write("\n")
            os.replace(tmp, mpath)
        except OSError as e:
            self.journal("batch_fallback", job=leader.name,
                         reason=f"manifest write failed: {e}")
            return self._start(leader)
        # the child argv template: the leader's argv with per-member
        # routing stripped (the worlds manifest carries seeds + dirs);
        # static-equal peers may SPELL their configs differently, but
        # they resolve identically -- that is what the signature proved
        from avida_tpu_torch.service.serve import member_argv
        argv = member_argv(leader.spec) + [
            "--worlds", mpath,
            "-d", leader.data_dir, "-set", "TPU_CKPT_DIR",
            leader.ckpt_dir]
        env = self._child_env(leader.spec)
        try:
            sup = Supervisor(argv, cfg=SupervisorConfig.from_env(env),
                             env=env, spawn=self._spawn_factory(leader),
                             clock=self._clock, sleep=self._sleep)
        except ValueError as e:
            self.journal("batch_fallback", job=leader.name,
                         reason=f"supervisor refused batch argv: {e}")
            return self._start(leader)
        leader.sup = sup
        leader._fail_snapshot = dict(sup.failures)
        leader.state = "running"
        leader.batch_members = [j.name for j, _ in admitted[1:]]
        self.journal("coalesce", job=leader.name,
                     members=leader.batch_members,
                     worlds=len(admitted))
        for j, _ in admitted[1:]:
            j.state = "batched"
            j.batch_leader = leader.name
            self.journal("coalesced", job=j.name, leader=leader.name)
        sup.publish_metrics()
        return True

    def _finish_batch(self, leader: Job):
        """Propagate the leader's terminal state to its riders: done and
        failed verbatim; a drained/preempted batch requeues every member
        (their solo-format checkpoints make each independently
        resumable -- re-coalescing or running solo both continue
        bit-exactly); a member that asked for cancellation lands
        `cancelled` while its peers requeue."""
        members, leader.batch_members = leader.batch_members, []
        for mname in members:
            m = self.jobs.get(mname)
            if m is None or m.batch_leader != leader.name:
                continue
            m.batch_leader = None
            if leader.state in ("done", "failed"):
                m.state = leader.state
                self.journal(leader.state, job=m.name,
                             batch_leader=leader.name)
            elif m.cancel_requested:
                m.state = "cancelled"
                self.journal("cancelled", job=m.name)
            else:
                m.state = "queued"
                m.sup = None
                m._batch_progress = None   # checkpoints advanced
                m._batch_key = None
                self.journal("requeued", job=m.name,
                             reason="batch_"
                                    + ("cancelled"
                                       if leader.state == "cancelled"
                                       else "drain"))

    def _child_env(self, spec) -> dict:
        """The environment every child (solo, --worlds batch, serve
        class) is spawned with: base env + per-spec overrides, and the reference's
        ONE spool-level persistent program cache unless the operator or
        the spec routed it elsewhere."""
        env = dict(self._base_env)
        env.update(spec.get("env") or {})
        env.setdefault("TPU_COMPILE_CACHE_DIR",
                       os.path.join(self.spool, "compile-cache"))
        return env

    def _admit_spec_move(self, job: Job) -> bool:
        """The transactional half of admission, shared by solo and
        batched starts: journal-first ("admit"), THEN atomically move
        the spec into the job's fault domain -- if we die between the
        two steps, replay finds the admit record and completes the
        move before respawning.  False = quarantined (path blocked)."""
        if os.path.exists(job.spec_path):
            return True
        src = (job.spool_src if job.spool_src
               and os.path.exists(job.spool_src)
               else self._find_spool_spec(job.name)) \
            or job.spool_spec_path
        self.journal("admit", job=job.name)
        try:
            os.makedirs(job.dir, exist_ok=True)
            os.replace(src, job.spec_path)
        except OSError as e:
            # e.g. the job-dir path is blocked by a file: quarantine
            # rather than crash-loop the whole orchestrator
            self._quarantine_spec(job, src, f"spec move failed: {e}")
            return False
        return True

    def _start(self, job: Job) -> bool:
        """Admit one queued job: transactional spec move + Supervisor
        construction + first child launch."""
        if not self._admit_spec_move(job):
            return False
        if job.spec is None:
            try:
                with open(job.spec_path) as f:
                    job.spec = json.load(f)
                validate_spec(job.spec)
            except (ValueError, OSError) as e:
                job.state = "quarantined"
                self.journal("quarantined", job=job.name, error=str(e))
                return False
        argv = list(job.spec["argv"]) + [
            "-d", job.data_dir, "-set", "TPU_CKPT_DIR", job.ckpt_dir]
        env = self._child_env(job.spec)
        try:
            sup = Supervisor(argv,
                             fault_plan=job.spec.get("fault_plan") or (),
                             cfg=SupervisorConfig.from_env(env), env=env,
                             spawn=self._spawn_factory(job),
                             clock=self._clock, sleep=self._sleep)
        except ValueError as e:
            job.state = "quarantined"
            self.journal("quarantined", job=job.name, error=str(e))
            return False
        job.sup = sup
        job._fail_snapshot = dict(sup.failures)
        job.state = "running"
        sup.publish_metrics()
        return True

    def _make_spawn(self, job: Job):
        def spawn(argv, env, logf):
            # own session => pgid == pid: the whole child tree is
            # reapable after an orchestrator crash, and a terminal ^C
            # cannot fan out to every tenant
            proc = subprocess.Popen(argv, env=env, stdout=logf,
                                    stderr=logf, start_new_session=True)
            job.pid = proc.pid
            self.journal("spawn", job=job.name, pid=proc.pid,
                         boot=job.sup.boots - 1 if job.sup else 0)
            return proc
        return spawn

    # ---- operator markers (fleet_tool cancel/requeue) ----

    def _consume_markers(self):
        # act (journal) FIRST, remove the marker after: a crash in
        # between re-consumes an already-journaled marker on restart (a
        # no-op -- _cancel/_requeue are idempotent), whereas the other
        # order would silently lose the operator's request
        for fn in sorted(os.listdir(self.spool)):
            if fn.endswith(".cancel"):
                self._cancel(fn[:-len(".cancel")])
                os.remove(os.path.join(self.spool, fn))
            elif fn.endswith(".requeue"):
                self._requeue(fn[:-len(".requeue")], reason="operator")
                os.remove(os.path.join(self.spool, fn))

    def _cancel(self, name: str):
        job = self.jobs.get(name)
        if job is None:
            # not ingested yet -- the spec can sit on disk unscanned
            # behind TPU_FLEET_QUEUE_MAX backpressure or a later shard's
            # round-robin turn; park it NOW so a future scan cannot
            # admit a job the operator already cancelled
            src = self._find_spool_spec(name)
            if src:
                try:
                    os.replace(src, os.path.join(
                        self.spool, name + ".cancelled.json"))
                except OSError:
                    return
                self.journal("cancelled", job=name,
                             reason="cancelled before ingestion")
            return
        if job.state in ("done", "failed", "cancelled", "quarantined"):
            return
        if job.state == "queued":
            # park an unadmitted spec so a rescan cannot resurrect it
            src = (job.spool_src if job.spool_src
                   and os.path.exists(job.spool_src)
                   else self._find_spool_spec(name))
            if src:
                os.replace(src, os.path.join(self.spool,
                                             name + ".cancelled.json"))
            job.state = "cancelled"
            self.journal("cancelled", job=name)
            return
        if job.state == "batched":
            if self.serve_pool is not None \
                    and self.serve_pool.cancel(job):
                # serve member: demoted alone -- the class child
                # retires it with a final checkpoint at the next
                # boundary while its classmates keep running
                return
            # a static-batch rider has no child of its own: preempt the
            # whole batch gracefully -- this member lands `cancelled`,
            # its peers requeue from their per-world checkpoints
            # (_finish_batch)
            job.cancel_requested = True
            leader = self.jobs.get(job.batch_leader or "")
            if leader is not None and leader.sup is not None:
                leader.sup.request_stop()
            self.journal("cancel_requested", job=name,
                         batch_leader=job.batch_leader)
            return
        # running: graceful stop; _poll_job records the terminal state
        # once the child has written its preemption checkpoint
        job.cancel_requested = True
        job.sup.request_stop()
        self.journal("cancel_requested", job=name)

    def _requeue(self, name: str, reason: str):
        job = self.jobs.get(name)
        if job is None or job.state not in ("failed", "cancelled"):
            return
        parked = os.path.join(self.spool, name + ".cancelled.json")
        if not os.path.exists(job.spec_path) and os.path.exists(parked):
            os.replace(parked, job.spool_spec_path)
        job.sup = None
        job.spec = None
        job.cancel_requested = False
        job.state = "queued"
        job._batch_progress = None
        job._batch_key = None
        self.journal("requeued", job=name, reason=reason)

    # ---- the poll loop ----

    def _poll_job(self, job: Job, now: float):
        try:
            state = job.sup.poll()
        except Exception as e:
            # one job's supervisor blowing up must not sink the fleet;
            # journaled as "failed" (not a bespoke event) so replay and
            # the job tables agree it is terminal
            job.state = "failed"
            self.journal("failed", job=job.name, error=str(e))
            if job.batch_members:
                self._finish_batch(job)
            return
        self._note_failures(job, now)
        self._note_alert_hints(job)
        if state not in ("done", "failed"):
            return
        if state == "failed":
            job.state = "failed"
            self.journal("failed", job=job.name,
                         failures=dict(job.sup.failures))
        elif job.sup.succeeded:
            job.state = "done"
            self.journal("done", job=job.name)
        elif job.cancel_requested:
            job.state = "cancelled"
            self.journal("cancelled", job=job.name)
        else:
            # supervisor preempted (drain): incomplete but resumable
            job.state = "queued"
            job.sup = None
            job._batch_progress = None   # checkpoints advanced
            job._batch_key = None
            self.journal("requeued", job=job.name, reason="drain")
        if job.batch_members:
            self._finish_batch(job)

    def _note_failures(self, job: Job, now: float):
        """Diff the job supervisor's per-class failure counters into the
        fleet aggregates + the circuit breaker."""
        for cls, n in job.sup.failures.items():
            delta = n - job._fail_snapshot.get(cls, 0)
            if delta <= 0:
                continue
            job._fail_snapshot[cls] = n
            self.failures[cls] = self.failures.get(cls, 0) + delta
            for _ in range(delta):
                if self.breaker.note_failure(cls, now):
                    self._open_breaker(cls, job)

    def _note_alert_hints(self, job: Job):
        """Degrade-hint breadcrumbs from a job's EMBEDDED supervisor:
        run-level rules (integrity_mismatch and friends, pinned to the
        job's own metrics ring) evaluate inside each job's Supervisor,
        whose AlertPlane the fleet can read in-process -- no file
        round-trip.  One breadcrumb per firing EDGE per job (the set
        diff below re-arms a rule once it resolves), into the same
        failure-tally + circuit-breaker path as _on_alert."""
        plane = getattr(job.sup, "alerts", None)
        if plane is None:
            return
        firing = set(plane.firing)
        for name in sorted(firing - job._alert_hints):
            rule = plane.rules.get(name)
            if rule is None or rule.action != "degrade-hint":
                continue
            self.journal("alert", rule=name, state="firing",
                         severity=rule.severity, job=job.name)
            cls = f"alert:{name}"
            self.failures[cls] = self.failures.get(cls, 0) + 1
            if self.breaker.note_failure(cls, self._clock()):
                self._open_breaker(cls, job)
        job._alert_hints = firing

    def _on_alert(self, rule, state: str, res: dict):
        """AlertPlane edge hook: every transition journals a fleet
        event (the alerts.jsonl {"record": "alert"} line is the
        canonical record; this one correlates it into the fleet
        timeline), and a FIRING degrade-hint rule drops a breadcrumb
        into the failure tally + circuit breaker -- the detection
        plane's only actuator is an admission pause, never a kill."""
        self.journal("alert", rule=rule.name, state=state,
                     severity=rule.severity, value=res.get("value"))
        if state != "firing" or rule.action != "degrade-hint":
            return
        cls = f"alert:{rule.name}"
        self.failures[cls] = self.failures.get(cls, 0) + 1
        if self.breaker.note_failure(cls, self._clock()):
            self._open_breaker(cls, None)

    def _eval_alerts(self, now: float):
        """Evaluate the fleet rule set over fleet.hist.jsonl, at most
        every alert_eval_sec (TPU_ALERT_EVAL_SEC=0 disables)."""
        if self.alerts is None or now < self._alerts_next:
            return
        self._alerts_next = now + self.alert_eval_sec
        samples = {"fleet": history.read_samples(
            history.hist_path(self.metrics_path), tail_bytes=256 << 10)}
        self.alerts.observe(samples, now)

    def note_external_failure(self, cls: str, job: Job):
        """Count one classified failure detected OUTSIDE a job
        supervisor -- a serve child's in-process `sdc` demotion
        (parallel/multiworld.ServeBatch) reports through its status
        file, not an exit code -- into the fleet aggregates and the
        circuit breaker, so an SDC storm (a sick device corrupting one
        tenant after another) pauses admissions like any crash storm;
        it degrades nothing (see the departures above)."""
        self.failures[cls] = self.failures.get(cls, 0) + 1
        if self.breaker.note_failure(cls, self._clock()):
            self._open_breaker(cls, job)

    def _open_breaker(self, cls: str, job: Job | None):
        """Journal the storm; admissions stay paused while it lasts
        (_admit reads the breaker).  A kernel-implicated storm (the
        job's last_outcome.pallas) is handled exactly like any other:
        the reference degrades the whole fleet to its XLA path here,
        the port never routes a job around its kernel."""
        self.journal("breaker_open", failure_class=cls,
                     k=self.breaker.k,
                     window_sec=self.breaker.window_sec,
                     job=job.name if job is not None else "")

    def poll_once(self) -> bool:
        """One orchestration step: scan, consume markers, admit, poll
        every running job.  Returns True while any job is live."""
        self._recover()
        now = self._clock()
        self._scan_spool()
        self._consume_markers()
        closed = self.breaker.maybe_close(now)
        if closed is not None:
            self.journal("breaker_close", failure_class=closed)
        self._eval_alerts(now)
        if self.serve_pool is not None:
            # settle member outcomes BEFORE admission: a member the
            # child finished must journal `done` before the admit pass
            # could mistake its freed slot for capacity twice
            self.serve_pool.poll()
        self._admit(now)
        for job in [j for j in self.jobs.values()
                    if j.state == "running" and j.sup is not None]:
            self._poll_job(job, now)
        self.publish_metrics()
        return any(j.state in ("queued", "running", "batched")
                   for j in self.jobs.values())

    # ---- metrics / status ----

    def publish_metrics(self):
        counts = {s: 0 for s in JOB_STATES}
        for j in self.jobs.values():
            counts[j.state] = counts.get(j.state, 0) + 1
        fams = [
            ("avida_fleet_jobs", "gauge", "jobs by orchestration state",
             {f'state="{s}"': n for s, n in sorted(counts.items())}),
            ("avida_fleet_failures_total", "counter",
             "classified child failures across all jobs",
             {f'class="{c}"': n for c, n in self.failures.items()}),
            ("avida_fleet_breaker_open", "gauge",
             "1 while the crash-storm circuit breaker holds admissions",
             int(self.breaker.open_class is not None)),
            ("avida_fleet_breaker_trips_total", "counter",
             "circuit breaker openings", self.breaker.trips),
            ("avida_fleet_admissions_paused", "gauge",
             "1 while admission control is refusing new jobs",
             int(self.admissions_paused)),
            ("avida_fleet_xla_fallback", "gauge",
             "the reference's fleet-wide degradation; always 0: the "
             "port never routes a job around its kernel", 0),
            ("avida_fleet_max_jobs", "gauge",
             "admission-control concurrency budget", self.cfg.max_jobs),
            ("avida_fleet_queue_depth", "gauge",
             "jobs ingested and waiting for admission (backpressure "
             "holds later specs on disk past TPU_FLEET_QUEUE_MAX)",
             counts.get("queued", 0)),
            ("avida_fleet_heartbeat_timestamp_seconds", "gauge",
             "unix time of the last orchestrator export",
             round(time.time(), 3)),
        ]
        if self.serve_pool is not None:
            fams += self.serve_pool.gauges()
        if self.alerts is not None:
            fams += self.alerts.families()
        try:
            text = render_families(fams)
            write_metrics(self.metrics_path, text, durable=False)
            self._hist.publish(text)
        except OSError:
            pass

    # ---- lifecycle ----

    def _acquire_lock(self):
        """Two orchestrators draining one spool would double-spawn every
        job -- refuse to start while a live one holds the lock.  The
        acquire is an O_CREAT|O_EXCL create (atomic: two racers cannot
        both win); a lock whose pid is dead, recycled by a non-fleet
        process, or our own is stale and taken over."""
        path = os.path.join(self.spool, LOCK_FILE)
        for _attempt in range(2):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                try:
                    with open(path) as f:
                        pid = int(f.read().strip() or 0)
                except (OSError, ValueError):
                    pid = 0
                if pid and pid != os.getpid() \
                        and self._pid_owns_spool(pid):
                    raise FleetLockedError(
                        f"orchestrator pid {pid} already owns "
                        f"{self.spool!r} ({LOCK_FILE})")
                try:
                    os.remove(path)     # stale: take over, then re-race
                except OSError:
                    pass
                continue
            with os.fdopen(fd, "w") as f:
                f.write(f"{os.getpid()}\n")
            return
        raise FleetLockedError(
            f"could not acquire {LOCK_FILE} under {self.spool!r}")

    def _pid_owns_spool(self, pid: int) -> bool:
        """Is `pid` a live fleet orchestrator of THIS spool?  Resolves
        the --fleet argument out of /proc/<pid>/cmdline (relative paths
        against that process's own cwd) so a recycled pid running a
        DIFFERENT spool's fleet does not wedge this one forever.
        Conservative on ambiguity: an unresolvable --fleet argument
        still counts as the owner -- wrongly stealing a live lock
        (double orchestrator) is worse than wrongly refusing to start."""
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                args = [a.decode("utf-8", "replace")
                        for a in f.read().split(b"\0") if a]
        except OSError:
            return False                # process gone: stale lock
        if "--fleet" not in args:
            return False                # pid recycled by something else
        i = args.index("--fleet")
        if i + 1 >= len(args):
            return True
        raw = args[i + 1]
        try:
            if not os.path.isabs(raw):
                raw = os.path.join(os.readlink(f"/proc/{pid}/cwd"), raw)
            return os.path.realpath(raw) == self.spool
        except OSError:
            return True

    def _release_lock(self):
        try:
            os.remove(os.path.join(self.spool, LOCK_FILE))
        except OSError:
            pass

    def request_stop(self):
        self._stop = True

    def _drain(self) -> int:
        """Graceful shutdown: SIGTERM every child (they write preemption
        checkpoints), wait up to drain_sec, requeue whatever did not
        complete.  Exit 0 -- a drained fleet is a resumable fleet."""
        running = [j for j in self.jobs.values() if j.state == "running"]
        self.journal("drain", jobs_running=len(running),
                     drain_sec=self.cfg.drain_sec)
        for job in running:
            job.sup.request_stop()
        deadline = self._clock() + self.cfg.drain_sec
        while self._clock() < deadline:
            live = [j for j in self.jobs.values()
                    if j.state == "running"]
            if not live:
                break
            for job in live:
                self._poll_job(job, self._clock())
            self.publish_metrics()
            self._sleep(min(self.cfg.poll_sec, 0.5))
        for job in [j for j in self.jobs.values()
                    if j.state == "running"]:
            # drain deadline blown: hard-stop, then one last poll so
            # the kill flows through the supervisor's _finish (child
            # log closed, classified exit record written) and the job
            # lands in the normal requeue path
            proc = job.sup._proc
            if proc is not None:
                job.sup._kill_child(proc)
            self._poll_job(job, self._clock())
            if job.state == "running":          # supervisor stuck: force
                job.state = "queued"
                job.sup = None
                self.journal("requeued", job=job.name,
                             reason="drain_kill")
        self.publish_metrics()
        self.journal("fleet_stop", reason="drain")
        return 0

    def run(self) -> int:
        """Orchestrate until the spool is drained (or forever with
        cfg.serve).  Returns 0 when every known job ended well
        (done/cancelled/requeued), 1 when any failed or was
        quarantined, 2 when another orchestrator holds the lock."""
        try:
            self._acquire_lock()
        except FleetLockedError as e:
            print(f"[fleet] {e}", file=sys.stderr)
            return 2
        saved = {}

        def on_signal(signum, frame):
            self._stop = True

        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                saved[s] = signal.signal(s, on_signal)
            except ValueError:
                pass
        self.journal("fleet_start", max_jobs=self.cfg.max_jobs,
                     jobs_known=len(self.jobs))
        try:
            while True:
                if self._stop:
                    return self._drain()
                active = self.poll_once()
                if not active and not self.cfg.serve:
                    break
                self._sleep(self.cfg.poll_sec)
            bad = [j.name for j in self.jobs.values()
                   if j.state in ("failed", "quarantined")]
            self.journal("fleet_stop", reason="spool drained",
                         failed=sorted(bad))
            return 1 if bad else 0
        finally:
            for s, h in saved.items():
                try:
                    signal.signal(s, h)
                except (ValueError, OSError):
                    pass
            self.publish_metrics()
            self._release_lock()


# ---------------------------------------------------------------------------
# --status fleet view (host-only, no orchestrator required)
# ---------------------------------------------------------------------------

def format_fleet_status(spool: str, now: float | None = None) -> str:
    """Human-readable fleet summary: aggregate gauges from fleet.prom +
    a per-job table reconstructed from the journal and the spool."""
    now = time.time() if now is None else now
    lines = []
    metrics = {}
    mpath = os.path.join(spool, FLEET_METRICS_FILE)
    if os.path.exists(mpath):
        metrics = read_metrics(mpath)
        hb = metrics.get("avida_fleet_heartbeat_timestamp_seconds")
        age = f"{now - hb:.1f}s ago" if hb else "unknown"
        counts = {k.split('state="', 1)[1].rstrip('"}'): int(v)
                  for k, v in metrics.items()
                  if k.startswith("avida_fleet_jobs{")}
        lines.append("fleet       "
                     + ", ".join(f"{s} {n}" for s, n in
                                 sorted(counts.items()) if n))
        if metrics.get("avida_fleet_breaker_open"):
            lines.append("breaker     OPEN (admissions paused)")
        if metrics.get("avida_fleet_xla_fallback"):
            lines.append("degraded    fleet-wide XLA fallback active")
        # fleet-level alert column (observability/alerts.py families
        # exported by the orchestrator's own poll loop)
        from avida_tpu_torch.observability.alerts import \
            format_alert_status
        alert_line = format_alert_status(metrics)
        if alert_line is not None:
            lines.append(alert_line)
        lines.append(f"heartbeat   {age}")
    state = spool_job_states(spool)
    leaders = journal_batch_leaders(os.path.join(spool, JOURNAL_FILE))
    riders: dict = {}
    for member, leader in leaders.items():
        if state.get(member) == "batched":
            riders.setdefault(leader, []).append(member)

    def world_rows(leader: str) -> tuple:
        """({world_name: (update, organisms, straggler_lag)}, batch
        efficiency or None) from the leader batch's per-world metric
        rows (multiworld.prom).  The lag/efficiency gauges come from
        MultiWorldExporter's occupancy families."""
        path = os.path.join(spool, leader, "data", "multiworld.prom")
        if not os.path.exists(path):
            return {}, None
        from avida_tpu_torch.observability.exporter import multiworld_rows
        m = read_metrics(path)
        rows = multiworld_rows(m)
        eff = m.get("avida_multiworld_batch_efficiency")
        return ({n: (int(d.get("avida_update", 0)),
                     int(d.get("avida_organisms", 0)),
                     float(d.get(
                         "avida_multiworld_straggler_lag_updates", 0.0)))
                 for n, d in rows.items()},
                None if eff is None else float(eff))

    for name in sorted(state):
        st = state[name]
        if st == "batched" and leaders.get(name) in riders:
            continue                  # rendered under its leader below
        extra = ""
        sup_prom = os.path.join(spool, name, "data", "supervisor.prom")
        if os.path.exists(sup_prom):
            sup = read_metrics(sup_prom)
            boots = int(sup.get("avida_supervisor_boots_total", 0))
            fails = int(sum(v for k, v in sup.items()
                            if k.startswith(
                                "avida_supervisor_failures_total")))
            extra = f"  (boots {boots}, failures {fails})"
            # per-job alert column: names of rules the job's embedded
            # supervisor currently reports firing
            from avida_tpu_torch.observability.alerts import \
                firing_from_metrics
            firing = firing_from_metrics(sup)["firing"]
            if firing:
                extra += "  ALERTS " + ",".join(sorted(firing))
        run_prom = os.path.join(spool, name, "data", "metrics.prom")
        runm = read_metrics(run_prom) if os.path.exists(run_prom) \
            else None
        if runm is not None and (
                "avida_compile_cache_hits_total" in runm
                or "avida_compile_cache_misses_total" in runm):
            # persistent-compile-cache column (utils/compilecache.py's
            # families in a child's heartbeat): hits/misses and the
            # milliseconds spent verifying and loading the library
            extra += (
                "  cache "
                f"{int(runm.get('avida_compile_cache_hits_total', 0))}h/"
                f"{int(runm.get('avida_compile_cache_misses_total', 0))}m"
                f" load "
                f"{runm.get('avida_compile_cache_load_ms_total', 0.0):.0f}"
                f"ms")
        if runm is not None and (
                "avida_integrity_scrubs_total" in runm
                or "avida_state_digest" in runm):
            # integrity-plane column (utils/integrity.py families in
            # the child's heartbeat): scrubs / detected mismatches --
            # a nonzero second number means this job has already been
            # rolled back past silent corruption at least once
            extra += (
                "  integrity "
                f"{int(runm.get('avida_integrity_scrubs_total', 0))}s/"
                f"{int(runm.get('avida_integrity_mismatches_total', 0))}x")
        ana_prom = os.path.join(spool, name, "data", "analytics.prom")
        if os.path.exists(ana_prom):
            # per-tenant census column (analyze/pipeline.py live mode):
            # dominant lineage depth / census age / tasks-held, derived
            # by the same digest helper as the single-run --status line
            d = analytics_census_digest(read_metrics(ana_prom), runm)
            age = "?" if d["age"] is None else str(d["age"])
            extra += (f"  census u{d['update']} age {age}u "
                      f"depth {d['depth']} tasks {d['tasks_held']}")
        serve_json = os.path.join(spool, name, "data", "serve.json")
        if os.path.exists(serve_json):
            # a serve-class child: width/ghost occupancy + compile
            # count from its status file (parallel/multiworld.ServeBatch;
            # the port's child counts its nvcc builds there)
            try:
                with open(serve_json) as f:
                    sj = json.load(f)
                extra += (f"  serve w{sj.get('width')} "
                          f"live {sj.get('live')} "
                          f"ghosts {sj.get('ghosts')} "
                          f"compiles {sj.get('compiles')}")
            except (OSError, ValueError):
                pass
        members = riders.get(name, ())
        if members:
            extra = f"  (batch x{1 + len(members)}){extra}"
        lines.append(f"  {name:<24} {st}{extra}")
        if members:
            # one batched job = one row, its worlds as sub-rows (the
            # leader's own world first, then each rider's), each with
            # its straggler lag; batch efficiency on the leader row
            per, eff = world_rows(name)
            if eff is not None:
                lines[-1] += f"  efficiency {eff:.2f}"
            for wname in [name] + sorted(members):
                u, orgs, lag = per.get(wname, (None, None, 0.0))
                detail = ("(no per-world metrics yet)" if u is None
                          else f"u{u} organisms {orgs} lag {lag:.1f}u")
                role = "lead" if wname == name else "batched"
                lines.append(f"    - {wname:<20} {role}  {detail}")
    return "\n".join(lines) if lines else f"empty spool {spool!r}"


def fleet_status_main(spool: str, max_age: float | None = None) -> int:
    """The --status view for a spool dir: 0 = fleet metrics present
    (and fresh when --max-age is given), 1 = no fleet.prom, 2 = stale
    orchestrator heartbeat."""
    mpath = os.path.join(spool, FLEET_METRICS_FILE)
    if not os.path.exists(mpath):
        # journal-only view (orchestrator never ran / metrics removed):
        # still show the job table, but exit 1 so watchdogs see it
        print(format_fleet_status(spool))
        print(f"no {FLEET_METRICS_FILE} under {spool!r} (orchestrator "
              f"not started?)")
        return 1
    print(format_fleet_status(spool))
    if max_age is not None:
        hb = read_metrics(mpath).get(
            "avida_fleet_heartbeat_timestamp_seconds")
        age = None if hb is None else time.time() - hb
        if age is None or age > max_age:
            shown = "missing" if age is None else f"{age:.1f}s"
            print(f"STALE: orchestrator heartbeat {shown} exceeds "
                  f"--max-age {max_age}s")
            return 2
    return 0


# ---------------------------------------------------------------------------
# CLI entry (dispatched from avida_tpu_torch/__main__.py before any torch
# import)
# ---------------------------------------------------------------------------

def fleet_main(argv: list) -> int:
    argv = list(argv)
    i = argv.index("--fleet")
    if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
        print("--fleet needs a spool directory argument", file=sys.stderr)
        return 2
    spool = argv[i + 1]
    del argv[i:i + 2]
    cfg = FleetConfig.from_env(os.environ)
    if "--max-jobs" in argv:
        i = argv.index("--max-jobs")
        if i + 1 >= len(argv) or not argv[i + 1].isdigit():
            print("--max-jobs needs an integer argument", file=sys.stderr)
            return 2
        cfg.max_jobs = max(int(argv[i + 1]), 1)
        del argv[i:i + 2]
    if "--serve" in argv:
        cfg.serve = True
        argv.remove("--serve")
    if "--dynamic" in argv:
        cfg.dynamic = True
        argv.remove("--dynamic")
    if argv:
        print(f"unrecognized --fleet arguments: {argv}", file=sys.stderr)
        return 2
    return FleetOrchestrator(spool, cfg=cfg).run()
