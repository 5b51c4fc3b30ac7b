"""Streaming serve layer: batchability classes and the warm-class pool.

Counterpart of avida_tpu/service/serve.py (host-only: nothing here
imports torch, the same rule as the supervisor and the orchestrator).
The fleet orchestrator (service/fleet.py) uses three pieces of it:

  1. **Batchability classes** -- `static_signature` resolves a spec's
     argv the way the child CLI would (config files loaded, `-set`
     overrides applied through config/schema.py, config-dir file
     contents fingerprinted) and hashes the RESOLVED static
     configuration with the non-static knobs (seed, output and
     checkpoint dirs, verbosity, checkpoint cadence) stripped.  Two
     specs that differ only in spelling -- output dirs, `-s` position vs
     `-set RANDOM_SEED`, override order, defaults spelled out vs omitted
     -- land in one class; the digests equal the reference's string for
     string.  The static `--worlds` coalescer keys on it too.
  2. **Width classes** -- a serve batch's width is padded to a small
     power-of-two set (`width_class`), so one class child serves
     arbitrary churn at one shape; the padding slots ride as inert ghost
     worlds (parallel/multiworld.ServeBatch).
  3. **The warm pool** -- `ServePool` (`--fleet --dynamic` /
     TPU_FLEET_DYNAMIC=1) keeps one long-lived `--serve-worlds` child per
     (signature, padded width): new arrivals route into a warm child's
     free ghost slot (a cache hit: no new process, no build, the cycle
     library already loaded) instead of spawning a cold one (a miss).

`SpecArgv` is the one spelling of spec-argv analysis (seed extraction
for the worlds manifest, dir stripping for fault-domain safety, `-u`
extraction), and `member_argv` the argv a class child is launched with.

Membership changes flow through each class child's `control.json`
(atomic rewrite; the child reconciles at checkpoint boundaries) and
come back through its `data/serve.json` status file.  Every transition
is journaled in the fleet.jsonl grammar -- `admit` for a class leader,
`coalesced` to place a member, `done`/`cancelled`/`requeued`/`sdc` to
settle one -- so journal replay after an orchestrator SIGKILL resumes
every tenant from its own per-world checkpoints with no new record
kinds.
"""

from __future__ import annotations

import hashlib
import json
import os

# config vars that do NOT change the compiled update program or the
# evolved trajectory of a tenant (seeds and output/checkpoint routing,
# cadence knobs the serve child overrides class-wide anyway): stripped
# before hashing so they cannot split a batchability class
NONSTATIC_VARS = frozenset((
    "RANDOM_SEED", "DATA_DIR", "VERBOSITY",
    "TPU_CKPT_DIR", "TPU_CKPT_EVERY", "TPU_CKPT_KEEP", "TPU_CKPT_FINAL",
    "TPU_CKPT_AUDIT", "TPU_METRICS", "TPU_SERVE_IDLE_SEC",
    "TPU_SERVE_POLL_SEC", "TPU_SERVE_WARM",
    # the persistent program cache changes neither the update program's
    # semantics nor the trajectory (the reference's
    # utils/compilecache.py, and the port's) -- cache
    # knobs must not split a batchability class
    "TPU_COMPILE_CACHE", "TPU_COMPILE_CACHE_DIR",
    # the integrity plane (digests + sampled shadow replay) is host-side
    # batch-level instrumentation: trajectories are bit-identical with
    # it on or off, so its knobs must not split a class either
    "TPU_STATE_DIGEST", "TPU_SCRUB_EVERY",
    # telemetry history rings (observability/history.py) are host-side
    # instrumentation too -- sampling cadence cannot split a class
    "TPU_METRICS_HIST", "TPU_METRICS_HIST_EVERY",
    "TPU_METRICS_HIST_MAX_BYTES",
    # the performance attribution plane (observability/profiler.py)
    # probes device-owned state COPIES only -- trajectories are
    # bit-identical with it on or off, so its knobs cannot split a
    # batchability class either
    "TPU_PROFILE", "TPU_PROFILE_EVERY", "TPU_PROFILE_TRACE",
))
# Reviewed and deliberately NOT listed: TPU_PACKED_CHUNK,
# TPU_PACKED_FUSED, TPU_PACKED_BITS.  They are program-affecting
# STATICS -- each selects a different update engine body / resident
# plane layout -- so a batch must not mix values.  They stay in the
# signature and split batchability classes, exactly like
# TPU_USE_PALLAS.

# spec env vars that are per-job operational knobs, not program inputs
_NONSTATIC_ENV = frozenset((
    "TPU_WATCHDOG_SEC", "TPU_SUPERVISE_POLL_SEC", "TPU_SUPERVISE_GRACE_SEC",
    "TPU_SUPERVISE_MAX_RETRIES", "TPU_SUPERVISE_BACKOFF_BASE",
    "TPU_SUPERVISE_BACKOFF_CAP", "TPU_SUPERVISE_HEALTHY_SEC",
    "TPU_SUPERVISE_SEED", "TPU_PROGRESS_SEC",
    "TPU_COMPILE_CACHE", "TPU_COMPILE_CACHE_DIR",
    "TPU_METRICS_HIST", "TPU_METRICS_HIST_EVERY",
    "TPU_METRICS_HIST_MAX_BYTES", "TPU_ALERT_EVAL_SEC",
    "TPU_PROFILE", "TPU_PROFILE_EVERY", "TPU_PROFILE_TRACE",
))


class SpecArgv:
    """One parsed child argv: the pieces the serving layer routes on.
    THE one spelling of spec-argv analysis -- seed extraction for the
    worlds manifest, dir stripping for fault-domain safety, `-u`
    extraction for per-member budgets -- shared by the static coalescer
    (fleet._form_batches / _start_batch) and the serve pool."""

    def __init__(self, argv):
        self.config_dir = None
        self.sets = []                  # (-set NAME VALUE) pairs, in order
        self.residual = []              # tokens the serving layer keeps
        self.seed = None                # -s / --seed (beats -set RANDOM_SEED)
        self.set_seed = None
        self.updates = None             # -u / --updates
        self.data_dir = None
        argv = list(argv or ())
        i = 0
        while i < len(argv):
            a = argv[i]
            if a in ("-s", "--seed") and i + 1 < len(argv):
                self.seed = argv[i + 1]
                i += 2
            elif a in ("-d", "--data-dir") and i + 1 < len(argv):
                self.data_dir = argv[i + 1]
                i += 2
            elif a in ("-u", "--updates") and i + 1 < len(argv):
                self.updates = argv[i + 1]
                i += 2
            elif a in ("-c", "--config-dir") and i + 1 < len(argv):
                self.config_dir = argv[i + 1]
                i += 2
            elif a == "-set" and i + 2 < len(argv):
                self.sets.append((argv[i + 1], argv[i + 2]))
                i += 3
            else:
                self.residual.append(a)
                i += 1

    @property
    def effective_seed(self):
        """The seed the child would use: `-s` beats `-set RANDOM_SEED`
        regardless of argv position (the solo CLI appends -s AFTER
        every -set override; last one wins in the config)."""
        raw = self.seed
        if raw is None:
            for n, v in self.sets:
                if n == "RANDOM_SEED":
                    raw = v
        try:
            return int(raw) if raw is not None else None
        except (TypeError, ValueError):
            return None

    @property
    def max_updates(self):
        try:
            return int(self.updates) if self.updates is not None else None
        except ValueError:
            return None


def member_argv(spec) -> list:
    """A spec's argv with the per-member routing stripped (seed, data
    dir, checkpoint dir) -- what a `--worlds` / `--serve-worlds` class
    child is launched with (the worlds manifest / control file carries
    the per-member values).  `-u` is KEPT: the static coalescer runs
    one shared budget; the serve pool strips it separately via
    SpecArgv.max_updates into per-member budgets."""
    argv = list(spec.get("argv") or ())
    out = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-s", "--seed", "-d", "--data-dir") and i + 1 < len(argv):
            i += 2
            continue
        if a == "-set" and i + 2 < len(argv) \
                and argv[i + 1] in ("RANDOM_SEED", "TPU_CKPT_DIR"):
            i += 3
            continue
        out.append(a)
        i += 1
    return out


def _config_fingerprint(config_dir: str) -> object:
    """Content hash of every regular file in a spec's config dir: two
    specs naming different config dirs with IDENTICAL contents resolve
    to one class; editing any config file splits it.  Config dirs are a
    handful of small text files; unreadable entries hash by name."""
    if not config_dir:
        return None
    try:
        names = sorted(os.listdir(config_dir))
    except OSError:
        return f"unreadable:{os.path.realpath(config_dir)}"
    h = hashlib.sha1()
    for n in names:
        p = os.path.join(config_dir, n)
        if not os.path.isfile(p):
            continue
        h.update(n.encode())
        try:
            with open(p, "rb") as f:
                h.update(hashlib.sha1(f.read()).digest())
        except OSError:
            h.update(b"?")
    return h.hexdigest()


def static_signature(spec, with_updates: bool = True) -> str:
    """The canonical batchability-class key for one job spec: a digest
    of the RESOLVED static configuration.

    Resolution mirrors the child CLI: load `avida.cfg` from the spec's
    config dir (builtin defaults when absent), apply its `-set`
    overrides in order, then drop NONSTATIC_VARS (seed, dirs, cadence
    knobs).  The digest also covers the config-dir file contents (the
    instruction set / environment / events / ancestor files the
    resolved config names all live there), the residual argv tokens the
    parser didn't interpret (unknown flags must not falsely coalesce),
    and the spec's env minus per-job supervisor knobs.  `with_updates`
    keeps `-u` in the key (the static `--worlds` coalescer shares one
    budget); the serve pool passes False and carries per-member budgets
    in the control file.

    Falls back to a literal-argv key when resolution fails (unreadable
    config): degrading to byte-equality of the argv is always safe."""
    from avida_tpu_torch.config.schema import AvidaConfig, load_avida_cfg
    pa = SpecArgv(spec.get("argv"))
    env = tuple(sorted((k, v) for k, v in (spec.get("env") or {}).items()
                       if k not in _NONSTATIC_ENV))
    try:
        import warnings
        if pa.config_dir:
            cfg_path = os.path.join(pa.config_dir, "avida.cfg")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                if os.path.exists(cfg_path):
                    cfg = load_avida_cfg(cfg_path, pa.sets)
                else:
                    cfg = AvidaConfig()
                    for n, v in pa.sets:
                        cfg.set(n, v)
        else:
            cfg = AvidaConfig()
            for n, v in pa.sets:
                cfg.set(n, v)
        static = {n: getattr(cfg, n) for n in sorted(cfg.field_names())
                  if n not in NONSTATIC_VARS}
        static["extras"] = {k: v for k, v in sorted(cfg.extras.items())
                            if k not in NONSTATIC_VARS}
        body = {
            "static": static,
            "config_files": _config_fingerprint(pa.config_dir),
            "residual": list(pa.residual),
            "env": env,
        }
        if with_updates:
            body["updates"] = pa.updates
        text = json.dumps(body, sort_keys=True, default=str)
        return "sig:" + hashlib.sha1(text.encode()).hexdigest()
    except Exception:
        key = (tuple(member_argv(spec)), env,
               pa.updates if with_updates else None)
        return "raw:" + hashlib.sha1(repr(key).encode()).hexdigest()


def width_class(n: int, min_width: int, max_width: int) -> int:
    """The padded width for n tenants: the smallest power of two >=
    max(n, min_width), capped at the largest power of two <=
    max_width.  A small fixed set of widths = a small fixed set of
    batch shapes, every one reusable across arbitrary churn."""
    cap = 1
    while cap * 2 <= max(int(max_width), 1):
        cap *= 2
    w = 1
    while w < max(int(n), int(min_width), 1):
        w *= 2
    return min(w, cap)


def batch_ineligible_reason(spec) -> str | None:
    """Host-side screen for workloads the batched run loops refuse
    (telemetry / tracing / analytics / device fault injection are
    per-run host pipelines).  None = may batch."""
    pa = SpecArgv(spec.get("argv"))
    flags = set(pa.residual)
    if "--telemetry" in flags or "--trace" in flags \
            or "--profile-dir" in flags:
        return "telemetry/trace workloads run solo"
    for n, v in pa.sets:
        if n in ("TPU_TELEMETRY", "TPU_TRACE", "TPU_ANALYTICS") \
                and str(v) not in ("0", "-", ""):
            return f"{n} workloads run solo"
        if n == "TPU_FAULT" and str(v) not in ("0", "-", ""):
            return "TPU_FAULT is per-process"
    return None


# ---------------------------------------------------------------------------
# the warm pool
# ---------------------------------------------------------------------------

class ServeClass:
    """One warm class: a long-lived `--serve-worlds` child serving every
    tenant of one (signature, width) class."""

    def __init__(self, leader, sig: str, width: int):
        self.leader = leader            # the fleet Job running the child
        self.sig = sig
        self.width = width
        self.members: dict = {}         # name -> control entry
        self.shutdown_sent = False
        self.dirty = False              # members/control.json diverged
        #                                 (a write failed); poll retries

    @property
    def control_path(self) -> str:
        return os.path.join(self.leader.dir, "control.json")

    @property
    def status_path(self) -> str:
        return os.path.join(self.leader.dir, "data", "serve.json")

    def free_slots(self) -> int:
        return self.width - len(self.members)

    def write_control(self):
        # `sig` rides along as the reference's control carries it (its
        # child stamps the class into its program-cache entries;
        # informational in the port's child, which builds no program
        # per class)
        doc = {"width": self.width, "sig": self.sig,
               "shutdown": self.shutdown_sent,
               "members": sorted(self.members.values(),
                                 key=lambda e: e["name"])}
        tmp = f"{self.control_path}.tmp.{os.getpid()}"
        os.makedirs(self.leader.dir, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.control_path)
        self.dirty = False

    def read_status(self):
        try:
            with open(self.status_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


class ServePool:
    """The orchestrator's serving brain (TPU_FLEET_DYNAMIC / --dynamic):
    routes batchable arrivals into warm class children, spawns cold
    ones when no class fits, settles member outcomes from the children's
    status files, and journals everything in the fleet grammar.  Owned
    and driven by FleetOrchestrator; holds no threads and does no
    blocking work of its own."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.classes: dict = {}         # leader name -> ServeClass
        self._seq = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.promotions = 0
        self.demotions = 0
        self._rebuilt = False

    # ---- restart recovery ----

    def rebuild(self):
        """Reattach classes after a journal replay: every non-terminal
        serve leader (job dir holding a control.json) gets its
        ServeClass back, and members its control still lists -- which
        replay parked back in the queue -- are re-marked batched so
        they are not double-admitted as solo runs."""
        if self._rebuilt:
            return
        self._rebuilt = True
        for name, job in list(self.fleet.jobs.items()):
            ctl_path = os.path.join(job.dir, "control.json")
            if job.state not in ("queued", "running") \
                    or not os.path.exists(ctl_path):
                continue
            try:
                with open(ctl_path) as f:
                    doc = json.load(f)
                width = int(doc.get("width", 0))
                entries = {str(e["name"]): e
                           for e in doc.get("members") or []
                           if isinstance(e, dict) and e.get("name")}
            except (OSError, ValueError):
                continue
            if width < 1:
                continue
            sig = (job.spec or {}).get("serve_sig") or \
                self._sig_from_job(job)
            cls = ServeClass(job, sig, width)
            self.classes[name] = cls
            for mname, entry in entries.items():
                m = self.fleet.jobs.get(mname)
                if m is None or m.state not in ("queued", "batched"):
                    continue
                cls.members[mname] = entry
                m.state = "batched"
                m.batch_leader = name
            self.fleet.journal("serve_reattach", job=name,
                               members=sorted(cls.members))

    def _sig_from_job(self, job) -> str:
        """A reattached leader's class signature.  The stored
        `serve_sig` is authoritative: the leader's own argv carries
        `--serve-worlds CONTROL` and has the member routing stripped,
        so re-hashing it would NEVER equal a member signature and every
        post-restart arrival would cold-spawn a duplicate class."""
        spec = self.fleet._load_spec(job) or {}
        sig = spec.get("serve_sig")
        return sig or static_signature(spec, with_updates=False)

    # ---- admission routing ----

    def offer(self, job, spec) -> bool:
        """Try to place one queued batchable spec into a warm class
        (cache hit).  Returns True when the job was promoted; False
        leaves it queued for _admit to group into a new class (or run
        solo)."""
        if job._serve_sig is None:
            job._serve_sig = static_signature(spec, with_updates=False)
        sig = job._serve_sig
        pa = SpecArgv(spec.get("argv"))
        seed = pa.effective_seed
        if seed is None:
            return False
        for cls in self.classes.values():
            if cls.sig != sig or cls.shutdown_sent:
                continue
            if cls.leader.state != "running" or cls.free_slots() < 1:
                continue
            if self._place(cls, job, seed, pa.max_updates, hit=True):
                self.cache_hits += 1
                return True
            return False                # quarantined: not placeable
        return False

    def spawn_class(self, group) -> bool:
        """Cold path: one admission slot becomes a new class child
        sized for the whole queued group [(job, spec)].  Members beyond
        the width cap stay queued for the next slot (or the next free
        ghost, once this child is warm)."""
        cfg = self.fleet.cfg
        job0, spec0 = group[0]
        sig = job0._serve_sig
        width = width_class(len(group), cfg.serve_min_width,
                            cfg.max_batch)
        self._seq += 1
        name = f"serve-{sig[4:12]}-w{width}-{self._seq}"
        while name in self.fleet.jobs:
            self._seq += 1
            name = f"serve-{sig[4:12]}-w{width}-{self._seq}"
        from avida_tpu_torch.service.fleet import Job
        leader = Job(name, self.fleet.spool)
        cls = ServeClass(leader, sig, width)
        leader.spec = {
            "argv": member_argv(spec0) + ["--serve-worlds",
                                          cls.control_path],
            "env": dict(spec0.get("env") or {}),
            "serve_sig": sig,
        }
        try:
            os.makedirs(leader.dir, exist_ok=True)
            tmp = f"{leader.spec_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(leader.spec, f, indent=1)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, leader.spec_path)
            cls.write_control()
        except OSError as e:
            self.fleet.journal("batch_fallback", job=job0.name,
                               reason=f"serve class setup failed: {e}")
            return False
        self.fleet.jobs[name] = leader
        self.fleet.journal("admit", job=name)
        self.fleet.journal("serve_class", job=name, sig=sig,
                           width=width, group=len(group))
        if not self.fleet._start(leader):
            return False
        self.classes[name] = cls
        self.cache_misses += 1
        for job, spec in group[:width]:
            pa = SpecArgv(spec.get("argv"))
            self._place(cls, job, pa.effective_seed, pa.max_updates,
                        hit=False)
        return True

    def _place(self, cls: ServeClass, job, seed, max_updates,
               hit: bool) -> bool:
        if not self.fleet._admit_spec_move(job):
            return False                # quarantined by the move
        entry = {"name": job.name, "seed": seed,
                 "data_dir": job.data_dir, "ckpt_dir": job.ckpt_dir,
                 "max_updates": max_updates}
        cls.members[job.name] = entry
        try:
            cls.write_control()
        except OSError:
            cls.dirty = True            # poll() retries the rewrite
        job.state = "batched"
        job.batch_leader = cls.leader.name
        self.promotions += 1
        self.fleet.journal("coalesced", job=job.name,
                           leader=cls.leader.name, serve=True,
                           cache="hit" if hit else "miss")
        return True

    # ---- member lifecycle ----

    def cancel(self, job) -> bool:
        """Demote one serve member: drop it from the control (the child
        retires it with a final checkpoint at the next boundary) while
        its classmates keep running.  The terminal `cancelled` record
        lands at the poll that sees the child's status without it."""
        cls = self.classes.get(job.batch_leader or "")
        if cls is None or job.name not in cls.members:
            return False
        del cls.members[job.name]
        try:
            cls.write_control()
        except OSError:
            cls.dirty = True            # poll() retries the rewrite
        job.cancel_requested = True
        self.demotions += 1
        self.fleet.journal("cancel_requested", job=job.name,
                           batch_leader=cls.leader.name, serve=True)
        return True

    def poll(self):
        """Settle member outcomes from each class child's status file,
        dissolve classes whose leader ended, and ask idle classes to
        shut down when no more traffic can arrive for them."""
        self.rebuild()
        fleet = self.fleet
        for lname, cls in list(self.classes.items()):
            leader = cls.leader
            if leader.state in ("done", "failed", "cancelled",
                                "quarantined"):
                # class gone: iterate every job still POINTING at this
                # leader, not just cls.members -- a cancel-requested
                # member was already dropped from the control and would
                # otherwise be orphaned 'batched' forever (the settle
                # block below never runs for a dead leader).  Members
                # still riding resume elsewhere: their solo-format
                # checkpoints make requeue safe; cancelled members land
                # terminal here.
                for mname, m in sorted(fleet.jobs.items()):
                    if m.batch_leader != lname or m.state != "batched":
                        continue
                    m.batch_leader = None
                    if m.cancel_requested:
                        m.state = "cancelled"
                        fleet.journal("cancelled", job=mname)
                        continue
                    m.state = "queued"
                    m.sup = None
                    m._batch_progress = None
                    m._serve_sig = None
                    m._batch_key = None
                    fleet.journal("requeued", job=mname,
                                  reason="serve_leader_"
                                         + leader.state)
                del self.classes[lname]
                continue
            if cls.dirty and leader.state == "running":
                try:
                    cls.write_control()   # the deferred-rewrite retry
                except OSError:
                    pass
            status = cls.read_status() if leader.state == "running" \
                else None
            if status is not None:
                self._settle_members(cls, status)
            # cancelled members: terminal once the child no longer
            # serves them (status absent counts once the child has
            # reconciled -- or the leader is not even running)
            for mname in [n for n, j in fleet.jobs.items()
                          if j.batch_leader == lname
                          and j.cancel_requested
                          and j.state == "batched"]:
                served = status is not None and (
                    mname in (status.get("members") or {}))
                if not served and mname not in cls.members:
                    m = fleet.jobs[mname]
                    m.state = "cancelled"
                    m.batch_leader = None
                    fleet.journal("cancelled", job=mname)
            # idle eviction: nothing served, nothing queued that fits,
            # and the fleet is draining -> ask the child to exit so
            # run() can finish (a --serve fleet keeps classes warm)
            if not cls.members and not cls.shutdown_sent \
                    and not fleet.cfg.serve:
                # _serve_sig is only computed at admission, which runs
                # AFTER this poll in the tick -- a batch spec ingested
                # this very tick has sig None, and shutting the class
                # down on its account would cold-spawn a duplicate for
                # the exact late arrival the warm pool exists to serve.
                # Defer the eviction until every queued batch spec has
                # been signatured (next tick, after _admit).
                queued_same = any(
                    j.state == "queued"
                    and (j._serve_sig == cls.sig
                         or (j._serve_sig is None
                             and (fleet._load_spec(j) or {}).get("batch")))
                    for j in fleet.jobs.values())
                if not queued_same:
                    cls.shutdown_sent = True
                    try:
                        cls.write_control()
                    except OSError:
                        cls.shutdown_sent = False

    def _settle_members(self, cls: ServeClass, status: dict):
        fleet = self.fleet
        fin = status.get("finished") or {}
        for mname, rec in list(fin.items()):
            job = fleet.jobs.get(mname)
            if job is None or job.state != "batched" \
                    or job.batch_leader != cls.leader.name:
                continue
            st = rec.get("state")
            if st == "done":
                job.state = "done"
                job.batch_leader = None
                cls.members.pop(mname, None)
                fleet.journal("done", job=mname,
                              update=rec.get("update"),
                              serve_leader=cls.leader.name)
                try:
                    cls.write_control()   # the ack: child forgets it
                except OSError:
                    cls.dirty = True
            elif st == "sdc":
                # silent-corruption demotion (the integrity plane): the
                # serve child detected a scrub digest mismatch for this
                # tenant, quarantined its suspect generations and freed
                # the slot -- classmates kept serving.  Requeue the
                # member so the next placement readmits it (warm class
                # first), resuming from the newest digest-verified
                # generation: the tenant rolls back ALONE.  The sig is
                # kept -- same class, same warm child.
                job.state = "queued"
                job.batch_leader = None
                job.sup = None
                job._batch_progress = None   # rolled back: stale
                cls.members.pop(mname, None)
                fleet.journal("sdc", job=mname,
                              update=rec.get("update"),
                              last_verified_update=rec.get(
                                  "last_verified_update"),
                              quarantined=rec.get("quarantined"),
                              serve_leader=cls.leader.name)
                fleet.journal("requeued", job=mname, reason="serve_sdc")
                # the breaker counts sdc like any crash class: a sick
                # device demoting tenant after tenant pauses admissions
                fleet.note_external_failure("sdc", cls.leader)
                try:
                    cls.write_control()   # the ack: child forgets it
                except OSError:
                    cls.dirty = True
            elif st == "rejected":
                # static mismatch the host screen missed: back to the
                # queue as an ordinary solo run, loudly
                job.state = "queued"
                job.batch_leader = None
                job._serve_sig = None
                job._batch_key = None
                job.spec = dict(self.fleet._load_spec(job) or {})
                job.spec.pop("batch", None)
                # persist the strip: the on-disk spec still says
                # batch:true, and a restarted orchestrator re-reading
                # it would replay the whole place/reject/requeue round
                # on every boot for as long as the rejection holds
                try:
                    tmp = f"{job.spec_path}.tmp.{os.getpid()}"
                    with open(tmp, "w") as f:
                        json.dump(job.spec, f, indent=1)
                        f.write("\n")
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, job.spec_path)
                except OSError:
                    pass            # worst case: one wasted round
                cls.members.pop(mname, None)
                fleet.journal("batch_fallback", job=mname,
                              reason="serve child rejected: "
                                     + str(rec.get("reason")))
                fleet.journal("requeued", job=mname,
                              reason="serve_rejected")
                try:
                    cls.write_control()
                except OSError:
                    cls.dirty = True

    # ---- observability ----

    def gauges(self) -> list:
        members = sum(len(c.members) for c in self.classes.values())
        ghosts = sum(c.width - len(c.members)
                     for c in self.classes.values()
                     if c.leader.state == "running")
        return [
            ("avida_fleet_serve_classes", "gauge",
             "warm serve classes (one child each)", len(self.classes)),
            ("avida_fleet_serve_members", "gauge",
             "tenants riding serve classes", members),
            ("avida_fleet_serve_ghost_slots", "gauge",
             "free ghost slots across running classes (instant "
             "admission capacity)", ghosts),
            ("avida_fleet_serve_promotions_total", "counter",
             "tenants promoted into serve classes", self.promotions),
            ("avida_fleet_serve_demotions_total", "counter",
             "tenants demoted out of serve classes", self.demotions),
            ("avida_fleet_serve_cache_hits_total", "counter",
             "arrivals placed into an already-warm class",
             self.cache_hits),
            ("avida_fleet_serve_cache_misses_total", "counter",
             "arrivals that had to spawn a cold class child",
             self.cache_misses),
        ]
