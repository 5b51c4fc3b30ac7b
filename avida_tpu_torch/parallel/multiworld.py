"""Multi-world batching: W worlds advanced together on one device.

Counterpart of avida_tpu/parallel/multiworld.py (`multiworld_scan`,
`MultiWorld`).  W worlds with the same static configuration (equal
WorldParams) but their own seeds are stacked on a leading axis of every
PopulationState leaf and advanced in chunks by
ops/update.update_scan_batched: the cheap phases run world by world, and
every update's cycles run once for the batch -- ONE kernel launch over all
worlds' planes (cycles.run_packed_stacked), on the packed-resident engine
(TPU_SYSTEMATICS=0) and on the per-update engine (the default), or, off
the kernel route (TPU_USE_PALLAS=2 and what the kernel gate refuses), the
micro-step engine over the worlds' organisms folded onto one axis
(update.mw_fold_cycles_xla).

Contract: world k of a batch IS the solo run with seed k.
  * each world's update keys stay fold_in(run_key_w, update_no);
  * the batch plans its chunks with the members' own planner
    (World._plan_stretch), so events, drains and prunes land at the
    updates of each member's solo run;
  * the host accumulators (avida time, births, deaths, average
    generation) become [W] vectors updated by the same per-chunk
    reductions, each world's float32 sums in the solo order.

The phylogeny: each member's newborn ring is drained into its own
GenotypeArbiter at every chunk boundary (the solo run defers the drain by
one stretch; both record the same genotypes).

Persistence: checkpoints are saved PER WORLD, each member's state sliced
back into its World and written by the ordinary World.save_checkpoint
into its own TPU_CKPT_DIR -- byte-identical to the generation its solo
run writes at the same boundary, so a member resumes solo (or in either
package) and the reverse.  resume() re-aligns the members on the newest
update every one of them retains.  The integrity plane runs batched:
[W] digests at every chunk boundary and a whole-batch shadow replay on
every TPU_SCRUB_EVERY-th chunk.  TPU_METRICS publishes the batch
heartbeat through MultiWorldExporter (metrics.prom + multiworld.prom);
TPU_PROFILE attributes the batch's chunks.  A member with a flight
recorder or a fault plan is refused, as in the reference.

ServeBatch is the streaming serve layer's batch (`--serve-worlds`): a
fixed padded width whose slots hold live tenants or inert all-dead ghost
worlds, with membership reconciled from a control file at checkpoint
boundaries and each tenant at its own update (the per-world u0 of
update_scan_batched), so a tenant's run is its solo run bit for bit.

Not ported here, raised by name: TPU_KERNEL_SHARDS > 1, and batch
members with resource pools, demes or experimental hardware
(unported_batch_reason).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from avida_tpu_torch.core.state import (clone_state, stack_states,
                                        world_state)
from avida_tpu_torch.ops import cycles
from avida_tpu_torch.ops import resources as res_ops
from avida_tpu_torch.ops.update import update_scan_batched
from avida_tpu_torch.utils import compilecache, integrity, prng
from avida_tpu_torch.world import World


def multiworld_scan(params, bstate, chunk, run_keys, u0, neighbors=None):
    """Advance W stacked worlds by `chunk` updates: update_scan_batched
    on their shared neighbor table.  Returns the batched state and the
    seven per-update vectors (executed, births, deaths, dt, ave_gen,
    n_alive, trips), each [W, chunk]."""
    return update_scan_batched(params, bstate, chunk, run_keys, u0,
                               neighbors)


def unported_batch_reason(params) -> str | None:
    """Why worlds of this static configuration cannot share a batch in
    the port (MultiWorld and ServeBatch alike); None when they can."""
    if int(params.kernel_shards) > 1:
        return (f"TPU_KERNEL_SHARDS={params.kernel_shards}: one "
                f"launch per card (K2 with S > 1) is not ported to "
                f"avida_tpu_torch yet")
    if res_ops.has_pools(params) or params.num_demes > 1:
        return ("batch members with resource pools or demes: the batched "
                "engines carry no per-world pools or deme state "
                "(ROADMAP.md Queue 1 item 14); run each world solo")
    if params.hw_type == 3:
        return ("batch members on experimental spatial hardware: the "
                "folded organism axis would carry facing rays and moves "
                "across world borders (ROADMAP.md Queue 1 item 14); run "
                "each world solo")
    return None


def _event_key(ev):
    return (ev.trigger, ev.start, ev.interval, ev.stop, ev.action,
            tuple(ev.args))


def _close_files(w):
    for f in w._files.values():
        try:
            f.close()
        except OSError as e:
            print(f"[avida_tpu_torch] warning: closing {f.path}: {e}",
                  file=sys.stderr)
    w._files = {}


def _own(w):
    """A synced member's state and accumulators as tensors of its own:
    after _sync_worlds they are views of the batch, which would pin the
    whole batch's storage once the member leaves it."""
    if w.state is not None:
        w.state = clone_state(w.state)
    for name in ("_avida_time", "_last_ave_gen", "_deaths_this",
                 "_prev_alive", "_total_births"):
        v = getattr(w, name)
        if isinstance(v, torch.Tensor):
            setattr(w, name, v.clone())


class MultiWorld:
    """Runs one batch of static-equal worlds (see the module
    docstring).  Build it from fully constructed Worlds (own seeds, own
    data dirs, one device) or with `from_seeds` / `from_manifest`."""

    def __init__(self, worlds, data_dir: str | None = None):
        if not worlds:
            raise ValueError("MultiWorld needs at least one world")
        self.worlds = list(worlds)
        w0 = self.worlds[0]
        self.params = w0.params
        self.cfg = w0.cfg
        self.device = w0.device
        ev0 = [_event_key(e) for e in w0.events]
        for w in self.worlds[1:]:
            if w.params != w0.params:
                raise ValueError(
                    "multi-world batch needs identical static configs "
                    "(WorldParams differ; only seeds and output dirs may "
                    "vary across a batch)")
            if not torch.equal(w.neighbors, w0.neighbors):
                raise ValueError(
                    "multi-world batch needs one shared world topology "
                    "(neighbor tables differ -- scale-free geometries "
                    "draw per-seed graphs and cannot batch)")
            if [_event_key(e) for e in w.events] != ev0:
                raise ValueError("multi-world batch needs one shared "
                                 "event schedule")
            if w.device != w0.device:
                raise ValueError(
                    f"multi-world batch needs one device (members on "
                    f"{w0.device} and {w.device})")
        for w in self.worlds:
            if not w._chunkable():
                raise ValueError(
                    "multi-world batching requires chunkable runs: no "
                    "telemetry, no offspring reversion tests, no "
                    "generation/births event triggers")
            if w.tracer is not None or w.analytics is not None \
                    or w.faults is not None:
                raise ValueError(
                    "multi-world batching does not slice the flight "
                    "recorder, live analytics or fault-injection host "
                    "pipelines; run those workloads solo")
        if len({id(w.cfg) for w in self.worlds}) != len(self.worlds) \
                and len(self.worlds) > 1:
            raise ValueError("each batch member needs its own config "
                             "object (distinct seeds / dirs)")
        self.update = w0.update
        if any(w.update != self.update for w in self.worlds):
            raise ValueError("batch members disagree on the current "
                             "update; resume() aligns them first")
        dirs = [os.path.abspath(w.data_dir) for w in self.worlds]
        if len(set(dirs)) != len(dirs):
            raise ValueError("batch members share a data_dir; each "
                             "world needs its own .dat output dir")
        self._ckpt_on = all(w._ckpt_base() for w in self.worlds)
        if self._ckpt_on:
            cks = [os.path.abspath(w._ckpt_base()) for w in self.worlds]
            if len(set(cks)) != len(cks):
                raise ValueError(
                    "batch members share a checkpoint dir; give each "
                    "world its own TPU_CKPT_DIR (the --worlds CLI and "
                    "from_seeds do this per world)")
        reason = unported_batch_reason(self.params)
        if reason is not None:
            raise NotImplementedError(reason)
        self._exit = False
        self._preempt = False
        self.preempted = False
        self.bstate = None
        self._run_keys = None
        self._avida_time = None
        self._last_ave_gen = None
        self._deaths_this = None
        self._prev_alive = None
        self._total_births = None
        # batch-lifetime occupancy (float32): per-world trip totals, the
        # per-update batch-max total and the updates they cover;
        # trip_efficiency() = sum(trips) / (W * leader)
        self._trips = None
        self._leader_trips = None
        self._trips_updates = 0
        self.engine = None             # "packed-stacked" | "per-update"
        self.engine_report = None
        self.names = [f"w{k:03d}" for k in range(len(self.worlds))]
        # the integrity plane, batched (the solo World's knobs)
        self.data_dir = data_dir or w0.data_dir
        self._digest_on = integrity.digest_enabled(self.cfg)
        self._scrub_every = integrity.scrub_every(self.cfg)
        self._chunk_no = 0
        self._digest_pending = None    # (update, device [W]) deferred
        self.state_digests = None      # (update, [W] values) last resolved
        self._last_verified_update = self.update
        # the batch heartbeat (TPU_METRICS): metrics.prom with the batch's
        # aggregates and multiworld.prom with a row per world
        # (observability/exporter.MultiWorldExporter)
        self.exporter = None
        if int(self.cfg.get("TPU_METRICS", 0)):
            from avida_tpu_torch.observability.exporter import \
                MultiWorldExporter
            self.exporter = MultiWorldExporter(self)
        # the performance attribution plane (observability/profiler.py)
        self.profiler = None
        from avida_tpu_torch.observability import profiler as _profiler
        if _profiler.enabled(self.cfg):
            self.profiler = _profiler.ChunkProfiler(
                self.data_dir, self.cfg, kind="multiworld",
                device=self.device)

    # ---- construction helpers ----

    @classmethod
    def from_seeds(cls, seeds, config_dir: str | None = None,
                   overrides=None, data_dir: str = "data",
                   ckpt_dir: str | None = None,
                   device=None) -> "MultiWorld":
        """One world per seed, static config shared.  World k writes its
        .dat files to `<data_dir>/<name_k>` (names default w000, w001,
        ...) and, when `ckpt_dir` (or a TPU_CKPT_DIR override) is given,
        checkpoints to `<ckpt_dir>/<name_k>`."""
        overrides = list(overrides or [])
        if ckpt_dir is None:
            for n, v in overrides:
                if n == "TPU_CKPT_DIR" and str(v) not in ("-", ""):
                    ckpt_dir = str(v)
        base = [(n, v) for n, v in overrides
                if n not in ("RANDOM_SEED", "TPU_CKPT_DIR")]
        entries = [{"name": f"w{k:03d}", "seed": int(seed),
                    "data_dir": os.path.join(data_dir, f"w{k:03d}"),
                    "ckpt_dir": (os.path.join(ckpt_dir, f"w{k:03d}")
                                 if ckpt_dir else None)}
                   for k, seed in enumerate(seeds)]
        return cls._from_entries(entries, config_dir, base, device,
                                 data_dir)

    @classmethod
    def from_manifest(cls, path: str, config_dir: str | None = None,
                      overrides=None, device=None) -> "MultiWorld":
        """Batch from a worlds.json manifest: a list of {"name", "seed",
        "data_dir", "ckpt_dir"} entries ("ckpt_dir" optional)."""
        try:
            with open(path) as f:
                entries = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: unreadable worlds manifest ({e})")
        if not isinstance(entries, list) or not entries:
            raise ValueError(f"{path}: worlds manifest must be a "
                             f"non-empty JSON list")
        for k, e in enumerate(entries):
            if not isinstance(e, dict) or not str(e.get("data_dir", "")):
                raise ValueError(f"{path}: entry {k} must be an object "
                                 f"with at least 'seed' and 'data_dir'")
            try:
                int(e["seed"])
            except (KeyError, TypeError, ValueError):
                raise ValueError(f"{path}: entry {k} needs an integer "
                                 f"'seed'")
        base = [(n, v) for n, v in (overrides or [])
                if n not in ("RANDOM_SEED", "TPU_CKPT_DIR")]
        return cls._from_entries(entries, config_dir, base, device,
                                 os.path.dirname(path))

    @classmethod
    def _from_entries(cls, entries, config_dir, base_overrides, device=None,
                      data_dir=None):
        worlds = []
        for e in entries:
            ov = list(base_overrides) + [("RANDOM_SEED", int(e["seed"]))]
            if e.get("ckpt_dir"):
                ov.append(("TPU_CKPT_DIR", e["ckpt_dir"]))
            worlds.append(World(config_dir=config_dir, overrides=ov,
                                data_dir=e["data_dir"], device=device))
        mw = cls(worlds, data_dir=data_dir)
        mw.names = [str(e.get("name", f"w{k:03d}"))
                    for k, e in enumerate(entries)]
        return mw

    # ---- batched <-> per-world state ----

    def _stack(self):
        """Stack the member states and host accumulators onto the world
        axis; members drop their state until the next _sync_worlds."""
        if self.bstate is not None:
            return
        dev = self.device
        self.bstate = stack_states([w.state for w in self.worlds])
        self._run_keys = torch.stack([w._run_key for w in self.worlds])

        def vec(name, dtype):
            return torch.stack([torch.as_tensor(getattr(w, name), dtype=dtype,
                                                device=dev)
                                for w in self.worlds])

        self._avida_time = vec("_avida_time", torch.float32)
        self._last_ave_gen = vec("_last_ave_gen", torch.float32)
        self._deaths_this = vec("_deaths_this", torch.int32)
        self._prev_alive = (None if any(w._prev_alive is None
                                        for w in self.worlds)
                            else vec("_prev_alive", torch.int32))
        self._total_births = vec("_total_births", torch.int64)
        for w in self.worlds:
            w.state = None

    def _sync_worlds(self):
        """Hand each member its slice of the batched state and of the
        accumulators (a host boundary: events, run exit)."""
        if self.bstate is None:
            return
        for i, w in enumerate(self.worlds):
            w.state = world_state(self.bstate, i)
            w.update = self.update
            w._avida_time = self._avida_time[i]
            w._last_ave_gen = self._last_ave_gen[i]
            w._deaths_this = self._deaths_this[i]
            w._prev_alive = (None if self._prev_alive is None
                             else self._prev_alive[i])
            w._total_births = self._total_births[i]
            w._summary_cache_update = None
        self.bstate = None

    # ---- the batched run loop (World.run's chunk grid) ----

    def _scan(self, k: int):
        """One batched chunk of k updates, with World._scan_updates'
        accumulator updates per world (each world's avida-time increment
        summed in the solo order) and its integrity boundary."""
        pre = None
        # the library through the program cache, journaled in the lead
        # member's run log (World._load_kernel)
        self.worlds[0]._load_kernel()
        if self.profiler is not None:
            self.profiler.chunk_begin(k)
        if self._scrub_every > 0:
            self._chunk_no += 1
            if self._chunk_no % self._scrub_every == 0:
                pre = (clone_state(self.bstate), self.update)
        self.bstate, (executed, births, deaths, dts, ave_gens, n_alive,
                      trips) = multiworld_scan(
            self.params, self.bstate, k, self._run_keys, self.update,
            self.worlds[0].neighbors)
        self._avida_time = self._avida_time + torch.stack(
            [prng.xla_f32_sum(row) for row in dts])
        self._last_ave_gen = ave_gens[:, -1]
        self._deaths_this = deaths[:, -1]
        self._prev_alive = n_alive[:, -1]
        self._total_births = self._total_births + births.sum(dim=1)
        self._trips = self._trips + trips.sum(dim=1).to(torch.float32)
        self._leader_trips = (self._leader_trips
                              + trips.max(dim=0).values.sum().to(
                                  torch.float32))
        self._trips_updates += k
        for i, w in enumerate(self.worlds):
            w._pending_exec.append(executed[i])
        self.update += k
        for w in self.worlds:
            w.update = self.update
        if self.profiler is not None:
            self.profiler.chunk_end_batched(self, k, names=self.names)
        if self._digest_on or pre is not None:
            self._integrity_boundary(k, pre)

    # ---- the integrity plane, batched ----

    def _resolve_digests(self, pending):
        import time as _time
        u, dev = pending
        t0 = _time.monotonic()
        vals = [int(x) for x in dev.tolist()]
        integrity.note_digest_ms((_time.monotonic() - t0) * 1e3)
        self.state_digests = (u, vals)
        integrity.append_integrity_record(
            self.data_dir, "digest", update=u,
            digests={n: f"{v:#010x}" for n, v in zip(self.names, vals)})

    def _flush_digest(self):
        prev, self._digest_pending = self._digest_pending, None
        if prev is not None:
            self._resolve_digests(prev)

    def _integrity_boundary(self, k: int, pre):
        """World._integrity_boundary over the batch: [W] digests (each
        equal to its member's solo digest), and on a sampled chunk a
        whole-batch shadow replay whose mismatching worlds are named."""
        import time as _time

        from avida_tpu_torch.ops.digest import state_digest_batched
        u1 = self.update
        t0 = _time.monotonic()
        d_live = state_digest_batched(self.bstate)
        integrity.note_digest_ms((_time.monotonic() - t0) * 1e3)
        self._flush_digest()
        if pre is None:
            self._digest_pending = (u1, d_live)
            return
        pre_b, u0 = pre
        integrity.note_scrub()
        shadow_b, _ = multiworld_scan(self.params, pre_b, k, self._run_keys,
                                      u0, self.worlds[0].neighbors)
        t0 = _time.monotonic()
        live = d_live.tolist()
        shad = state_digest_batched(shadow_b).tolist()
        integrity.note_digest_ms((_time.monotonic() - t0) * 1e3)
        bad = [self.names[i] for i in range(len(self.worlds))
               if live[i] != shad[i]]
        if bad:
            integrity.note_mismatch()
            integrity.append_integrity_record(
                self.data_dir, "scrub", update=u1, chunk_updates=k,
                ok=False, worlds=bad, engine=self.engine,
                last_verified_update=self._last_verified_update)
            from avida_tpu_torch.observability.runlog import emit_event
            emit_event(self.worlds[0], "state_divergence", update=u1,
                       worlds=",".join(bad))
            raise integrity.StateDivergenceError(
                f"silent state divergence in updates [{u0}, {u1}) of "
                f"world(s) {', '.join(bad)}: live digests != shadow "
                f"replay (engine {self.engine}, "
                f"last_verified_update={self._last_verified_update})")
        self._last_verified_update = u1
        if self._digest_on:
            self.state_digests = (u1, live)
            integrity.append_integrity_record(
                self.data_dir, "digest", update=u1,
                digests={n: f"{v:#010x}" for n, v in zip(self.names, live)})
        integrity.append_integrity_record(
            self.data_dir, "scrub", update=u1, chunk_updates=k, ok=True)

    def trip_efficiency(self) -> float:
        """sum over worlds of their own trip counts / (W x the batch
        leader's), over the batch's life: 1.0 when every world wants the
        leader's cycles each update."""
        if self._trips is None or float(self._leader_trips) == 0.0:
            return 1.0
        return float(self._trips.sum()) / (len(self.worlds)
                                           * float(self._leader_trips))

    def _events_due(self) -> bool:
        for ev in self.worlds[0].events:
            if ev.trigger == "update" and ev.fires_at(self.update):
                return True
            if ev.trigger == "immediate" and self.update == 0:
                return True
        return False

    def _drain_newborns(self, at: int):
        """Feed each member's GenotypeArbiter from its slice of the
        batched newborn ring, synchronously at every chunk boundary.  `at`
        stamps the window: the post-chunk update for a stretch, the update
        just run for a single update (as the solo run stamps them)."""
        if self.worlds[0].systematics is None:
            return
        for i, w in enumerate(self.worlds):
            snap = {name: getattr(self.bstate, name)[i]
                    for name in World._NB_SNAP_FIELDS}
            snap["update_at"] = at
            snap["win_start"] = w._last_drain_update
            w._last_drain_update = at
            w._feed_systematics(snap)
        self.bstate = self.bstate.replace(
            nb_count=torch.zeros_like(self.bstate.nb_count))

    def _report_engine(self):
        """Record which engine the batch's chunks take (packed_chunk's
        engine_report vocabulary); returns the fallback reason, None on
        the stacked packed-resident engine."""
        from avida_tpu_torch.ops import packed_chunk
        rep = packed_chunk.engine_report(self.params, self.params.nb_cap > 0)
        reason = rep.get("fallback_reason")
        self.engine = "packed-stacked" if reason is None else "per-update"
        self.engine_report = rep
        return reason

    # the solo handler (the same `_preempt` contract, the second-SIGINT
    # escalation and the off-main-thread guard)
    _install_preempt_handlers = World._install_preempt_handlers

    def save_checkpoints(self):
        """One ordinary per-world generation each, into each member's own
        TPU_CKPT_DIR -- byte-identical to the generation its solo run
        writes at this boundary."""
        self._sync_worlds()
        for w in self.worlds:
            w.save_checkpoint()
            if self._world_exports(w):
                # a member's own heartbeat, refreshed at its save
                w.exporter.export(w)

    def _world_exports(self, w) -> bool:
        """Does member `w` publish its own metrics.prom?  Not when that
        path is the batch aggregate's."""
        if w.exporter is None:
            return False
        return (self.exporter is None
                or os.path.abspath(w.exporter.path)
                != os.path.abspath(self.exporter.path))

    def resume(self, at_update: int | None = None) -> int:
        """Restore every member from its own checkpoint dir, aligned on
        the newest update for which EVERY member retains a generation; a
        generation that fails verification drops that update and the
        next-newest common one is tried.  Returns the aligned update."""
        from avida_tpu_torch.utils import checkpoint as ckpt_mod
        if at_update is None:
            sets = []
            for w in self.worlds:
                ups = {ckpt_mod.generation_update(p)
                       for p in ckpt_mod.restore_candidates(
                           w._ckpt_base())}
                sets.append({u for u in ups if u >= 0})
            common = set.intersection(*sets) if sets else set()
            if not common:
                raise ckpt_mod.CheckpointError(
                    "no checkpoint update common to every batch member "
                    "(mixed progress resumes aligned or not at all)")
            candidates = sorted(common, reverse=True)
        else:
            candidates = [int(at_update)]
        last_err = None
        for u in candidates:
            try:
                for w in self.worlds:
                    w.resume(at_update=u)
            except ckpt_mod.CheckpointMismatchError:
                raise
            except ckpt_mod.CheckpointError as e:
                last_err = e
                continue
            self.bstate = None
            self.update = u
            self._last_verified_update = u
            return u
        raise last_err or ckpt_mod.CheckpointError("batch resume failed")

    def run(self, max_updates: int | None = None) -> int:
        """The batched master loop: World.run's structure with the device
        work stacked over the world axis; host boundaries -- events,
        drains, audits, auto-saves, preemption -- at the updates each
        member's solo run has them.  Returns the instructions executed
        across the batch by this call."""
        for w in self.worlds:
            if w.state is None:
                w.process_events()
                if w.state is None:
                    w.inject()
        start_insts = sum(w._cum_insts for w in self.worlds)
        ckpt_every = int(self.cfg.get("TPU_CKPT_EVERY", 0))
        audit_every = int(self.cfg.get("TPU_AUDIT_EVERY", 0))
        max_stretch = int(self.cfg.get("TPU_MAX_STRETCH", 0))
        self.preempted = False
        self._preempt = False
        for w in self.worlds:
            w.preempted = False
            w._preempt = False
        if self._trips is None:
            self._trips = torch.zeros(len(self.worlds), dtype=torch.float32,
                                      device=self.device)
            self._leader_trips = torch.zeros((), dtype=torch.float32,
                                             device=self.device)
        self._report_engine()
        handlers = self._install_preempt_handlers() if self._ckpt_on else {}
        last_ckpt = self.update
        last_audit = self.update
        sysm_on = self.worlds[0].systematics is not None
        try:
            self._stack()
            while not self._exit and not self._preempt:
                if max_updates is not None and self.update >= max_updates:
                    break
                if self._events_due():
                    self._sync_worlds()
                    for w in self.worlds:
                        w.process_events()
                    if any(w._exit for w in self.worlds):
                        self._exit = True
                        break
                    self._stack()
                else:
                    # the solo loop's idempotent process_events only moves
                    # this cursor when nothing is due
                    for w in self.worlds:
                        w._events_done_for = self.update
                stretch = self.worlds[0]._plan_stretch(max_updates,
                                                       max_stretch)
                self._scan(stretch)
                if sysm_on:
                    self._drain_newborns(self.update if stretch > 1
                                         else self.update - 1)
                for w in self.worlds:
                    if len(w._pending_exec) >= 256:
                        w._flush_exec()
                if sysm_on and self.update % 100 == 0:
                    for w in self.worlds:
                        w.systematics.prune_extinct(keep_ancestry=True)
                if self.exporter is not None:
                    self.exporter.export_deferred(self)
                audit_due = (audit_every
                             and self.update - last_audit >= audit_every)
                ckpt_due = (self._ckpt_on and ckpt_every
                            and self.update - last_ckpt >= ckpt_every)
                if audit_due or ckpt_due:
                    # one sync and one restack when both are due
                    self._sync_worlds()
                    if audit_due:
                        from avida_tpu_torch.utils.audit import \
                            check_invariants
                        for w in self.worlds:
                            check_invariants(self.params, w.state,
                                             where=f"update {self.update}")
                        last_audit = self.update
                    if ckpt_due:
                        self.save_checkpoints()
                        last_ckpt = self.update
                    self._stack()
            self._sync_worlds()
            self._flush_digest()
            self.preempted = self._preempt
            if self._preempt and self._ckpt_on:
                for w in self.worlds:
                    w.save_checkpoint()
            elif self._ckpt_on and int(self.cfg.get("TPU_CKPT_FINAL", 0)) \
                    and self.update != last_ckpt:
                for w in self.worlds:
                    w.save_checkpoint()
            for w in self.worlds:
                w.preempted = self._preempt
                if self._world_exports(w) and w.state is not None:
                    w.exporter.export(w)
            if self.exporter is not None:
                self.exporter.export_final(self)
        finally:
            import signal as _signal
            for sig, h in handlers.items():
                try:
                    _signal.signal(sig, h)
                except (ValueError, OSError):
                    pass
            for w in self.worlds:
                _close_files(w)
                w._dat_append = True
        return sum(w._flush_exec() for w in self.worlds) - start_insts

    @property
    def num_worlds(self) -> int:
        return len(self.worlds)


# ---------------------------------------------------------------------------
# ServeBatch: ghost-padded dynamic membership (the streaming serve layer)
# ---------------------------------------------------------------------------

def pow2_floor(n: int) -> int:
    """Largest power of two <= max(n, 1) -- the serve loop's chunk
    quantizer (the reference's, which bounds its compiled scan variants;
    the port keeps it so a tenant's chunk grid, and with it every host
    boundary, is the reference's)."""
    return 1 << (max(int(n), 1).bit_length() - 1)


class ServeBatch:
    """A fixed-width, dynamic-membership serving batch (`--serve-worlds`;
    the reference's ServeBatch).

    Where MultiWorld freezes membership at construction and requires
    every member at the same update, ServeBatch is built at a fixed
    padded width W (a power-of-two class of service/serve.width_class)
    and serves a churning population of tenants: slots hold either a
    live tenant World or an inert GHOST -- an all-dead copy of the
    template state.  A dead lane gets no cycle grant, so a ghost runs
    zero trips and no births, and every phase of the batched update is
    world-local: a ghost cannot perturb a live world by a single bit.
    Each update launches the stacked kernel (K3b) once for all W slots on
    the kernel route.

    Per-world update counters (the u0 vector of update_scan_batched) let
    tenants ride at different points of their runs: each world's update
    keys stay fold_in(run_key_w, own update) and its event grid stays
    its solo grid, so every tenant's trajectory is its uninterrupted
    solo run's bit for bit.  (The host float32 `_avida_time` can differ
    in its last bits from a solo run when the chunk split differs -- the
    reference's cross-chunking caveat; device state, keys, .dat values
    and integer counters are exact.)

    Membership protocol (the fleet's serve pool drives it; a human can
    too): `control_path` is an atomically rewritten JSON document

        {"width": W, "shutdown": false,
         "members": [{"name", "seed", "data_dir", "ckpt_dir",
                      "max_updates"}, ...]}

    reconciled at every checkpoint boundary: members in the control and
    not in a slot are ADMITTED (resumed from their own ckpt_dir when it
    holds generations, else injected fresh); live slots absent from the
    control are RETIRED (final checkpoint, .dat files closed, slot back
    to ghost).  A member reaching its max_updates (or an Exit event)
    retires as "done".  The batch reports through DATA_DIR/serve.json
    (atomic) and, with TPU_METRICS, metrics.prom / multiworld.prom
    (exporter.ServeExporter), and keeps serving -- idle with zero
    tenants it sleeps on the host until TPU_SERVE_IDLE_SEC expires or
    the control sets "shutdown": true.

    SIGTERM preempts as a solo run does: every live tenant saves a final
    checkpoint and the process exits cleanly for the supervisor to
    relaunch."""

    def __init__(self, width: int, control_path: str, data_dir: str,
                 config_dir: str | None = None, overrides=None,
                 world_factory=None, clock=time.time, sleep=time.sleep,
                 device=None):
        if width < 1:
            raise ValueError("ServeBatch width must be >= 1")
        self.width = int(width)
        self.control_path = control_path
        self.data_dir = data_dir
        self._config_dir = config_dir
        self._overrides = list(overrides or [])
        self._device = device
        self._factory = world_factory or self._config_factory
        self._clock = clock
        self._sleep = sleep

        # the template/ghost world: the static config of every member
        # (its seed is irrelevant -- a ghost never executes), its state
        # turned all-dead
        gw = self._factory({"name": "__ghost__", "seed": 0,
                            "data_dir": os.path.join(data_dir, ".ghost"),
                            "ckpt_dir": None})
        if gw.tracer is not None or gw.analytics is not None \
                or gw.faults is not None or not gw._chunkable():
            raise ValueError(
                "serve batches need chunkable configs with no flight "
                "recorder, live analytics or fault injection (the same "
                "rules as --worlds; run those workloads solo)")
        reason = unported_batch_reason(gw.params)
        if reason is not None:
            raise NotImplementedError(reason)
        gw.process_events()
        if gw.state is None:
            gw.inject()
        self.params = gw.params
        self.neighbors = gw.neighbors
        self.cfg = gw.cfg
        self.device = gw.device
        # owned leaves: the template is stacked into every ghost slot and
        # must stay the same from one restack to the next
        self._ghost_state = clone_state(gw.state.replace(
            alive=torch.zeros_like(gw.state.alive)))
        self._ghost_key = gw._run_key.clone()
        gw.state = None
        _close_files(gw)
        self._ghost_events = [_event_key(e) for e in gw.events]

        self.slots: list = [None] * self.width
        self.names: list = [None] * self.width
        self.max_updates: list = [None] * self.width
        self.finished: dict = {}        # name -> {"state", "update", ...}
        self.bstate = None
        self._run_keys = None
        self._avida_time = None
        self._last_ave_gen = None
        self._deaths_this = None
        self._prev_alive = None
        self._total_births = None
        self._trips = torch.zeros(self.width, dtype=torch.float32,
                                  device=self.device)
        self._leader_trips = torch.zeros((), dtype=torch.float32,
                                         device=self.device)
        self._trips_updates = 0
        self.admissions = 0
        self.retirements = 0
        self.boundaries = 0
        self._exit = False
        self._preempt = False
        self.preempted = False
        self._shutdown = False
        self._boundary_hook = None      # test seam: after each
        #                                 checkpoint-boundary reconcile
        self._sysm_on = bool(int(self.cfg.get("TPU_SYSTEMATICS", 1)))
        # the integrity plane, serve flavor: per-world digests and a
        # sampled whole-batch shadow replay, but a mismatching TENANT is
        # demoted ALONE (suspect generations quarantined, slot back to
        # ghost, outcome "sdc" for the pool to requeue) while classmates
        # keep serving -- only a diverging GHOST slot (a zero-trip
        # identity that cannot legitimately change) escalates to a
        # batch-wide StateDivergenceError
        self._digest_on = integrity.digest_enabled(self.cfg)
        self._scrub_every = integrity.scrub_every(self.cfg)
        self._chunk_no = 0
        self._verified = [0] * self.width   # per-slot verified horizon
        self.state_digests = None           # (boundary, [W] values)
        self.exporter = None
        if int(self.cfg.get("TPU_METRICS", 0)):
            from avida_tpu_torch.observability.exporter import ServeExporter
            self.exporter = ServeExporter(self)
        # the performance attribution plane, serve flavor: the batched
        # probe and the per-slot footprint, ghost overhead included
        self.profiler = None
        from avida_tpu_torch.observability import profiler as _profiler
        if _profiler.enabled(self.cfg):
            self.profiler = _profiler.ChunkProfiler(
                self.data_dir, self.cfg, kind="serve", device=self.device)

    # the solo preemption contract verbatim (shared spelling)
    _install_preempt_handlers = World._install_preempt_handlers

    def request_stop(self):
        self._exit = True

    # ---- membership ----

    def _config_factory(self, entry):
        ov = [(n, v) for n, v in self._overrides
              if n not in ("RANDOM_SEED", "TPU_CKPT_DIR")]
        ov.append(("RANDOM_SEED", int(entry["seed"])))
        if entry.get("ckpt_dir"):
            ov.append(("TPU_CKPT_DIR", entry["ckpt_dir"]))
        return World(config_dir=self._config_dir, overrides=ov,
                     data_dir=entry["data_dir"], device=self._device)

    def _live(self) -> list:
        return [(i, w) for i, w in enumerate(self.slots) if w is not None]

    def _member_exports(self, w) -> bool:
        """A member writes its own metrics.prom unless its data dir IS
        the batch root's (the MultiWorld._world_exports rule)."""
        return (w.exporter is not None
                and os.path.abspath(w.data_dir)
                != os.path.abspath(self.data_dir))

    @property
    def num_live(self) -> int:
        return sum(1 for w in self.slots if w is not None)

    @property
    def num_ghosts(self) -> int:
        return self.width - self.num_live

    def _log(self, msg: str):
        print(f"[serve] {msg}", file=sys.stderr)

    def _compile_cache_log(self, **fields):
        """compile_cache journal shim for the serve child's library load
        (stderr through runlog.emit_event: no member owns the batch-wide
        library, so no telemetry writer)."""
        from avida_tpu_torch.observability.runlog import emit_event
        emit_event(None, "compile_cache", **fields)

    def _read_control(self):
        try:
            with open(self.control_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None                 # absent/torn: keep serving as-is

    def admit(self, entry) -> bool:
        """Place one tenant into a free ghost slot (requires a synced
        batch).  Resumes from the entry's own checkpoint dir when
        generations exist, else starts fresh.  Returns True when the
        tenant occupies a slot (False: rejected or already finished,
        recorded in `finished` for the status file)."""
        from avida_tpu_torch.utils.checkpoint import (CheckpointError,
                                                      restore_candidates)
        name = str(entry["name"])
        free = [i for i, w in enumerate(self.slots) if w is None]
        if not free:
            self.finished[name] = {"state": "rejected",
                                   "reason": "no free slot"}
            return False
        try:
            w = self._factory(entry)
        except (ValueError, OSError, NotImplementedError) as e:
            self.finished[name] = {"state": "rejected", "reason": str(e)}
            return False
        reason = self._ineligible(w)
        if reason is not None:
            self.finished[name] = {"state": "rejected", "reason": reason}
            _close_files(w)
            return False
        if w._ckpt_base() and restore_candidates(w._ckpt_base()):
            try:
                w.resume()
            except CheckpointError as e:
                self.finished[name] = {"state": "rejected",
                                       "reason": f"resume failed: {e}"}
                return False
        else:
            w.process_events()
            if w.state is None:
                w.inject()
        cap = entry.get("max_updates")
        cap = None if cap is None else int(cap)
        if cap is not None and w.update >= cap:
            # already complete (e.g. readmitted after a crash that
            # outran the done ack): report done without a slot
            self.finished[name] = {"state": "done", "update": w.update,
                                   "insts": w._cum_insts}
            return False
        i = free[0]
        self.slots[i] = w
        self.names[i] = name
        self.max_updates[i] = cap
        # the admitted state is digest-verified (resume re-checks the
        # manifest digest) or freshly injected: the slot's scrub
        # verification horizon starts here
        self._verified[i] = w.update
        self.finished.pop(name, None)
        self.admissions += 1
        self._log(f"admit {name} -> slot {i} at update {w.update}"
                  + (f" (budget {cap})" if cap is not None else ""))
        return True

    def _ineligible(self, w) -> str | None:
        """Why a candidate World cannot join this batch (None = it
        can): MultiWorld's static-equality rules, per slot."""
        if w.params != self.params:
            return ("static config differs from the batch class "
                    "(WorldParams mismatch)")
        if w.device != self.device:
            return (f"world on {w.device}, the batch class on "
                    f"{self.device}")
        if not torch.equal(w.neighbors, self.neighbors):
            return "world topology differs from the batch class"
        if [_event_key(e) for e in w.events] != self._ghost_events:
            return "event schedule differs from the batch class"
        if not w._chunkable() or w.tracer is not None \
                or w.analytics is not None or w.faults is not None:
            return ("unchunkable config (telemetry/reversion/"
                    "generation triggers) or per-run host pipeline "
                    "(trace/analytics/faults)")
        taken_d = {os.path.abspath(x.data_dir) for _, x in self._live()}
        if os.path.abspath(w.data_dir) in taken_d:
            return "data_dir already served by another slot"
        if w._ckpt_base():
            taken_c = {os.path.abspath(x._ckpt_base())
                       for _, x in self._live() if x._ckpt_base()}
            if os.path.abspath(w._ckpt_base()) in taken_c:
                return "ckpt_dir already served by another slot"
        return None

    def _retire(self, i: int, state: str, save: bool = True):
        """Free slot i back to ghost (requires a synced batch): the
        member takes its state as tensors of its own, writes its final
        checkpoint (the demotion/completion handoff: a demoted tenant
        resumes solo or in another batch from it, bit for bit), closes
        its .dat files and leaves its outcome for the status file."""
        w = self.slots[i]
        name = self.names[i]
        _own(w)
        if save and w._ckpt_base() and w.state is not None:
            from avida_tpu_torch.utils.checkpoint import (generation_update,
                                                          list_generations)
            gens = list_generations(w._ckpt_base())
            if not gens or generation_update(gens[-1]) != w.update:
                # skip the re-save when the boundary autosave just
                # published this very update (retirement at a
                # checkpoint boundary -- the common case)
                w.save_checkpoint()
        if self._member_exports(w) and w.state is not None:
            w.exporter.export(w)        # final per-tenant heartbeat
        insts = w._flush_exec()
        _close_files(w)
        w._dat_append = True
        self.finished[name] = {"state": state, "update": w.update,
                               "insts": insts}
        if len(self.finished) > 4096:
            self.finished.pop(next(iter(self.finished)))
        self.slots[i] = None
        self.names[i] = None
        self.max_updates[i] = None
        self._verified[i] = 0
        self.retirements += 1
        self._log(f"retire {name} ({state}) at update {w.update}")

    def _reconcile(self) -> bool:
        """Converge membership to the control file (requires a synced
        batch).  Returns True when membership changed."""
        ctl = self._read_control()
        if ctl is None:
            return False
        self._shutdown = bool(ctl.get("shutdown"))
        want = {}
        for e in ctl.get("members") or []:
            if isinstance(e, dict) and e.get("name") is not None:
                want[str(e["name"])] = e
        changed = False
        for i, w in self._live():
            if self.names[i] not in want:
                self._retire(i, "retired")      # demotion (cancel)
                changed = True
        current = {self.names[i] for i, _ in self._live()}
        for name, e in want.items():
            if name in current or name in self.finished:
                continue                # finished waits for the ack
            changed |= self.admit(e)
        for name in list(self.finished):
            if name not in want:
                # ack: the pool saw the outcome and dropped the member
                # from the control (or demoted it) -- forget it so a
                # future resubmission under the same name readmits
                del self.finished[name]
        return changed

    # ---- batched <-> per-world state (ghost-aware) ----

    def _stack(self):
        if self.bstate is not None:
            return
        dev = self.device

        def vec(name, dtype, none=0):
            out = []
            for w in self.slots:
                v = none if w is None else getattr(w, name)
                out.append(torch.as_tensor(none if v is None else v,
                                           dtype=dtype, device=dev))
            return torch.stack(out)

        self._avida_time = vec("_avida_time", torch.float32)
        self._last_ave_gen = vec("_last_ave_gen", torch.float32)
        self._deaths_this = vec("_deaths_this", torch.int32)
        self._prev_alive = vec("_prev_alive", torch.int32)
        self._total_births = vec("_total_births", torch.int64)
        self.bstate = stack_states([self._ghost_state if w is None
                                    else w.state for w in self.slots])
        self._run_keys = torch.stack([self._ghost_key if w is None
                                      else w._run_key for w in self.slots])
        for w in self.slots:
            if w is not None:
                w.state = None

    def _sync_worlds(self):
        if self.bstate is None:
            return
        for i, w in self._live():
            w.state = world_state(self.bstate, i)
            w._avida_time = self._avida_time[i]
            w._last_ave_gen = self._last_ave_gen[i]
            w._deaths_this = self._deaths_this[i]
            w._prev_alive = self._prev_alive[i]
            w._total_births = self._total_births[i]
            w._summary_cache_update = None
        self.bstate = None

    def _scan(self, k: int):
        """One serving chunk: every live world advances k updates from
        its OWN update counter (the u0 vector), ghosts run zero-trip
        identities in their slots."""
        u0 = [0 if w is None else int(w.update) for w in self.slots]
        if cycles._lib is None and self.device.type == "cuda" \
                and cycles.use_kernel(self.params):
            # the library through the program cache (cycles.load)
            cycles.load(self.cfg, self._compile_cache_log)
        if self.profiler is not None:
            self.profiler.chunk_begin(k)
        pre = None
        if self._scrub_every > 0:
            self._chunk_no += 1
            if self._chunk_no % self._scrub_every == 0:
                pre = (clone_state(self.bstate), u0)
        self.bstate, (executed, births, deaths, dts, ave_gens, n_alive,
                      trips) = multiworld_scan(
            self.params, self.bstate, k, self._run_keys, u0,
            self.neighbors)
        self._avida_time = self._avida_time + torch.stack(
            [prng.xla_f32_sum(row) for row in dts])
        self._last_ave_gen = ave_gens[:, -1]
        self._deaths_this = deaths[:, -1]
        self._prev_alive = n_alive[:, -1]
        self._total_births = self._total_births + births.sum(dim=1)
        tl = trips.to(torch.float32)
        self._trips = self._trips + tl.sum(dim=1)
        self._leader_trips = self._leader_trips + tl.max(dim=0).values.sum()
        self._trips_updates += k
        for i, w in self._live():
            w._pending_exec.append(executed[i])
            w.update += k
        if self.profiler is not None:
            live = self._live()
            self.profiler.chunk_end_batched(
                self, k, names=[self.names[i] for i, _ in live],
                num_ghosts=self.num_ghosts,
                update=max((w.update for _, w in live), default=0))
        if self._digest_on or pre is not None:
            # BEFORE the newborn drain: the shadow replay reproduces the
            # raw post-scan state (the drain zeroes nb_count afterwards)
            self._integrity_boundary(k, pre)
        if self._sysm_on:
            self._drain_newborns(k)

    def _drain_newborns(self, k: int):
        """Per-world systematics drain with per-world stamps: each
        world's window is stamped with ITS update (post-chunk for k > 1,
        the update just run for k = 1, as the solo run stamps them), so
        each member's phylogeny is its solo run's."""
        for i, w in self._live():
            if w.systematics is None:
                continue
            snap = {name: getattr(self.bstate, name)[i]
                    for name in World._NB_SNAP_FIELDS}
            at = w.update if k > 1 else w.update - 1
            snap["update_at"] = at
            snap["win_start"] = w._last_drain_update
            w._last_drain_update = at
            w._feed_systematics(snap)
        self.bstate = self.bstate.replace(
            nb_count=torch.zeros_like(self.bstate.nb_count))

    # ---- the integrity plane (serve flavor) ----

    def _integrity_boundary(self, k: int, pre):
        """Per-chunk digests and the sampled shadow replay of a serving
        batch, resolved synchronously into state_digests.  A mismatching
        live tenant rolls back ALONE -- its generations saved past its
        verified horizon quarantined, its slot freed to ghost, outcome
        "sdc" in `finished` for the pool to journal and requeue -- while
        classmates keep serving.  A mismatching GHOST slot means the
        batch itself is suspect: a batch-wide StateDivergenceError
        (child exit 67)."""
        from avida_tpu_torch.ops.digest import state_digest_batched
        from avida_tpu_torch.utils.checkpoint import quarantine_after
        t0 = time.monotonic()
        live = state_digest_batched(self.bstate).tolist()
        integrity.note_digest_ms((time.monotonic() - t0) * 1e3)
        if pre is None:
            self._record_digests(live)
            return
        pre_b, u0 = pre
        integrity.note_scrub()
        shadow_b, _ = multiworld_scan(self.params, pre_b, k,
                                      self._run_keys, u0, self.neighbors)
        t0 = time.monotonic()
        shad = state_digest_batched(shadow_b).tolist()
        integrity.note_digest_ms((time.monotonic() - t0) * 1e3)
        bad = [i for i in range(self.width) if live[i] != shad[i]]
        if not bad:
            for i, w in self._live():
                self._verified[i] = w.update
            self._record_digests(live)
            integrity.append_integrity_record(
                self.data_dir, "scrub", boundary=self.boundaries,
                chunk_updates=k, ok=True)
            return
        ghosts_bad = [i for i in bad if self.slots[i] is None]
        if ghosts_bad:
            integrity.note_mismatch()
            raise integrity.StateDivergenceError(
                f"silent state divergence in GHOST slot(s) {ghosts_bad} "
                f"of a serving batch -- a zero-trip identity changed, "
                f"the whole batch is suspect (width {self.width}, "
                f"last chunk {k} updates)")
        self._sync_worlds()
        for i in bad:
            w = self.slots[i]
            name = self.names[i]
            integrity.note_mismatch()
            quarantined = []
            if w._ckpt_base():
                quarantined = quarantine_after(w._ckpt_base(),
                                               self._verified[i])
            integrity.append_integrity_record(
                self.data_dir, "scrub", ok=False, world=name,
                update=int(w.update), chunk_updates=k,
                last_verified_update=self._verified[i],
                quarantined=len(quarantined))
            self._log(
                f"SDC: {name} diverged from its shadow replay in its "
                f"updates [{int(w.update) - k}, {int(w.update)}); "
                f"quarantined {len(quarantined)} suspect generation(s) "
                f"past update {self._verified[i]}; demoting -- "
                f"classmates keep serving")
            verified = self._verified[i]
            self._retire(i, "sdc", save=False)
            self.finished[name]["last_verified_update"] = verified
            self.finished[name]["quarantined"] = len(quarantined)
        for i, w in self._live():
            self._verified[i] = w.update
        self._stack()

    def _record_digests(self, vals: list):
        named = {self.names[i]: f"{vals[i]:#010x}"
                 for i, _ in self._live()}
        self.state_digests = (self.boundaries, vals)
        if self._digest_on and named:
            integrity.append_integrity_record(
                self.data_dir, "digest", boundary=self.boundaries,
                digests=named)

    # ---- status + metrics ----

    def _write_status(self, idle: bool = False):
        members = {}
        for i, w in self._live():
            members[self.names[i]] = {
                "state": "live", "update": int(w.update),
                "max_updates": self.max_updates[i],
                "organisms": (int(w.state.alive.sum())
                              if w.state is not None else None)}
        status = {
            "record": "serve", "time": self._clock(),
            "width": self.width, "live": self.num_live,
            "ghosts": self.num_ghosts, "idle": bool(idle),
            "boundaries": self.boundaries,
            "admissions": self.admissions,
            "retirements": self.retirements,
            # the reference's program traces and cache loads: the port
            # builds one library for every chunk length, so `compiles`
            # counts this process's nvcc builds and `cache_loads` its
            # loads from the persistent program cache
            "compiles": cycles.BUILDS,
            "cache_loads": compilecache.cache_load_count(),
            "preempted": bool(self.preempted or self._preempt),
            "shutdown": self._shutdown,
            "members": members,
            "finished": dict(self.finished),
        }
        path = os.path.join(self.data_dir, "serve.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(self.data_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(status, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            pass                        # status must not kill serving

    def _publish(self, idle: bool = False, final: bool = False):
        self._write_status(idle=idle)
        if self.exporter is not None:
            self.exporter.export(self, durable=final)

    # ---- the serve loop ----

    def serve(self) -> int:
        """Serve until shutdown / idle timeout / preemption.  Returns
        the number of checkpoint boundaries crossed."""
        boundary_every = int(self.cfg.get("TPU_CKPT_EVERY", 0)) or 32
        max_stretch = int(self.cfg.get("TPU_MAX_STRETCH", 0))
        idle_sec = float(self.cfg.get("TPU_SERVE_IDLE_SEC", 600))
        poll_sec = float(self.cfg.get("TPU_SERVE_POLL_SEC", 1.0))
        cap = 8 if self._sysm_on else 128
        if max_stretch > 0:
            cap = min(cap, max_stretch)
        cap = pow2_floor(cap)
        self._preempt = False
        self.preempted = False
        handlers = self._install_preempt_handlers()
        since_boundary = 0
        idle_since = None
        try:
            if int(self.cfg.get("TPU_SERVE_WARM", 1)):
                # warm-up: every power-of-two chunk length on the
                # ALL-GHOST batch (zero trips: almost free) before any
                # tenant arrives, so the cycle library is built or
                # loaded and no admission waits on nvcc
                sizes, k = [], 1
                while k <= min(cap, boundary_every):
                    sizes.append(k)
                    k <<= 1
                self._log(f"warming the batch: chunk sizes {sizes}")
                self._stack()
                for k in sizes:
                    self._scan(k)
                self._sync_worlds()
                self._log(f"warm: {cycles.BUILDS} nvcc build(s), "
                          f"{compilecache.cache_load_count()} loaded from "
                          f"the persistent compile cache")
            self._reconcile()
            self._publish(idle=not self._live())
            while not self._exit and not self._preempt:
                # retire members that hit their budget (or an Exit
                # event) FIRST, before any event processing -- the solo
                # loop breaks at its max_updates check before touching
                # events, and this ordering keeps the final retirement
                # checkpoint byte-identical to the solo TPU_CKPT_FINAL
                # generation (same events_done_for cursor) whenever the
                # chunk grids coincide
                for i, w in self._live():
                    if w._exit or (self.max_updates[i] is not None
                                   and w.update >= self.max_updates[i]):
                        self._sync_worlds()
                        self._retire(i, "done")
                live = self._live()
                if not live:
                    now = self._clock()
                    if idle_since is None:
                        idle_since = now
                    if self._shutdown:
                        self._log("shutdown requested; exiting")
                        break
                    if idle_sec > 0 and now - idle_since > idle_sec:
                        self._log(f"idle past {idle_sec:.0f}s; exiting")
                        break
                    self._sleep(poll_sec)
                    if self._reconcile():
                        idle_since = None
                    self._publish(idle=not self._live())
                    continue
                idle_since = None
                # per-world event boundary work at the PRE-chunk updates
                # (the solo process_events ordering, including the
                # events_done_for cursor each checkpoint serializes)
                if any(w._events_fire_now() for _, w in live):
                    self._sync_worlds()
                    for _, w in live:
                        w.process_events()
                else:
                    for _, w in live:
                        w._events_done_for = w.update
                if any(w._exit for _, w in live):
                    continue            # Exit events retire at the top
                gap = min(
                    (min(w._next_event_due(),
                         float("inf") if self.max_updates[i] is None
                         else self.max_updates[i]) - w.update)
                    for i, w in live)
                k = pow2_floor(int(min(float(gap),
                                       float(boundary_every
                                             - since_boundary),
                                       float(cap))))
                self._stack()
                self._scan(k)
                since_boundary += k
                if since_boundary >= boundary_every:
                    # THE checkpoint boundary, in the iteration of the
                    # chunk that reached it (the solo loop's shape):
                    # saves, then the membership reconcile -- promotions
                    # and demotions land here
                    self._sync_worlds()
                    for i, w in self._live():
                        if w._ckpt_base():
                            w.save_checkpoint()
                        if self._member_exports(w):
                            # per-tenant heartbeat (fleet --status member
                            # rows read these files)
                            w.exporter.export(w)
                    since_boundary = 0
                    self.boundaries += 1
                    self._reconcile()
                    self._publish()
                    if self._boundary_hook is not None:
                        self._boundary_hook(self)
            self._sync_worlds()
            self.preempted = self._preempt
            if self._preempt:
                for i, w in self._live():
                    w._preempt = True
                    w.preempted = True
                    if w._ckpt_base():
                        w.save_checkpoint()
            self._publish(final=True)
        finally:
            import signal as _signal
            for s, h in handlers.items():
                try:
                    _signal.signal(s, h)
                except (ValueError, OSError):
                    pass
            for _, w in self._live():
                _close_files(w)
                w._dat_append = True
        return self.boundaries
