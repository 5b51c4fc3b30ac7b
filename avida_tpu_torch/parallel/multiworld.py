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
every TPU_SCRUB_EVERY-th chunk.

Not ported here, raised by name: the serving batch ServeBatch (item 16)
and TPU_KERNEL_SHARDS > 1.  The exporter and profiler (item 15) are
refused by the members' World.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from avida_tpu_torch.core.state import (clone_state, stack_states,
                                        world_state)
from avida_tpu_torch.ops import resources as res_ops
from avida_tpu_torch.ops.update import update_scan_batched
from avida_tpu_torch.utils import integrity, prng
from avida_tpu_torch.world import World


def multiworld_scan(params, bstate, chunk, run_keys, u0, neighbors=None):
    """Advance W stacked worlds by `chunk` updates: update_scan_batched
    on their shared neighbor table.  Returns the batched state and the
    seven per-update vectors (executed, births, deaths, dt, ave_gen,
    n_alive, trips), each [W, chunk]."""
    return update_scan_batched(params, bstate, chunk, run_keys, u0,
                               neighbors)


def _event_key(ev):
    return (ev.trigger, ev.start, ev.interval, ev.stop, ev.action,
            tuple(ev.args))


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
        if int(self.params.kernel_shards) > 1:
            raise NotImplementedError(
                f"TPU_KERNEL_SHARDS={self.params.kernel_shards}: one "
                f"launch per card (K2 with S > 1) is not ported to "
                f"avida_tpu_torch yet")
        if res_ops.has_pools(self.params) or self.params.num_demes > 1:
            raise NotImplementedError(
                "batch members with resource pools or demes: the batched "
                "engines carry no per-world pools or deme state "
                "(ROADMAP.md Queue 1 item 14); run each world solo")
        if self.params.hw_type == 3:
            raise NotImplementedError(
                "batch members on experimental spatial hardware: the "
                "folded organism axis would carry facing rays and moves "
                "across world borders (ROADMAP.md Queue 1 item 14); run "
                "each world solo")
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
        finally:
            import signal as _signal
            for sig, h in handlers.items():
                try:
                    _signal.signal(sig, h)
                except (ValueError, OSError):
                    pass
            for w in self.worlds:
                for f in w._files.values():
                    try:
                        f.close()
                    except OSError as e:
                        print(f"[avida_tpu_torch] warning: closing "
                              f"{f.path}: {e}", file=sys.stderr)
                w._files = {}
                w._dat_append = True
        return sum(w._flush_exec() for w in self.worlds) - start_insts

    @property
    def num_worlds(self) -> int:
        return len(self.worlds)
