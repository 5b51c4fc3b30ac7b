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

Not ported here, raised by name: checkpoints and resume (ROADMAP.md
Queue 1 item 11), the serving batch ServeBatch (item 16) and
TPU_KERNEL_SHARDS > 1.  The exporter, profiler,
state digests and scrubs (item 15) are refused by the members' World.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from avida_tpu_torch.core.state import stack_states, world_state
from avida_tpu_torch.ops.update import update_scan_batched
from avida_tpu_torch.utils import prng
from avida_tpu_torch.world import World

_CKPT_UNPORTED = ("checkpoints (per-world TPU_CKPT_DIR, save and resume; "
                  "ROADMAP.md Queue 1 item 11)")


def multiworld_scan(params, bstate, chunk, run_keys, u0):
    """Advance W stacked worlds by `chunk` updates: update_scan_batched.
    Returns the batched state and the seven per-update vectors
    (executed, births, deaths, dt, ave_gen, n_alive, trips), each
    [W, chunk]."""
    return update_scan_batched(params, bstate, chunk, run_keys, u0)


def _event_key(ev):
    return (ev.trigger, ev.start, ev.interval, ev.stop, ev.action,
            tuple(ev.args))


def _refuse_checkpoints(ckpt_dir):
    if ckpt_dir not in (None, "", "-"):
        raise NotImplementedError(
            f"{_CKPT_UNPORTED}: not ported to avida_tpu_torch yet")


class MultiWorld:
    """Runs one batch of static-equal worlds (see the module
    docstring).  Build it from fully constructed Worlds (own seeds, own
    data dirs, one device) or with `from_seeds` / `from_manifest`."""

    def __init__(self, worlds):
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
            _refuse_checkpoints(w.cfg.get("TPU_CKPT_DIR", "-"))
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
        if int(self.params.kernel_shards) > 1:
            raise NotImplementedError(
                f"TPU_KERNEL_SHARDS={self.params.kernel_shards}: one "
                f"launch per card (K2 with S > 1) is not ported to "
                f"avida_tpu_torch yet")
        self._exit = False
        self.bstate = None
        self._run_keys = None
        self._avida_time = None
        self._last_ave_gen = None
        self._deaths_this = None
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

    # ---- construction helpers ----

    @classmethod
    def from_seeds(cls, seeds, config_dir: str | None = None,
                   overrides=None, data_dir: str = "data",
                   ckpt_dir: str | None = None,
                   device=None) -> "MultiWorld":
        """One world per seed, static config shared.  World k writes its
        .dat files to `<data_dir>/<name_k>` (names default w000, w001,
        ...)."""
        overrides = list(overrides or [])
        if ckpt_dir is None:
            for n, v in overrides:
                if n == "TPU_CKPT_DIR" and str(v) not in ("-", ""):
                    ckpt_dir = str(v)
        _refuse_checkpoints(ckpt_dir)
        base = [(n, v) for n, v in overrides
                if n not in ("RANDOM_SEED", "TPU_CKPT_DIR")]
        entries = [{"name": f"w{k:03d}", "seed": int(seed),
                    "data_dir": os.path.join(data_dir, f"w{k:03d}")}
                   for k, seed in enumerate(seeds)]
        return cls._from_entries(entries, config_dir, base, device)

    @classmethod
    def from_manifest(cls, path: str, config_dir: str | None = None,
                      overrides=None, device=None) -> "MultiWorld":
        """Batch from a worlds.json manifest: a list of {"name", "seed",
        "data_dir"} entries (a "ckpt_dir" entry is refused: checkpoints
        are not ported)."""
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
            _refuse_checkpoints(e.get("ckpt_dir"))
        base = [(n, v) for n, v in (overrides or [])
                if n not in ("RANDOM_SEED", "TPU_CKPT_DIR")]
        return cls._from_entries(entries, config_dir, base, device)

    @classmethod
    def _from_entries(cls, entries, config_dir, base_overrides, device=None):
        worlds = [World(config_dir=config_dir,
                        overrides=list(base_overrides)
                        + [("RANDOM_SEED", int(e["seed"]))],
                        data_dir=e["data_dir"], device=device)
                  for e in entries]
        mw = cls(worlds)
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
            w._total_births = self._total_births[i]
            w._summary_cache_update = None
        self.bstate = None

    # ---- the batched run loop (World.run's chunk grid) ----

    def _scan(self, k: int):
        """One batched chunk of k updates, with World._scan_updates'
        accumulator updates per world (each world's avida-time increment
        summed in the solo order)."""
        self.bstate, (executed, births, deaths, dts, ave_gens, n_alive,
                      trips) = multiworld_scan(
            self.params, self.bstate, k, self._run_keys, self.update)
        self._avida_time = self._avida_time + torch.stack(
            [prng.xla_f32_sum(row) for row in dts])
        self._last_ave_gen = ave_gens[:, -1]
        self._deaths_this = deaths[:, -1]
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

    def save_checkpoints(self):
        raise NotImplementedError(
            f"{_CKPT_UNPORTED}: not ported to avida_tpu_torch yet")

    def resume(self, at_update: int | None = None) -> int:
        raise NotImplementedError(
            f"{_CKPT_UNPORTED}: not ported to avida_tpu_torch yet")

    def run(self, max_updates: int | None = None) -> int:
        """The batched master loop: World.run's structure with the device
        work stacked over the world axis.  Returns the instructions
        executed across the batch by this call."""
        for w in self.worlds:
            if w.state is None:
                w.process_events()
                if w.state is None:
                    w.inject()
        start_insts = sum(w._cum_insts for w in self.worlds)
        max_stretch = int(self.cfg.get("TPU_MAX_STRETCH", 0))
        if self._trips is None:
            self._trips = torch.zeros(len(self.worlds), dtype=torch.float32,
                                      device=self.device)
            self._leader_trips = torch.zeros((), dtype=torch.float32,
                                             device=self.device)
        self._report_engine()
        sysm_on = self.worlds[0].systematics is not None
        try:
            self._stack()
            while not self._exit:
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
            self._sync_worlds()
        finally:
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
