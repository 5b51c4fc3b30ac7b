"""World: the host-side composition root and update driver.

Counterpart of avida_tpu/world.py for the main path: one solo world of
heads-CPU organisms, run by the packed-resident engine or, when the
reference would not take it (systematics on, its default; a run off the
cycle kernel, on the micro-step engine), the per-update engine
(ops/update.py); the live phylogeny (systematics/) fed from the
device's newborn ring through the reference's deferred drain; the standard
events (Inject, InjectAll, Exit, PrintAverageData, PrintCountData,
PrintTasksData, PrintTimeData, PrintDominantData) and their .dat files.
Anything outside that path (checkpoints, telemetry, other birth methods,
resources, ...) raises NotImplementedError naming the feature instead of
running something else.

Runs on `cuda` unless the caller passes device="cpu"; with neither a GPU
nor an explicit device it raises.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from avida_tpu_torch.config import (AvidaConfig, default_instset,
                                    heads_sex_instset, load_avida_cfg,
                                    load_environment, load_events,
                                    load_instset, load_organism)
from avida_tpu_torch.config.environment import default_logic9_environment
from avida_tpu_torch.config.events import parse_event_line
from avida_tpu_torch.config.schema import _parse_scalar
from avida_tpu_torch.core.state import (init_population, make_cell_inputs,
                                        make_world_params, seed_organism)
from avida_tpu_torch.ops import cycles, packed_chunk
from avida_tpu_torch.ops import update as update_ops
from avida_tpu_torch.ops.update import summarize, update_scan
from avida_tpu_torch.systematics import GenotypeArbiter
from avida_tpu_torch.utils import output as output_mod
from avida_tpu_torch.utils import prng

# Reference default ancestor (support/config/default-heads.org)
_DEFAULT_ANCESTOR_NAMES = (
    ["h-alloc", "h-search", "nop-C", "nop-A", "mov-head"]
    + ["nop-C"] * 86
    + ["h-search", "h-copy", "if-label", "nop-C", "nop-A", "h-divide",
       "mov-head", "nop-A", "nop-B"]
)

# config switches whose features this package does not run yet:
# (name, the reference's default, values that keep the feature off)
_OFF_SWITCHES = (
    ("TPU_TELEMETRY", 0, (0,)),
    ("TPU_TRACE", 0, (0,)), ("TPU_METRICS", 0, (0,)),
    ("TPU_PROFILE", 0, (0,)), ("TPU_ANALYTICS", 0, (0,)),
    ("TPU_STATE_DIGEST", 0, (0,)), ("TPU_SCRUB_EVERY", 0, (0,)),
    ("TPU_CKPT_EVERY", 0, (0,)), ("TPU_CKPT_FINAL", 0, (0,)),
    ("TPU_AUDIT_EVERY", 0, (0,)), ("TPU_FAULT", "", ("", "-")),
    ("TPU_USE_PALLAS", 0, (0, 1, 2)), ("TPU_KERNEL_SHARDS", 0, (0, 1)),
    ("REVERT_FATAL", 0.0, (0.0,)), ("REVERT_DETRIMENTAL", 0.0, (0.0,)),
    ("REVERT_NEUTRAL", 0.0, (0.0,)), ("REVERT_BENEFICIAL", 0.0, (0.0,)),
    ("STERILIZE_FATAL", 0.0, (0.0,)),
    ("STERILIZE_DETRIMENTAL", 0.0, (0.0,)),
    ("STERILIZE_NEUTRAL", 0.0, (0.0,)),
    ("STERILIZE_BENEFICIAL", 0.0, (0.0,)),
)

# InjectAll's fresh-organism reset (the reference's ops/demes.py
# _ZERO_FIELDS / _FALSE_FIELDS, heads hardware)
_ZERO_FIELDS = (
    "regs", "heads", "stacks", "sp", "active_stack", "read_label",
    "read_label_len", "input_ptr", "input_buf", "input_buf_n",
    "output_buf", "cur_task_count", "cur_reaction_count",
    "last_task_count", "time_used", "cpu_cycles", "gestation_start",
    "child_copied_size", "num_divides", "off_start", "off_len",
    "off_copied_size", "insts_executed", "budget_carry",
    "last_bonus", "last_merit_base",
    "smt_aux", "smt_aux_len", "pmem", "pmem_len", "smt_stacks", "smt_sp",
    "gstack", "gsp", "smt_head_pos", "inj_mem", "inj_len",
    "cost_wait", "ft_paid_lo", "ft_paid_hi",
)
_FALSE_FIELDS = ("mal_active", "breed_true", "divide_pending", "off_sex",
                 "parasite_active", "inject_pending", "sterile")


def default_ancestor(instset) -> np.ndarray:
    name_to_op = {n: i for i, n in enumerate(instset.inst_names)}
    if "h-divide" not in name_to_op and "divide-sex" in name_to_op:
        # the sexual ancestor: the same replicator with divide-sex
        # (ref support/config/default-heads-sex.org)
        names = ["divide-sex" if n == "h-divide" else n
                 for n in _DEFAULT_ANCESTOR_NAMES]
    else:
        names = _DEFAULT_ANCESTOR_NAMES
    missing = [n for n in names if n not in name_to_op]
    if missing:
        raise ValueError(
            f"instruction set {instset.name!r} has no built-in default "
            f"ancestor (lacks {missing[:4]}); inject an explicit genome")
    return np.asarray([name_to_op[n] for n in names], np.int8)


def resolve_device(device=None) -> torch.device:
    """The run's device: `device` when given, else the GPU.  Never falls
    back to the CPU silently."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "avida_tpu_torch runs on a CUDA device; none is available (pass "
            "device='cpu' to run the plain PyTorch versions on the CPU)")
    return torch.device("cuda")


class World:
    def __init__(self, cfg: AvidaConfig | None = None,
                 config_dir: str | None = None, overrides=None,
                 data_dir: str | None = None, device=None):
        self.device = resolve_device(device)
        if config_dir is not None:
            cfg = load_avida_cfg(os.path.join(config_dir, "avida.cfg"),
                                 overrides)
        elif cfg is None:
            cfg = AvidaConfig()
            for name, value in (overrides or []):
                cfg.set(name, _parse_scalar(str(value)))
        self.cfg = cfg
        self.config_dir = config_dir
        self.data_dir = data_dir or cfg.DATA_DIR
        for name, default, off in _OFF_SWITCHES:
            v = cfg.get(name, default)
            if v not in off:
                raise NotImplementedError(
                    f"{name}={v!r}: not ported to avida_tpu_torch yet "
                    f"(set {name} {off[0]!r})")
        if os.environ.get("TPU_FAULT"):
            raise NotImplementedError(
                "TPU_FAULT fault injection: not ported to avida_tpu_torch")

        if config_dir and cfg.INST_SET not in ("-", ""):
            self.instset = load_instset(os.path.join(config_dir,
                                                     cfg.INST_SET))
        elif any(t in cfg.INST_SET for t in ("smt", "pred", "experimental")):
            raise NotImplementedError(
                f"INST_SET {cfg.INST_SET!r}: only the heads instruction "
                f"sets (heads_default, heads_sex) are ported to "
                f"avida_tpu_torch")
        elif "sex" in cfg.INST_SET:
            self.instset = heads_sex_instset()
        else:
            self.instset = default_instset()

        env_path = (os.path.join(config_dir, cfg.ENVIRONMENT_FILE)
                    if config_dir else None)
        if env_path and os.path.exists(env_path):
            self.environment = load_environment(env_path)
        else:
            self.environment = default_logic9_environment()

        ev_path = (os.path.join(config_dir, cfg.EVENT_FILE)
                   if config_dir else None)
        if ev_path and os.path.exists(ev_path):
            self.events = load_events(ev_path)
        else:
            self.events = [
                parse_event_line("u begin Inject default-heads.org"),
                parse_event_line("u 0:100:end PrintAverageData"),
                parse_event_line("u 0:100:end PrintCountData"),
                parse_event_line("u 0:100:end PrintTasksData"),
                parse_event_line("u 0:100:end PrintTimeData"),
            ]
        for ev in self.events:
            self._check_action(ev.action)

        self.params = make_world_params(cfg, self.instset, self.environment)
        self._check_engine()

        seed = (cfg.RANDOM_SEED if cfg.RANDOM_SEED >= 0
                else int.from_bytes(os.urandom(4), "little"))
        ks = prng.split(prng.key(seed, self.device))
        # the run stream: per-update keys are fold_in(_run_key, update_no)
        self.key, self._run_key = ks[0], ks[1]
        self.update = 0
        self.state = None
        self._exit = False
        self._files = {}
        self._dat_append = False
        self._cum_insts = 0
        self._insts_prev_total = 0
        self._time_prev = 0
        self._pending_exec = []
        f32 = dict(dtype=torch.float32, device=self.device)
        self._avida_time = torch.zeros((), **f32)
        self._last_ave_gen = torch.zeros((), **f32)
        self._deaths_this = 0
        self._total_births = 0
        self._events_done_for = None
        self._gen_next = {}
        self._summary_cache_update = None
        self._nb_pending = None      # deferred newborn-drain snapshot
        self._last_drain_update = 0
        # live phylogeny (ref Systematics::GenotypeArbiter)
        self.systematics = (GenotypeArbiter(self.params.num_cells)
                            if cfg.get("TPU_SYSTEMATICS", 1) else None)

    def _check_engine(self):
        """Route as the reference does (cycles.use_kernel, then
        packed_chunk.ineligible_reason) and refuse, by name, what the
        chosen engine does not port and what the CUDA kernel cannot
        hold."""
        p = self.params
        reason = update_ops.engine_unported_reason(p)
        if reason is None:
            reason = cycles.kernel_limit_reason(p, self.device.type)
        if reason is None:
            fallback = packed_chunk.ineligible_reason(p, p.nb_cap > 0)
            if fallback is None:
                reason = packed_chunk.unported_reason(p)
                engine = "the packed engine"
            else:
                reason = update_ops.per_update_unported_reason(p)
                engine = f"the per-update engine, taken for {fallback}"
            if reason is not None:
                reason = f"{reason} (in {engine})"
        if reason is not None:
            raise NotImplementedError(
                f"{reason}: not ported to avida_tpu_torch yet")

    # ---- event actions ----

    _ACTIONS = ("Inject", "InjectAll", "Exit", "PrintAverageData",
                "PrintCountData", "PrintTasksData", "PrintTimeData",
                "PrintDominantData")

    def _check_action(self, action):
        if action not in self._ACTIONS:
            raise NotImplementedError(
                f"event action {action!r}: not ported to avida_tpu_torch "
                f"yet (ported: {', '.join(self._ACTIONS)})")

    def add_event(self, line: str):
        ev = parse_event_line(line)
        self._check_action(ev.action)
        self.events.append(ev)

    def _resolve_org_path(self, name: str) -> np.ndarray:
        if self.config_dir:
            p = os.path.join(self.config_dir, name)
            if os.path.exists(p):
                return load_organism(p, self.instset)
        return default_ancestor(self.instset)

    def _split_key(self):
        ks = prng.split(self.key)
        self.key = ks[0]
        return ks[1]

    def inject(self, genome: np.ndarray | None = None,
               cell: int | None = None):
        """Activate one organism (ref cPopulation::Inject cc:7377)."""
        k = self._split_key()
        if genome is None:
            genome = default_ancestor(self.instset)
        if cell is None:
            cell = self.params.num_cells // 2
        if self.state is None:
            self.state = init_population(self.params, genome, k,
                                         inject_cell=cell)
        else:
            self.state = seed_organism(self.params, self.state, genome, k,
                                       cell)
        if self.systematics is not None:
            self.systematics.classify_seed(cell, genome, update=self.update)

    def _action_Inject(self, args):
        self.inject(self._resolve_org_path(args[0]) if args else None)

    def _action_InjectAll(self, args):
        """An organism in every cell (ref cActionInjectAll)."""
        genome = self._resolve_org_path(args[0]) if args else None
        if self.state is None:
            # bootstrap state only: the blanket reseed below covers cell 0,
            # so this inject is not classified (no double record)
            sysm, self.systematics = self.systematics, None
            self.inject(genome, cell=0)
            self.systematics = sysm
        g = genome if genome is not None else default_ancestor(self.instset)
        n, L = self.params.num_cells, self.params.max_memory
        glen = len(g)
        gm = np.zeros(L, np.int8)
        gm[:glen] = g
        k = self._split_key()
        self.state = self._clone_all(gm, glen, k)
        if self.systematics is not None:
            self.systematics.classify_seed_all(g, update=self.update)

    def _clone_all(self, gm, glen, key):
        """InjectClone / SetupClone on every cell (the reference's
        ops/demes._clone_reset with all cells selected)."""
        p, st = self.params, self.state
        n = p.num_cells
        dev = self.device
        genome = torch.from_numpy(gm).to(dev)[None, :].expand(n, -1)
        if p.death_method == 2:
            max_exec = p.age_limit * glen
        else:
            max_exec = p.age_limit if p.death_method == 1 else 2**30
        up = {
            "genome": genome.clone(),
            "tape": genome.to(torch.uint8) & 0x3F,
            "alive": torch.ones(n, dtype=torch.bool, device=dev),
            "merit": torch.full((n,), float(glen), dtype=torch.float32,
                                device=dev),
        }
        for name in ("genome_len", "mem_len", "executed_size",
                     "copied_size"):
            up[name] = torch.full((n,), glen, dtype=torch.int32, device=dev)
        up["max_executed"] = torch.full((n,), max_exec, dtype=torch.int32,
                                        device=dev)
        for name in _ZERO_FIELDS:
            up[name] = torch.zeros_like(getattr(st, name))
        for name in _FALSE_FIELDS:
            up[name] = torch.zeros_like(getattr(st, name))
        up["cur_bonus"] = torch.full((n,), p.default_bonus,
                                     dtype=torch.float32, device=dev)
        for name in ("genotype_id", "parent_id", "birth_update"):
            up[name] = torch.full((n,), -1, dtype=torch.int32, device=dev)
        up["inputs"] = make_cell_inputs(key, n)
        return st.replace(**up)

    def _action_Exit(self, args):
        self._exit = True

    def _file(self, name, opener, *a):
        if name not in self._files:
            self._files[name] = opener(self.data_dir, *a,
                                       append=self._dat_append)
        return self._files[name]

    def _summary(self):
        if self._summary_cache_update != self.update:
            s = summarize(self.params, self.state, self.update - 1)
            self._summary_stats = {k: v.cpu().numpy() for k, v in s.items()}
            self._summary_cache_update = self.update
        return self._summary_stats

    def _flush_exec(self) -> int:
        if self._pending_exec:
            self._cum_insts += int(sum(
                x.to(torch.int64).sum().item() for x in self._pending_exec))
            self._pending_exec = []
        return self._cum_insts

    def _action_PrintAverageData(self, args):
        s = self._summary()
        f = self._file("average", output_mod.open_average_dat)
        n = max(int(s["num_organisms"]), 1)
        sysm = self.systematics
        abundance = (n / max(sysm.num_genotypes, 1)) if sysm else 0.0
        depth = sysm.average_depth() if sysm else 0.0
        births = int(s["births_this_update"])
        f.write_row([
            self.update, float(s["ave_merit"]), float(s["ave_gestation"]),
            float(s["ave_fitness"]), float(s["ave_repro_rate"]),
            float(s["ave_genome_len"]), float(s["ave_copied_size"]),
            float(s["ave_executed_size"]), abundance,
            births / n, int(s["num_breed_true"]) / n, depth,
            float(s["ave_generation"]), 0.0, 0,
            births / n])

    def _action_PrintCountData(self, args):
        s = self._summary()
        f = self._file("count", output_mod.open_count_dat)
        total = self._flush_exec()
        insts_this_update = total - self._insts_prev_total
        self._insts_prev_total = total
        n = int(s["num_organisms"])
        sysm = self.systematics
        num_gt = sysm.num_genotypes if sysm else 0
        num_thr = sysm.num_threshold if sysm else 0
        births = int(s["births_this_update"])
        breed_true = int(s["num_breed_true"])
        f.write_row([self.update, insts_this_update, n, num_gt, num_thr,
                     0, 0, 0, births, int(self._deaths_this), breed_true,
                     breed_true, int(s["num_no_birth"]), n, 0, 0])

    def _action_PrintDominantData(self, args):
        """dominant.dat: the most abundant live genotype with reductions
        over its living cells (ref PrintDominantData,
        actions/PrintActions.cc)."""
        if self.systematics is None:
            return
        g = self.systematics.dominant()
        if g is None:
            return
        f = self._file("dominant", output_mod.open_dominant_dat)
        st = self.state

        def col(name):
            return getattr(st, name).cpu().numpy()

        member = (self.systematics.cell_gid == g.gid) & col("alive")
        cells = np.nonzero(member)[0]
        if cells.size:
            merit = float(col("merit")[cells].mean())
            gest = float(col("gestation_time")[cells].mean())
            fit = float(col("fitness")[cells].mean())
            copied = float(col("copied_size")[cells].mean())
            execd = float(col("executed_size")[cells].mean())
            max_fit = float(col("fitness")[cells].max())
            births = int((col("birth_update")[cells]
                          == self.update - 1).sum())
            breed_true = int(col("breed_true")[cells].sum())
        else:
            merit = gest = fit = copied = execd = max_fit = 0.0
            births = breed_true = 0
        # reference names are "<size>-<base26>" (e.g. 100-aaaaa)
        name = f"{g.length}-" + "".join(
            chr(ord("a") + (g.gid // 26**k) % 26) for k in range(4, -1, -1))
        f.write_row([
            self.update, merit, gest, fit,
            (1.0 / gest if gest else 0.0), g.length, copied, execd,
            g.num_units, births, breed_true, g.depth, 0, max_fit, g.gid,
            name])

    def _action_PrintTasksData(self, args):
        s = self._summary()
        f = self._file("tasks", output_mod.open_tasks_dat,
                       self.environment.task_names())
        f.write_row([self.update] + [int(x) for x in s["task_counts"]])

    def _action_PrintTimeData(self, args):
        s = self._summary()
        f = self._file("time", output_mod.open_time_dat)
        total = self._flush_exec()
        insts = total - self._time_prev
        self._time_prev = total
        f.write_row([self.update, float(self._avida_time),
                     float(s["ave_generation"]), insts])

    def _dispatch(self, ev):
        getattr(self, f"_action_{ev.action}")(ev.args)

    def process_events(self):
        """Fire due events (ref cEventList::Process, called at the top of
        every update); idempotent per update."""
        if self._events_done_for == self.update:
            return
        self._events_done_for = self.update
        gen = float(self._last_ave_gen)
        for ev in self.events:
            if ev.trigger == "update":
                if ev.fires_at(self.update):
                    self._dispatch(ev)
            elif ev.trigger == "immediate":
                if self.update == 0:
                    self._dispatch(ev)
            elif ev.trigger in ("generation", "births"):
                cur = (float(self._total_births) if ev.trigger == "births"
                       else gen)
                nxt = self._gen_next.setdefault(id(ev), ev.start)
                while cur >= nxt and nxt <= ev.stop:
                    self._dispatch(ev)
                    nxt = float("inf") if ev.interval <= 0 \
                        else nxt + ev.interval
                self._gen_next[id(ev)] = nxt

    # ---- the update loop (Avida2Driver::Run equivalent) ----

    def _scan_updates(self, k: int):
        """Run k updates through the routed engine (ops/update.update_scan);
        returns the per-update executed-instruction vector (device
        tensor)."""
        if self.state is None:
            raise RuntimeError("no population injected")
        self.state, (executed, births, deaths, dts, ave_gens, n_alive) = \
            update_scan(self.params, self.state, k, self._run_key,
                        self.update)
        # avida time advances by 1/ave_gestation per update
        self._avida_time = self._avida_time + prng.xla_f32_sum(dts)
        self._last_ave_gen = ave_gens[-1]
        self._deaths_this = deaths[-1]
        self._total_births = self._total_births + births.sum()
        return executed

    def run_updates(self, k: int):
        """k updates as one stretch; advances self.update by k."""
        executed = self._scan_updates(k)
        self.update += k
        return executed

    def run_update(self):
        """ONE update plus the synchronous systematics feed (does not
        advance self.update; the caller does)."""
        executed = self._scan_updates(1)
        if self.systematics is not None:
            self._feed_systematics()
        return executed

    def _chunkable(self) -> bool:
        return not any(ev.trigger in ("generation", "births")
                       for ev in self.events)

    def _plan_stretch(self, max_updates, max_stretch: int) -> int:
        """Length of the next event-free stretch: power-of-two buckets up
        to 128 updates (8 with systematics on, bounding the newborn drain;
        and TPU_MAX_STRETCH), the reference's planner."""
        due = self._next_event_due()
        if max_updates is not None:
            due = min(due, max_updates)
        cap_stretch = 128.0 if self.systematics is None else 8.0
        if max_stretch > 0:
            cap_stretch = min(cap_stretch, float(max_stretch))
        gap = int(max(1.0, min(due - self.update, cap_stretch)))
        return 1 << (gap.bit_length() - 1)

    def _next_event_due(self) -> float:
        nxt = float("inf")
        for ev in self.events:
            if ev.trigger != "update":
                continue
            if self.update < ev.start:
                nxt = min(nxt, ev.start)
            elif ev.interval > 0:
                k = (self.update - ev.start) // ev.interval
                cand = ev.start + (k + 1) * ev.interval
                if cand <= ev.stop:
                    nxt = min(nxt, cand)
        return nxt

    # ---- the systematics drain (the reference's deferred pipeline) ----

    _NB_SNAP_FIELDS = ("nb_count", "nb_genome", "nb_len", "nb_cell",
                       "nb_parent", "nb_update", "alive", "birth_update",
                       "genome", "genome_len", "parent_id")

    def _snapshot_newborns(self, copy: bool = True):
        """Everything the drain reads (the newborn ring and the arrays the
        overflow fallback scans), with the live ring counter zeroed.
        copy=True takes device-side copies, which the host ingests one
        stretch later, after the next stretch has been dispatched;
        copy=False hands over the live tensors for a drain right now."""
        st = self.state
        snap = {name: (getattr(st, name).clone() if copy
                       else getattr(st, name))
                for name in self._NB_SNAP_FIELDS}
        snap["update_at"] = self.update
        snap["win_start"] = self._last_drain_update
        self._last_drain_update = self.update
        self.state = st.replace(nb_count=torch.zeros_like(st.nb_count))
        return snap

    def _flush_newborn_drain(self):
        """Ingest any deferred snapshot now (a host sync point): at event
        boundaries, before a single-update step, before pruning and at
        run exit, so the phylogeny is current and drains stay in update
        order."""
        snap, self._nb_pending = self._nb_pending, None
        if snap is not None:
            self._feed_systematics(snap)

    def _events_fire_now(self) -> bool:
        """Does any event fire at the current update?  (Generation and
        births triggers count as always due.)"""
        for ev in self.events:
            if ev.trigger == "update":
                if ev.fires_at(self.update):
                    return True
            elif ev.trigger == "immediate":
                if self.update == 0:
                    return True
            else:
                return True
        return False

    def _feed_systematics(self, snap=None):
        """Drain the newborn ring into the host phylogeny, one group per
        update in update order.  When more births arrived than the ring
        holds, the dropped tail is recovered from a state scan of the
        window (newborns overwritten later and dead are lost) with a
        warning.  snap: a deferred snapshot; None reads the live state."""
        if snap is None:
            snap = self._snapshot_newborns(copy=False)

        def host(x):
            return x.cpu().numpy()

        count = int(snap["nb_count"])
        cap = snap["nb_genome"].shape[0]
        alive = host(snap["alive"])
        overflow = count > cap
        if overflow:
            print(f"[avida_tpu_torch] warning: newborn buffer overflow "
                  f"({count} > {cap}); recovering surviving births from a "
                  f"state scan (overwritten-then-dead newborns are lost "
                  f"this window)", file=sys.stderr)
            count = cap
        if not count:
            self.systematics.process(
                snap["update_at"], alive, np.zeros(0, np.int64),
                np.zeros((0, self.params.max_memory), np.int8),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
            return
        genomes = host(snap["nb_genome"][:count])
        lens = host(snap["nb_len"][:count])
        cells = host(snap["nb_cell"][:count])
        parents = host(snap["nb_parent"][:count])
        updates = host(snap["nb_update"][:count])
        if overflow:
            # births inside the window that the ring dropped still hold
            # their cell unless overwritten: recover them from the state
            bu = host(snap["birth_update"])
            in_window = alive & (bu >= max(snap["win_start"], 0))
            recorded = set(zip(cells.tolist(), updates.tolist()))
            extra = np.asarray([c for c in np.nonzero(in_window)[0]
                                if (int(c), int(bu[c])) not in recorded],
                               np.int64)
            if extra.size:
                idx = torch.from_numpy(extra).to(snap["genome"].device)
                genomes = np.concatenate(
                    [genomes, host(snap["genome"][idx])])
                lens = np.concatenate(
                    [lens, host(snap["genome_len"][idx])])
                cells = np.concatenate([cells, extra])
                parents = np.concatenate(
                    [parents, host(snap["parent_id"])[extra]])
                updates = np.concatenate([updates, bu[extra]])
                order = np.argsort(updates, kind="stable")
                genomes, lens, cells, parents, updates = (
                    genomes[order], lens[order], cells[order],
                    parents[order], updates[order])
                count += extra.size
        # one group per update; deaths resolve against the end-of-window
        # occupancy for every group
        start = 0
        for i in range(1, count + 1):
            if i == count or updates[i] != updates[start]:
                self.systematics.process(
                    int(updates[start]), alive, cells[start:i],
                    genomes[start:i], lens[start:i], parents[start:i])
                start = i

    def run(self, max_updates: int | None = None) -> int:
        """Run until Exit or `max_updates`; returns the instructions
        executed by this call."""
        if self.state is None:
            self.process_events()
            if self.state is None:
                self.inject()
        start_insts = self._cum_insts
        can_chunk = self._chunkable()
        max_stretch = int(self.cfg.get("TPU_MAX_STRETCH", 0))
        try:
            while not self._exit:
                if max_updates is not None and self.update >= max_updates:
                    break
                if self._nb_pending is not None and self._events_fire_now():
                    # the phylogeny must be current before a Print reads it
                    self._flush_newborn_drain()
                self.process_events()
                if self._exit:
                    break
                stretch = (self._plan_stretch(max_updates, max_stretch)
                           if can_chunk else 1)
                if stretch > 1:
                    self._pending_exec.append(self.run_updates(stretch))
                    if self.systematics is not None:
                        # snapshot this stretch's newborns (device copies),
                        # then ingest the previous stretch's snapshot
                        # while this one's work is queued on the device
                        prev, self._nb_pending = (self._nb_pending,
                                                  self._snapshot_newborns())
                        if prev is not None:
                            self._feed_systematics(prev)
                else:
                    self._flush_newborn_drain()
                    self._pending_exec.append(self.run_update())
                    self.update += 1
                if len(self._pending_exec) >= 256:
                    self._flush_exec()
                if self.systematics is not None and self.update % 100 == 0:
                    self._flush_newborn_drain()
                    self.systematics.prune_extinct(keep_ancestry=True)
            self._flush_newborn_drain()
        finally:
            for f in self._files.values():
                try:
                    f.close()
                except OSError as e:
                    print(f"[avida_tpu_torch] warning: closing {f.path}: "
                          f"{e}", file=sys.stderr)
            self._files = {}
            # a second run() on this world extends its .dat files
            self._dat_append = True
        return self._flush_exec() - start_insts

    @property
    def num_organisms(self) -> int:
        return int(self.state.alive.sum())

    def engine_report(self) -> dict:
        """Which engine runs this world and why, in the reference's
        vocabulary (packed_chunk.engine_report)."""
        return packed_chunk.engine_report(self.params,
                                          self.params.nb_cap > 0)
