"""World: the host-side composition root and update driver.

Counterpart of avida_tpu/world.py for the main path: one solo world of
heads-CPU organisms, of TransSMT hosts and their parasites
(INST_SET transsmt), or of experimental spatial hardware's predators and
prey (INST_SET pred_look / experimental; these two on the micro-step
engine), run by the
packed-resident engine or, when the
reference would not take it (systematics on, its default; a run off the
cycle kernel, on the micro-step engine), the per-update engine
(ops/update.py); the live phylogeny (systematics/) fed from the
device's newborn ring through the reference's deferred drain; resource
pools and demes; the standard events (Inject, InjectAll, Exit,
PrintAverageData, PrintCountData, PrintTasksData, PrintTimeData,
PrintDominantData, PrintResourceData, SavePopulation, LoadPopulation,
SetResource, CompeteDemes, ReplicateDemes,
Pred_DemeResourceThresholdPredicate, InjectParasite, KillProb,
SerialTransfer, and the print actions PrintFitnessData, PrintStatsData,
PrintData through the data provider registry (utils/data_registry.py),
the instruction, depth and genotype-abundance histograms,
PrintTasksExeData and PrintTasksQualData) and their .dat files; every
geometry the reference
builds (its neighbor table, self.neighbors); persistence:
native checkpoints (TPU_CKPT_DIR, TPU_CKPT_EVERY, TPU_CKPT_FINAL;
save_checkpoint / resume, in the reference's on-disk format),
SIGTERM/SIGINT preemption with a final checkpoint, the state digest and
the scrub's shadow replay
(TPU_STATE_DIGEST, TPU_SCRUB_EVERY) and the invariant audit
(TPU_AUDIT_EVERY, TPU_CKPT_AUDIT); the offspring reversion test
(REVERT_* / STERILIZE_*, through the batched Test CPU of analyze/) and
the in-run analytics (TPU_ANALYTICS, analyze/pipeline.py); the
observability plane (observability/): phase-fenced telemetry
(TPU_TELEMETRY, telemetry.jsonl), the flight recorder (TPU_TRACE,
{"record": "trace"} lines), the metrics.prom heartbeat (TPU_METRICS),
the chunk profiler (TPU_PROFILE, perf.jsonl), and deterministic fault
injection (TPU_FAULT, utils/faultinject.py).  Anything outside that
(TPU_KERNEL_SHARDS > 1, ...) raises NotImplementedError naming the
feature instead of running something else.

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
                                    load_instset, load_organism,
                                    transsmt_instset)
from avida_tpu_torch.config.environment import default_logic9_environment
from avida_tpu_torch.config.instset import (experimental_instset,
                                            pred_look_instset)
from avida_tpu_torch.config.events import parse_event_line
from avida_tpu_torch.config.schema import _parse_scalar
from avida_tpu_torch.core.state import (clone_state, init_population,
                                        make_world_params, seed_organism)
from avida_tpu_torch.ops import birth as birth_ops
from avida_tpu_torch.ops import cycles, packed_chunk
from avida_tpu_torch.ops import demes as deme_ops
from avida_tpu_torch.ops import update as update_ops
from avida_tpu_torch.ops.update import summarize, update_scan
from avida_tpu_torch.systematics import GenotypeArbiter
from avida_tpu_torch.utils import integrity
from avida_tpu_torch.utils import output as output_mod
from avida_tpu_torch.utils import prng
from avida_tpu_torch.utils.data_registry import (DataManager, DatRecorder,
                                                 abundance_histogram,
                                                 depth_histogram,
                                                 instruction_abundance,
                                                 register_standard_providers)

# Reference default ancestor (support/config/default-heads.org)
_DEFAULT_ANCESTOR_NAMES = (
    ["h-alloc", "h-search", "nop-C", "nop-A", "mov-head"]
    + ["nop-C"] * 86
    + ["h-search", "h-copy", "if-label", "nop-C", "nop-A", "h-divide",
       "mov-head", "nop-A", "nop-B"]
)

# Reference experimental ancestor (support/config/experimental.org): the
# copy loop's label is nop-D nop-A (the complement under Rotate(1, 8)
# lands past the 3-nop space) and the end label A,B is addressed through
# the `label` marker instruction.
_EXPERIMENTAL_ANCESTOR_NAMES = (
    ["h-alloc", "h-search", "nop-D", "nop-A", "mov-head", "nop-C", "add"]
    + ["nop-C"] * 81
    + ["h-search", "h-copy", "if-label", "nop-D", "nop-A", "h-divide",
       "mov-head", "nop-A", "add", "label", "nop-A", "nop-B"]
)

# Reference transsmt ancestor (support/config/default-transsmt.org): search
# end label, SetMemory offspring space, copy loop, Divide at end-position.
_TRANSSMT_ANCESTOR_NAMES = (
    ["Search", "Nop-C", "Nop-D", "Push-Prev", "SetMemory", "Nop-A",
     "Head-Move"]
    + ["Nop-C"] * 83
    + ["Search", "Inst-Read", "Inst-Write", "Head-Push", "Nop-C",
       "If-Equal", "Divide", "Head-Move", "Nop-A", "Nop-B"]
)

# Reference transsmt parasite (support/config/default-transsmt-parasite.org):
# nop body, copy loop into its own write space, Inject at the end.
_TRANSSMT_PARASITE_NAMES = (
    ["Nop-A"] + ["Nop-B"] * 75
    + ["Inst-Read", "Val-Add", "Val-Dec", "SetMemory", "Nop-C", "IO",
       "Nop-C", "Nop-B", "Head-Move", "Nop-C", "Search", "Inst-Write",
       "Inst-Read", "If-Greater", "Head-Move", "Val-Sub", "Val-Dec", "IO",
       "Val-Div", "Val-Dec", "Val-Dec", "Val-Dec", "Val-Div", "Inject"]
)

# config switches whose features this package does not run yet:
# (name, the reference's default, values that keep the feature off)
_OFF_SWITCHES = (
    ("TPU_USE_PALLAS", 0, (0, 1, 2)), ("TPU_KERNEL_SHARDS", 0, (0, 1)),
)

def default_ancestor(instset) -> np.ndarray:
    name_to_op = {n: i for i, n in enumerate(instset.inst_names)}
    if "Divide" in name_to_op or "Divide-Erase" in name_to_op:
        names = _TRANSSMT_ANCESTOR_NAMES       # transsmt hardware
    elif "nop-D" in name_to_op and "h-divide" in name_to_op:
        names = _EXPERIMENTAL_ANCESTOR_NAMES   # 4+-nop experimental
    elif "h-divide" not in name_to_op and "divide-sex" in name_to_op:
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


def default_parasite(instset) -> np.ndarray:
    """The stock transsmt parasite's opcodes in `instset`."""
    name_to_op = {n: i for i, n in enumerate(instset.inst_names)}
    return np.asarray([name_to_op[n] for n in _TRANSSMT_PARASITE_NAMES],
                      np.int8)


def _load_migration_matrix(path: str, num_demes: int, name: str) -> list:
    """DEMES_MIGRATION_METHOD 4's MIGRATION_FILE (cMigrationMatrix::Load):
    one whitespace-separated row of weights per source deme, `#`
    comments ignored."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                rows.append([float(x) for x in line.split()])
    if len(rows) != num_demes or any(len(r) != num_demes for r in rows):
        raise ValueError(f"MIGRATION_FILE {name!r} must be a "
                         f"{num_demes}x{num_demes} matrix")
    return rows


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

        if config_dir and cfg.INST_SET not in ("-", ""):
            self.instset = load_instset(os.path.join(config_dir,
                                                     cfg.INST_SET))
        elif "transsmt" in cfg.INST_SET or "smt" in cfg.INST_SET:
            self.instset = transsmt_instset()
        elif "pred" in cfg.INST_SET:
            self.instset = pred_look_instset()
        elif "experimental" in cfg.INST_SET:
            self.instset = experimental_instset()
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

        if int(cfg.DEMES_MIGRATION_METHOD) == 4 \
                and cfg.MIGRATION_FILE not in ("-", ""):
            cfg._migration_matrix = _load_migration_matrix(
                os.path.join(config_dir, cfg.MIGRATION_FILE) if config_dir
                else cfg.MIGRATION_FILE, cfg.NUM_DEMES, cfg.MIGRATION_FILE)
        self.params = make_world_params(cfg, self.instset, self.environment)
        self._check_engine()
        # the world's topology, built once (random geometries from
        # max(RANDOM_SEED, 0) and SCALE_FREE_*, as the reference's World)
        self.neighbors = birth_ops.neighbors_on(
            self.params, self.device, seed=max(cfg.RANDOM_SEED, 0),
            scale_free_m=cfg.SCALE_FREE_M,
            scale_free_alpha=cfg.SCALE_FREE_ALPHA,
            scale_free_zero_appeal=cfg.SCALE_FREE_ZERO_APPEAL)

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
        self._prev_alive = None
        self._total_births = 0
        self._task_exe_prev = None   # tasks_exe diff baseline (LoadPopulation)
        self._deme_predicates = []   # Pred_DemeResourceThresholdPredicate
        self._events_done_for = None
        self._gen_next = {}
        self._summary_cache_update = None
        self._nb_pending = None      # deferred newborn-drain snapshot
        self._last_drain_update = 0
        # live phylogeny (ref Systematics::GenotypeArbiter)
        self.systematics = (GenotypeArbiter(self.params.num_cells)
                            if cfg.get("TPU_SYSTEMATICS", 1) else None)
        # the data provider registry (ref avida/data/Manager.h): PrintData
        # resolves its IDs through it
        self.data = DataManager(self)
        register_standard_providers(self.data)
        self._preempt = False        # SIGTERM/SIGINT tripwire (run loop)
        self.preempted = False       # last run() ended via preemption
        # the integrity plane (ops/digest.py, utils/integrity.py): off by
        # default, and then nothing is digested and no copy is retained
        self._digest_on = integrity.digest_enabled(cfg)
        self._scrub_every = integrity.scrub_every(cfg)
        self._chunk_no = 0              # process-lifetime chunk counter
        self._digest_pending = None     # (update, device digest) deferred
        self.state_digest = None        # (update, value) last resolved
        self._last_verified_update = 0  # newest scrub-verified update
        # in-run analytics (analyze/pipeline.LiveAnalytics): with
        # TPU_ANALYTICS=1 run() refreshes the phenotype census and the
        # dominant lineage at checkpoint boundaries and at exit; a pure
        # read of the state, so the trajectory is the same on or off
        self.analytics = None
        if int(cfg.get("TPU_ANALYTICS", 0)):
            from avida_tpu_torch.analyze.pipeline import LiveAnalytics
            self.analytics = LiveAnalytics(self)
        # offspring reversion / sterilization through the batched Test CPU
        # (cHardwareBase::Divide_TestFitnessMeasures cc:866); sandbox
        # records are memoized per genotype (systematics/test_metrics.py)
        self._revert = {
            "fatal": (cfg.REVERT_FATAL, cfg.STERILIZE_FATAL),
            "neg": (cfg.REVERT_DETRIMENTAL, cfg.STERILIZE_DETRIMENTAL),
            "neut": (cfg.REVERT_NEUTRAL, cfg.STERILIZE_NEUTRAL),
            "pos": (cfg.REVERT_BENEFICIAL, cfg.STERILIZE_BENEFICIAL),
        }
        self._revert_on = any(p > 0 for pair in self._revert.values()
                              for p in pair)
        self._init_observability()
        self._neut_min = 1.0 - cfg.get("NEUTRAL_MIN", 0.0)
        self._neut_max = 1.0 + cfg.get("NEUTRAL_MAX", 0.0)
        self.last_reversion = None   # the last reversion step's counts
        if self._revert_on:
            from avida_tpu_torch.systematics.test_metrics import \
                GenomeTestMetrics
            self.test_metrics = GenomeTestMetrics(self.params,
                                                  device=self.device)
            self._revert_rng = np.random.default_rng(seed ^ 0x5EED)

    def _init_observability(self):
        """The observability plane's hosts, each None unless armed:
        telemetry (TPU_TELEMETRY: the update runs phase-fenced through
        StagedUpdate, records in telemetry.jsonl; TPU_PROFILE_DIR takes a
        torch.profiler trace of its first TPU_PROFILE_UPDATES updates),
        the flight recorder (TPU_TRACE: the device ring drained to
        {"record": "trace"} lines at chunk boundaries), the metrics.prom
        heartbeat (TPU_METRICS, implied by TPU_TRACE), the chunk profiler
        (TPU_PROFILE, off under telemetry, which fences every phase
        already) and the fault plan (TPU_FAULT).  None of them changes
        the trajectory."""
        cfg = self.cfg
        self._kernel_checked = False     # _load_kernel ran
        self.telemetry = None
        if int(cfg.get("TPU_TELEMETRY", 0)):
            from avida_tpu_torch.observability.runlog import \
                TelemetryRecorder
            pdir = str(cfg.get("TPU_PROFILE_DIR", "-") or "-")
            self.telemetry = TelemetryRecorder(
                self, profile_dir=(pdir if pdir not in ("-", "") else None),
                profile_updates=int(cfg.get("TPU_PROFILE_UPDATES", 3)))
        self.tracer = None
        self._trace_pending = None   # deferred ring snapshot (run loop)
        if self.params.trace_cap:
            from avida_tpu_torch.observability.tracer import FlightRecorder
            self.tracer = FlightRecorder(self)
        self.exporter = None
        if int(cfg.get("TPU_METRICS", 0)) or self.tracer is not None:
            from avida_tpu_torch.observability.exporter import \
                MetricsExporter
            self.exporter = MetricsExporter(self)
        self.profiler = None
        from avida_tpu_torch.observability import profiler as _profiler
        if _profiler.enabled(cfg) and self.telemetry is None:
            self.profiler = _profiler.ChunkProfiler(
                self.data_dir, cfg, kind="solo", device=self.device)
        from avida_tpu_torch.utils.faultinject import plan_from_config
        self.faults = plan_from_config(cfg)
        if (self._digest_on or self._scrub_every) \
                and self.telemetry is not None:
            # telemetry steps update by update through StagedUpdate: no
            # chunk to digest or replay, so say so instead of pretending
            print("[avida_tpu_torch] warning: TPU_STATE_DIGEST/"
                  "TPU_SCRUB_EVERY are no-ops under TPU_TELEMETRY (the "
                  "integrity plane rides the chunk path); run telemetry OR "
                  "scrubbing, not both", file=sys.stderr)

    def _check_engine(self):
        """Route as the reference does (cycles.use_kernel, then
        packed_chunk.ineligible_reason) and refuse, by name, what the
        chosen engine does not port and what the CUDA kernel cannot
        hold."""
        p = self.params
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
                "PrintDominantData", "PrintResourceData", "SavePopulation",
                "LoadPopulation", "SetResource", "CompeteDemes",
                "ReplicateDemes", "Pred_DemeResourceThresholdPredicate",
                "InjectParasite", "KillProb", "SerialTransfer",
                "PrintFitnessData", "PrintStatsData", "PrintData",
                "PrintInstructionAbundanceHistogram", "PrintDepthHistogram",
                "PrintGenotypeAbundanceHistogram", "PrintTasksExeData",
                "PrintTasksQualData")

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
        ops/demes._clone_reset with all cells selected; this package's
        demes.clone_reset)."""
        st = self.state
        n = self.params.num_cells
        full = torch.ones(n, dtype=torch.bool, device=self.device)
        genome = torch.from_numpy(gm).to(self.device)[None, :].expand(n, -1)
        return st.replace(**deme_ops.clone_reset(
            self.params, st, full, genome,
            torch.full((n,), glen, dtype=torch.int32, device=self.device),
            full, torch.full((n,), float(glen), dtype=torch.float32,
                             device=self.device), key))

    def _action_InjectParasite(self, args):
        """InjectParasite [filename [label [cell_start [cell_end]]]] (ref
        cActionInjectParasite): the parasite genome -- by default the
        stock transsmt parasite -- into the parasite memory space of every
        living, uninfected organism in cells [start, end)."""
        if args and args[0] not in ("-", ""):
            genome = self._resolve_org_path(args[0])
        else:
            genome = default_parasite(self.instset)
        start = int(args[2]) if len(args) > 2 else 0
        end = int(args[3]) if len(args) > 3 else start + 1
        cells = torch.arange(self.params.num_cells, device=self.device)
        self.inject_parasite(genome, (cells >= start) & (cells < end))

    def inject_parasite(self, genome: np.ndarray, cells: torch.Tensor):
        """InjectParasite's placement on the bool[N] mask `cells`: the
        living, uninfected organisms there take `genome` as their
        parasite, its thread at (space 2, position 0)."""
        from avida_tpu_torch.ops.birth import _set_thread, _where_rows
        st = self.state
        sel = cells & st.alive & ~st.parasite_active
        g = np.zeros(self.params.max_memory, np.uint8)
        g[:len(genome)] = np.asarray(genome).astype(np.uint8)
        self.state = st.replace(
            pmem=_where_rows(sel, torch.from_numpy(g).to(self.device)[None],
                             st.pmem),
            pmem_len=torch.where(sel, len(genome), st.pmem_len),
            parasite_active=st.parasite_active | sel,
            smt_head_pos=_set_thread(st.smt_head_pos, 1, sel, 0),
            smt_head_space=_set_thread(st.smt_head_space, 1, sel, 2))

    def _action_KillProb(self, args):
        """KillProb [prob]: each living organism dies with probability p
        (cActionKillProb, actions/PopulationActions.cc): one uniform draw
        a cell from a split of the world key."""
        p = float(args[0]) if args else 0.9
        die = prng.uniform(self._split_key(), (self.params.num_cells,)) \
            < prng.round_f32(p)
        self.state = self.state.replace(alive=self.state.alive & ~die)

    def _action_SerialTransfer(self, args):
        """SerialTransfer [transfer_size]: keep a uniform random sample of
        transfer_size organisms and kill the rest (cActionSerialTransfer):
        the living cells whose draw reaches the transfer_size-th largest
        (ties keep more).  A size past the world keeps every organism:
        the index clamps to the smallest score, as the reference's does."""
        size = int(args[0]) if args else 1
        st = self.state
        n = self.params.num_cells
        u = prng.uniform(self._split_key(), (n,))
        score = torch.where(st.alive, u, -1.0)
        at = -size + n if size > 0 else -size
        kth = torch.sort(score).values[min(max(at, 0), n - 1)]
        self.state = st.replace(alive=st.alive & (score >= kth))

    def _action_Exit(self, args):
        self._exit = True

    # ---- resources and demes ----

    def _action_PrintResourceData(self, args):
        """resource.dat: each global pool's level and each spatial pool's
        total over the cells (ref PrintResourceData)."""
        names = ([r.name for r in self.environment.global_resources()]
                 + [r.name for r in self.environment.spatial_resources()])
        if not names:
            return
        f = self._file("resource", output_mod.open_resource_dat, names)
        levels = [float(x) for x in self.state.resources.cpu().numpy()]
        if self.params.num_spatial_res:
            # numpy's float32 total, as the reference takes it
            levels += [float(x) for x in
                       self.state.res_grid.cpu().numpy().sum(axis=1)]
        f.write_row([self.update, float(self._avida_time)] + levels)

    def _action_SetResource(self, args):
        """SetResource <name> <level> (ref EnvironmentActions.cc): a
        global pool's level, or a spatial pool spread evenly over the
        cells."""
        name, level = args[0], float(args[1])
        st = self.state
        for i, r in enumerate(self.environment.global_resources()):
            if r.name == name:
                res = st.resources.clone()
                res[i] = level
                self.state = st.replace(resources=res)
                return
        for i, r in enumerate(self.environment.spatial_resources()):
            if r.name == name:
                grid = st.res_grid.clone()
                grid[i] = level / self.params.num_cells
                self.state = st.replace(res_grid=grid)
                return

    def _action_CompeteDemes(self, args):
        """CompeteDemes [competition_type] (ref cPopulation::CompeteDemes):
        fitness-proportional deme selection and wholesale replacement."""
        ctype = int(args[0]) if args else self.cfg.DEMES_COMPETITION_STYLE
        k = self._split_key()
        self.state = deme_ops.compete_demes(self.params, self.state, k,
                                            ctype)

    _REP_TRIGGERS = {"all": 0, "full_deme": 1, "full": 1, "corners": 2,
                     "deme-age": 3, "age": 3, "births": 4,
                     "sat-deme-predicate": 5}

    def _action_ReplicateDemes(self, args):
        """ReplicateDemes [trigger] (ref cPopulation::ReplicateDemes)."""
        trig = str(args[0]) if args else "full"
        trig = int(trig) if trig.isdigit() else self._REP_TRIGGERS.get(trig)
        if trig is None:
            raise ValueError(f"unknown ReplicateDemes trigger {args[0]!r}")
        k = self._split_key()
        self.state = deme_ops.replicate_demes(
            self.params, self.state, k, trig,
            predicates=tuple(self._deme_predicates))

    def _action_Pred_DemeResourceThresholdPredicate(self, args):
        """`<resource> <op> <value>`: a deme resource-threshold predicate
        (cActionPred_DemeResourceThresholdPredicate,
        PopulationActions.cc:4421) for ReplicateDemes
        sat-deme-predicate."""
        name, op, value = args[0], args[1], float(args[2])
        dres = [r.name for r in self.environment.deme_resources()]
        if name not in dres:
            raise ValueError(
                f"deme resource {name!r} not defined (have {dres})")
        self._deme_predicates.append((dres.index(name), op, value))

    def _action_LoadPopulation(self, args):
        """LoadPopulation <file.spop> (ref cActionLoadPopulation,
        actions/SaveLoadActions.cc:289 -> cPopulation::LoadPopulation
        cc:6723): rebuild the population from a structured save."""
        from avida_tpu_torch.utils import spop
        path = args[0]
        if self.config_dir and not os.path.isabs(path) \
                and not os.path.exists(path):
            path = os.path.join(self.config_dir, args[0])
        if not os.path.exists(path) and not os.path.isabs(args[0]):
            cand = os.path.join(self.data_dir, args[0])
            if os.path.exists(cand):
                path = cand
        k = self._split_key()
        orgs = spop.load_population(path, self.params, k)
        self.state = spop.restore_population(self.params, orgs, k)
        # per-cell task-execution lifetime totals ride a sidecar written
        # by SavePopulation (absent sidecar -> totals restart at zero)
        side = path + ".tasks.npy"
        if os.path.exists(side):
            totals = np.load(side)
            if totals.shape == tuple(self.state.task_exe_total.shape):
                self.state = self.state.replace(
                    task_exe_total=torch.from_numpy(
                        totals.astype(np.int32)).to(self.device))
        self._reset_task_exe_baseline()
        if self.systematics is not None:
            self.systematics = GenotypeArbiter(self.params.num_cells)
            for o in orgs:
                self.systematics.classify_seed(o["cell"], o["genome"],
                                               update=self.update)

    def _reset_task_exe_baseline(self):
        """Seed the tasks_exe diff baseline from the CURRENT state, after
        the state was reloaded wholesale (LoadPopulation)."""
        self._summary_cache_update = None
        self._task_exe_prev = self.state.task_exe_total.sum(
            dim=0).cpu().numpy().astype(np.int64)
        if self.telemetry is not None:
            self.telemetry.seed_task_totals(self._task_exe_prev)

    def _action_SavePopulation(self, args):
        from avida_tpu_torch.utils import spop
        os.makedirs(self.data_dir, exist_ok=True)
        path = os.path.join(self.data_dir, f"detail-{self.update}.spop")
        spop.save_population(path, self.params, self.state, self.update)
        # sidecar: per-cell task-execution lifetime totals (not in the
        # .spop columns), so a LoadPopulation keeps them
        np.save(path + ".tasks.npy",
                self.state.task_exe_total.detach().cpu().numpy())

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

    def _action_PrintFitnessData(self, args):
        """fitness.dat (ref cActionPrintFitnessData,
        actions/PrintActions.cc:1380): update, generation, average and
        maximum fitness, organism count."""
        s = self._summary()
        f = self._file("fitness", output_mod.open_fitness_dat)
        f.write_row([self.update, float(s["ave_generation"]),
                     float(s["ave_fitness"]), float(s["max_fitness"]),
                     int(s["num_organisms"])])

    def _action_PrintStatsData(self, args):
        """stats.dat (ref cActionPrintStatsData): population age, the
        live genotypes' Shannon entropy, gestation, genotype counts
        (zeros without systematics)."""
        import math
        s = self._summary()
        f = self._file("stats", output_mod.open_stats_dat)
        sysm = self.systematics
        entropy, num_gt, dom_abund = 0.0, 0, 0
        if sysm is not None and sysm.num_genotypes:
            counts = [g.num_units for g in sysm.live_genotypes()]
            total = sum(counts) or 1
            entropy = -sum((c / total) * math.log(c / total)
                           for c in counts if c > 0)
            num_gt = sysm.num_genotypes
            dom = sysm.dominant()
            dom_abund = dom.num_units if dom else 0
        f.write_row([self.update, float(s["ave_age"]), entropy,
                     float(s["ave_gestation"]), num_gt, dom_abund])

    def _action_PrintData(self, args):
        """`PrintData <file> <id,id,...>` (ref cActionPrintData,
        actions/PrintActions.cc:389): the registered data IDs as the
        columns of a .dat file."""
        if len(args) < 2:
            return
        fname, fmt = args[0], args[1]
        key = f"printdata:{fname}"
        if key not in self._files:
            ids = [i.strip() for i in fmt.split(",") if i.strip()]
            specs = [(i, self.data.describe(i) if i != "core.update"
                      else "Update") for i in ids]
            self._files[key] = DatRecorder(self.data_dir, fname,
                                           "Avida data", specs,
                                           append=self._dat_append)
        self._files[key].record(self.update, self.data)

    def _dat(self, name, fname, title, cols, preamble=None):
        """The named DatFile in the data dir, opened on first use."""
        return self._file(name, lambda d, append: output_mod.DatFile(
            os.path.join(d, fname), title, cols, preamble=preamble,
            append=append))

    def _action_PrintInstructionAbundanceHistogram(self, args):
        """instruction_histogram.dat: per-opcode counts across the live
        genomes (cActionPrintInstructionAbundanceHistogram)."""
        f = self._dat("inst_hist", args[0] if args
                      else "instruction_histogram.dat",
                      "Avida instruction abundance histogram",
                      ["Update"] + list(self.instset.inst_names))
        f.write_row([self.update] + [int(x)
                                     for x in instruction_abundance(self)])

    def _action_PrintDepthHistogram(self, args):
        """depth_histogram.dat rows: update, depth, genotype count."""
        f = self._dat("depth_hist", args[0] if args
                      else "depth_histogram.dat", "Avida depth histogram",
                      ["Update", "Depth", "Number of genotypes"])
        for depth, count in depth_histogram(self).items():
            f.write_row([self.update, depth, count])

    def _action_PrintGenotypeAbundanceHistogram(self, args):
        """genotype_abundance_histogram.dat rows: update, abundance,
        genotype count."""
        f = self._dat("abund_hist", args[0] if args
                      else "genotype_abundance_histogram.dat",
                      "Avida genotype abundance histogram",
                      ["Update", "Abundance", "Number of genotypes"])
        for ab, count in abundance_histogram(self).items():
            f.write_row([self.update, ab, count])

    def _action_PrintTasksExeData(self, args):
        """tasks_exe.dat (cActionPrintTasksExeData): each task's
        executions this update, the host diff of the per-cell lifetime
        totals against the last row's (reset on a reload)."""
        s = self._summary()
        f = self._dat(
            "tasks_exe", "tasks_exe.dat", "Avida tasks execution data",
            ["Update"] + [t.capitalize()
                          for t in self.environment.task_names()],
            preamble=["First column gives the current update, all "
                      "further columns give the number",
                      "of times the particular task has been executed "
                      "this update."])
        totals = np.asarray(s["task_exe_totals"], np.int64)
        prev = (self._task_exe_prev if self._task_exe_prev is not None
                else np.zeros_like(totals))
        self._task_exe_prev = totals
        f.write_row([self.update] + [int(x) for x in (totals - prev)])

    def _action_PrintTasksQualData(self, args):
        """tasks_quality.dat (cActionPrintTasksQualData): average and max
        task quality, binary as in the reference (1 when any organism's
        last gestation performed the task)."""
        s = self._summary()
        f = self._dat(
            "tasks_qual", "tasks_quality.dat", "Avida tasks quality data",
            ["Update"] + [f"{t.capitalize()} {m}"
                          for t in self.environment.task_names()
                          for m in ("Average", "Max")],
            preamble=["First column gives the current update, rest "
                      "give average and max task quality"])
        row = [self.update]
        for c in s["task_counts"]:
            row += [1 if c else 0, 1 if c else 0]
        f.write_row(row)

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
        tensor).  With the integrity plane armed, the chunk's digest (and,
        on every TPU_SCRUB_EVERY-th chunk, its shadow replay) follows."""
        if self.state is None:
            raise RuntimeError("no population injected")
        self._load_kernel()
        if self.profiler is not None:
            self.profiler.chunk_begin(k)
        pre = None
        if self._scrub_every > 0:
            self._chunk_no += 1
            if self._chunk_no % self._scrub_every == 0:
                # the pre-chunk state, kept for the shadow replay
                pre = (clone_state(self.state), self.update)
        self.state, (executed, births, deaths, dts, ave_gens, n_alive) = \
            update_scan(self.params, self.state, k, self._run_key,
                        self.update, self.neighbors)
        # avida time advances by 1/ave_gestation per update
        self._avida_time = self._avida_time + prng.xla_f32_sum(dts)
        self._last_ave_gen = ave_gens[-1]
        self._deaths_this = deaths[-1]
        self._prev_alive = n_alive[-1]
        self._total_births = self._total_births + births.sum()
        if self.profiler is not None:
            # probe chunks fence and stage a phase probe on a copy
            self.profiler.chunk_end_solo(self, k)
        if self._digest_on or pre is not None:
            self._integrity_boundary(k, pre)
        return executed

    # ---- the integrity plane: state digests and the scrub ----

    def _shadow_params(self):
        """Params for the shadow replay: without the injected device
        faults (nan / bitflip model a transient hardware event, which
        fires in the live execution only)."""
        p = self.params
        if p.fault_nan or p.fault_bitflip:
            return p.replace(fault_nan=(), fault_bitflip=())
        return p

    def _engine_name(self) -> str:
        """The chunk engine just run, named in divergence errors."""
        if not cycles.use_kernel(self.params):
            return "micro-step"
        return ("kernel-packed" if packed_chunk.active(self.params,
                                                       self.state)
                else "kernel")

    def _integrity_record(self, event: str, **fields):
        integrity.append_integrity_record(
            self.data_dir, event,
            max_bytes=int(self.cfg.get("TPU_RUNLOG_MAX_BYTES", 16 << 20)),
            **fields)

    def _resolve_digest(self, pending):
        """Read back one deferred digest (its chunk finished a boundary
        ago) into state_digest and an integrity.jsonl record."""
        import time as _time
        u, dev = pending
        t0 = _time.monotonic()
        val = int(dev)
        integrity.note_digest_ms((_time.monotonic() - t0) * 1e3)
        self.state_digest = (u, val)
        self._integrity_record("digest", update=u, digest=f"{val:#010x}")

    def _flush_digest(self):
        """Resolve any deferred digest now (checkpoint save, run exit)."""
        prev, self._digest_pending = self._digest_pending, None
        if prev is not None:
            self._resolve_digest(prev)

    def _integrity_boundary(self, k: int, pre):
        """Right after the chunk, before any host-side change of the
        state: the live digest (read back one boundary later), and when
        the chunk was sampled for a scrub (`pre` holds the pre-chunk
        state) its replay from `pre`, compared digest to digest.  On this
        deterministic engine any difference is corruption -- or a kernel
        that is not deterministic -- raised as StateDivergenceError."""
        import time as _time

        from avida_tpu_torch.ops.digest import state_digest
        u1 = self.update + k
        t0 = _time.monotonic()
        d_live = state_digest(self.state)
        integrity.note_digest_ms((_time.monotonic() - t0) * 1e3)
        self._flush_digest()
        if pre is None:
            self._digest_pending = (u1, d_live)
            return
        pre_st, u0 = pre
        integrity.note_scrub()
        shadow_st, _ = update_scan(self._shadow_params(), pre_st, k,
                                   self._run_key, u0, self.neighbors)
        t0 = _time.monotonic()
        live, shad = int(d_live), int(state_digest(shadow_st))
        integrity.note_digest_ms((_time.monotonic() - t0) * 1e3)
        if live != shad:
            integrity.note_mismatch()
            engine = self._engine_name()
            self._integrity_record(
                "scrub", update=u1, chunk_updates=k, ok=False,
                live=f"{live:#010x}", shadow=f"{shad:#010x}",
                engine=engine,
                last_verified_update=self._last_verified_update)
            from avida_tpu_torch.observability.runlog import emit_event
            emit_event(self, "state_divergence", update=u1,
                       live=f"{live:#010x}", shadow=f"{shad:#010x}")
            raise integrity.StateDivergenceError(
                f"silent state divergence in updates [{u0}, {u1}): live "
                f"digest {live:#010x} != shadow replay {shad:#010x} "
                f"(engine {engine}, "
                f"last_verified_update={self._last_verified_update})")
        self._last_verified_update = u1
        if self._digest_on:
            self.state_digest = (u1, live)
            self._integrity_record("digest", update=u1,
                                   digest=f"{live:#010x}")
        self._integrity_record("scrub", update=u1, chunk_updates=k,
                               ok=True, digest=f"{live:#010x}")

    def run_updates(self, k: int):
        """k updates as one stretch; advances self.update by k."""
        executed = self._scan_updates(k)
        self.update += k
        return executed

    def run_update(self):
        """ONE update, then the reversion test and the synchronous
        systematics feed (does not advance self.update; the caller
        does).  Under telemetry the update runs phase-fenced through the
        recorder and an update record lands in telemetry.jsonl."""
        tel = self.telemetry
        if tel is not None:
            self._load_kernel()
            executed = tel.update(self)
            if self._revert_on:
                with tel.timeline.phase("host_revert"):
                    self._apply_reversion()
            if self.systematics is not None:
                with tel.timeline.phase("host_systematics"):
                    self._feed_systematics()
            tel.emit(self)
            return executed
        executed = self._scan_updates(1)
        if self._revert_on:
            self._apply_reversion()
        if self.systematics is not None:
            self._feed_systematics()
        return executed

    def _apply_reversion(self):
        """Offspring fitness test (Divide_TestFitnessMeasures,
        cHardwareBase.cc:866; the reference's World._apply_reversion):
        each newborn of this update is classified fatal / detrimental /
        neutral / beneficial by its sandbox fitness against its parent's
        (thresholds from NEUTRAL_MIN/MAX), then reverted to its parent's
        genome or sterilized (it lives but never divides) with the
        REVERT_* / STERILIZE_* probabilities.  A newborn whose parent
        cell was overwritten this update cannot be reverted: a fatal one
        is killed, others are admitted as they are.  Only the newborn and
        parent rows are read from the device.  `last_reversion` gets the
        step's counts and host times."""
        import time as _time
        from avida_tpu_torch.ops.interpreter import pack_tape

        def host(x):
            return x.detach().cpu().numpy()

        t0 = _time.perf_counter()
        st = self.state
        dev = self.device
        alive = host(st.alive)
        born = (host(st.birth_update) == self.update) & alive
        cells = np.nonzero(born)[0]
        rec = {"newborns": int(cells.size), "reverted": 0, "sterilized": 0,
               "killed": 0}
        self.last_reversion = rec
        if not cells.size:
            return
        idx = torch.from_numpy(cells).to(dev)
        parents = host(st.parent_id[idx])
        pidx = torch.from_numpy(np.clip(parents, 0, None)).to(dev)
        child_g = host(st.genome[idx])
        child_l = host(st.genome_len[idx])
        par_g = host(st.genome[pidx])
        par_l = host(st.genome_len[pidx])
        parent_ok = ((parents >= 0) & alive[np.clip(parents, 0, None)]
                     & (host(st.birth_update[pidx]) != self.update))
        t1 = _time.perf_counter()
        child_fit = self.test_metrics.get_fitness(child_g, child_l)
        rec["child"] = dict(self.test_metrics.last_stats)
        t2 = _time.perf_counter()
        parent_fit = self.test_metrics.get_fitness(par_g, par_l)
        rec["parent"] = dict(self.test_metrics.last_stats)
        t3 = _time.perf_counter()
        rec["child"]["ms"] = (t2 - t1) * 1e3
        rec["parent"]["ms"] = (t3 - t2) * 1e3
        neut_min = parent_fit * self._neut_min
        neut_max = parent_fit * self._neut_max
        cat = np.where(child_fit == 0.0, 0,
                       np.where(child_fit < neut_min, 1,
                                np.where(child_fit <= neut_max, 2, 3)))
        probs = np.asarray([self._revert["fatal"], self._revert["neg"],
                            self._revert["neut"], self._revert["pos"]],
                           np.float64)                      # [4, 2]
        u = self._revert_rng.random((2, cells.size))
        want_revert = u[0] < probs[cat, 0]
        revert = want_revert & parent_ok
        sterilize = u[1] < probs[cat, 1]
        # fatal reversions with no parent genome left are refused outright
        kill_fallback = want_revert & ~parent_ok & (cat == 0)
        if self.tracer is not None:
            # the firings as host events of the flight recorder, merged
            # into the next drain's per-update records
            from avida_tpu_torch.observability.tracer import (EV_REVERT,
                                                              EV_STERILIZE)
            for c, pc in zip(cells[revert], parents[revert]):
                self.tracer.record_host_event(self.update, int(c),
                                              EV_REVERT, int(pc))
            for c, cc in zip(cells[sterilize], cat[sterilize]):
                self.tracer.record_host_event(self.update, int(c),
                                              EV_STERILIZE, int(cc))
        rec.update(reverted=int(revert.sum()),
                   sterilized=int(sterilize.sum()),
                   killed=int(kill_fallback.sum()),
                   cells=cells, revert=revert, sterilize=sterilize,
                   kill=kill_fallback, parents=parents, category=cat)
        if revert.any() or sterilize.any() or kill_fallback.any():
            new = {}
            if revert.any():
                rc = torch.from_numpy(cells[revert]).to(dev)
                rp = torch.from_numpy(parents[revert]).to(dev)
                pg = st.genome[rp]
                pl = st.genome_len[rp]
                for name, val in (("genome", pg), ("tape", pack_tape(pg)),
                                  ("genome_len", pl), ("mem_len", pl),
                                  ("breed_true", True)):
                    new[name] = getattr(st, name).clone()
                    new[name][rc] = val
            if sterilize.any():
                # the offspring lives (occupying its cell, competing for
                # space) but can never divide
                new["sterile"] = st.sterile.clone()
                new["sterile"][torch.from_numpy(cells[sterilize]).to(dev)] \
                    = True
            if kill_fallback.any():
                new["alive"] = st.alive.clone()
                new["alive"][torch.from_numpy(cells[kill_fallback]).to(dev)] \
                    = False
            self.state = st.replace(**new)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec["apply_ms"] = (_time.perf_counter() - t3) * 1e3
        rec["gather_ms"] = (t1 - t0) * 1e3

    def _chunkable(self) -> bool:
        """May event-free stretches run as one chunk?  The reversion test
        and telemetry's phase fencing need the host after every update,
        as do generation / births event triggers (the reference's rule;
        MultiWorld refuses what is not chunkable)."""
        return (not self._revert_on and self.telemetry is None
                and not any(ev.trigger in ("generation", "births")
                            for ev in self.events))

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

    def _flush_trace(self):
        """Drain the deferred flight-recorder snapshot AND the live ring
        now (a host sync point: run exit, checkpoint save), so the runlog
        holds every event up to the boundary before the state, with its
        zeroed cursor, is saved or the process exits."""
        if self.tracer is None:
            return
        prev, self._trace_pending = self._trace_pending, None
        if prev is not None:
            self.tracer.drain(prev)
        if self.state is not None:
            self.tracer.drain(self.tracer.snapshot(self))

    # ---- persistence: native checkpoints and preemption ----

    def _ckpt_base(self) -> str | None:
        d = str(self.cfg.get("TPU_CKPT_DIR", "-") or "-")
        return None if d in ("-", "") else d

    def _load_kernel(self):
        """Before this world's first update on the card's kernel route:
        load the cycle library through the program cache with this
        world's config, journaling through _compile_cache_log (cycles.
        load: one decision per process, later worlds reuse it).  Under
        telemetry the run log is opened first, so the events land in
        telemetry.jsonl."""
        if self._kernel_checked:
            return
        self._kernel_checked = True
        if self.device.type != "cuda" or not cycles.use_kernel(self.params):
            return
        if self.telemetry is not None:
            self.telemetry._ensure()
        cycles.load(self.cfg, self._compile_cache_log)

    def _compile_cache_log(self, **fields):
        """Journal one program-cache action as a {"record": "event",
        "event": "compile_cache"} runlog line: load / compile / store are
        the warmth evidence; corrupt / stale / store_failed the loud
        invalidation trail (utils/compilecache.py)."""
        from avida_tpu_torch.observability.runlog import emit_event
        emit_event(self, "compile_cache", **fields)

    def _install_preempt_handlers(self):
        """SIGTERM/SIGINT set a flag that run() checks at chunk
        boundaries (drain, final checkpoint, return); a second SIGINT
        raises KeyboardInterrupt.  Returns the displaced handlers; a no-op
        off the main thread."""
        import signal
        saved = {}

        def trip(signum, frame):
            if self._preempt and signum == signal.SIGINT:
                raise KeyboardInterrupt
            self._preempt = True

        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                saved[s] = signal.signal(s, trip)
            except ValueError:
                pass
        return saved

    def _audit_on(self, audit) -> bool:
        if audit is None:
            return bool(int(self.cfg.get("TPU_CKPT_AUDIT", 1)))
        return bool(audit)

    def save_checkpoint(self, base_dir: str | None = None,
                        audit: bool | None = None) -> str:
        """Write one native checkpoint generation (the whole state, the
        PRNG keys, the host counters, the event cursors, the phylogeny)
        in the reference's format.  Atomic; rolling retention
        TPU_CKPT_KEEP.  audit=None follows TPU_CKPT_AUDIT (default 1):
        the invariant audit runs first.  Returns the generation path."""
        from avida_tpu_torch.utils import checkpoint as ckpt_mod
        base = base_dir or self._ckpt_base()
        if base is None:
            raise ValueError(
                "no checkpoint directory (set TPU_CKPT_DIR or pass one)")
        # the phylogeny must be current before it is serialized, and the
        # flight recorder's ring drained (the saved cursor is then 0)
        self._flush_newborn_drain()
        self._flush_trace()
        self._flush_digest()
        if self._audit_on(audit):
            from avida_tpu_torch.utils.audit import check_invariants
            check_invariants(self.params, self.state,
                             where=f"checkpoint save (update {self.update})")
        path = ckpt_mod.save_checkpoint(base, self)
        if self.faults is not None:
            # corrupt-ckpt / torn-manifest / corrupt-digest damage the
            # generation just published
            self.faults.at_save(self, path)
        return path

    def resume(self, ckpt_dir: str | None = None,
               audit: bool | None = None,
               at_update: int | None = None) -> int:
        """Restore this world from the newest VALID checkpoint generation
        (or the one at `at_update`) and position the run loop to continue
        bit for bit.  Corrupt generations fall back to the previous
        retained one.  The .dat files keep their rows before the restored
        update and are extended from there.  Returns the restored
        update."""
        from avida_tpu_torch.observability.runlog import trim_update_records
        from avida_tpu_torch.utils import checkpoint as ckpt_mod
        base = ckpt_dir or self._ckpt_base()
        if base is None:
            raise ValueError(
                "no checkpoint directory (set TPU_CKPT_DIR or pass one)")
        update = ckpt_mod.restore_checkpoint(base, self, at_update=at_update)
        self._dat_append = True
        output_mod.trim_dat_rows(self.data_dir, update)
        # per-update run logs a reference run may have left in data_dir
        trim_update_records(os.path.join(self.data_dir, "telemetry.jsonl"),
                            update)
        ana_log = os.path.join(self.data_dir, "analysis", "analytics.jsonl")
        trim_update_records(ana_log, update)
        trim_update_records(ana_log + ".1", update)
        if self._audit_on(audit):
            from avida_tpu_torch.utils.audit import check_invariants
            check_invariants(self.params, self.state,
                             where=f"checkpoint restore (update {update})")
        # the restored generation passed its digest check
        self._last_verified_update = update
        return update

    def run(self, max_updates: int | None = None) -> int:
        """Run until Exit, `max_updates` or preemption; returns the
        instructions executed by this call.  With TPU_CKPT_DIR set,
        SIGTERM/SIGINT stop the run at the next chunk boundary with a
        final checkpoint (`preempted` is then True), TPU_CKPT_EVERY saves
        every so many updates and TPU_CKPT_FINAL=1 saves the end state;
        TPU_AUDIT_EVERY audits the state every so many updates."""
        if self.state is None:
            self.process_events()
            if self.state is None:
                self.inject()
        start_insts = self._cum_insts
        ckpt_base = self._ckpt_base()
        ckpt_every = int(self.cfg.get("TPU_CKPT_EVERY", 0))
        audit_every = int(self.cfg.get("TPU_AUDIT_EVERY", 0))
        self.preempted = False
        self._preempt = False
        handlers = self._install_preempt_handlers() if ckpt_base else {}
        last_ckpt = self.update
        last_audit = self.update
        can_chunk = self._chunkable()
        max_stretch = int(self.cfg.get("TPU_MAX_STRETCH", 0))
        try:
            while not self._exit and not self._preempt:
                if max_updates is not None and self.update >= max_updates:
                    break
                if self._nb_pending is not None and self._events_fire_now():
                    # the phylogeny must be current before a Print reads it
                    self._flush_newborn_drain()
                if self.telemetry is not None:
                    # the .dat writes and their readbacks: the "host I/O"
                    # share of the next record
                    with self.telemetry.timeline.phase("events_io"):
                        self.process_events()
                else:
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
                if self.tracer is not None:
                    # the ring's deferred drain: snapshot this boundary's
                    # ring (device copies), ingest the previous one's
                    prev_t, self._trace_pending = (self._trace_pending,
                                                   self.tracer.snapshot(self))
                    if prev_t is not None:
                        self.tracer.drain(prev_t)
                if self.exporter is not None:
                    # publishes the PREVIOUS boundary's values (no fence)
                    self.exporter.export_deferred(self)
                if len(self._pending_exec) >= 256:
                    self._flush_exec()
                if self.systematics is not None and self.update % 100 == 0:
                    self._flush_newborn_drain()
                    self.systematics.prune_extinct(keep_ancestry=True)
                # at chunk boundaries: the periodic audit and the auto-save
                if audit_every and self.update - last_audit >= audit_every:
                    from avida_tpu_torch.utils.audit import check_invariants
                    check_invariants(self.params, self.state,
                                     where=f"update {self.update}")
                    last_audit = self.update
                if ckpt_base and ckpt_every \
                        and self.update - last_ckpt >= ckpt_every:
                    self.save_checkpoint(ckpt_base)
                    last_ckpt = self.update
                    if self.analytics is not None:
                        # a checkpoint boundary is a census boundary
                        self.analytics.refresh(self)
                if self.faults is not None:
                    # injected failures fire at chunk boundaries, after
                    # any auto-save due at the same boundary
                    self.faults.at_boundary(self)
            # orderly exit (normal or preempted); neither the drain nor the
            # final checkpoint runs after an exception
            self._flush_newborn_drain()
            self._flush_trace()
            self._flush_digest()
            if self._preempt and ckpt_base and self.state is not None:
                self.save_checkpoint(ckpt_base)
            elif ckpt_base and self.state is not None \
                    and int(self.cfg.get("TPU_CKPT_FINAL", 0)) \
                    and self.update != last_ckpt:
                self.save_checkpoint(ckpt_base)
            self.preempted = self._preempt
            if self.analytics is not None and self.state is not None:
                # the exit census (durable: the run's last word)
                self.analytics.refresh(self, durable=True)
            if self.profiler is not None and self.state is not None:
                # the closing footprint, before the final heartbeat
                self.profiler.final(self.state, self.update,
                                    params=self.params)
            if self.exporter is not None and self.state is not None:
                self.exporter.export(self)    # final heartbeat (preempted=1)
        finally:
            import signal as _signal
            for sig, h in handlers.items():
                try:
                    _signal.signal(sig, h)
                except (ValueError, OSError):
                    pass
            for f in self._files.values():
                try:
                    f.close()
                except OSError as e:
                    print(f"[avida_tpu_torch] warning: closing {f.path}: "
                          f"{e}", file=sys.stderr)
            self._files = {}
            # the run logs are closed on any exit path, so a crash never
            # loses the buffered tail of telemetry.jsonl
            for host in (self.telemetry, self.tracer):
                if host is not None:
                    try:
                        host.close()
                    except Exception:
                        pass
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
