"""Typed configuration system for avida-tpu.

Re-expresses the reference's macro-reflected flag system (cAvidaConfig,
avida-core/source/main/cAvidaConfig.h:71-854 -- 428 vars in ~40 groups) as a
Python dataclass with the same variable names, defaults and `avida.cfg` file
format, so reference config files load unmodified.  Command-line `-set NAME
VALUE` overrides mirror Avida::Util::ProcessCmdLineArgs
(avida-core/source/util/CmdLine.cc:205).

Only a subset of variables is interpreted by the engine today; unknown
variables found in a config file are retained in `extras` (and warn once) so
that round-tripping and forward-compat both work.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field, fields


def _parse_scalar(text: str):
    text = text.strip()
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


@dataclass
class AvidaConfig:
    # --- General group (cAvidaConfig.h:283+) ---
    VERBOSITY: int = 1
    RANDOM_SEED: int = -1
    SPECULATIVE: int = 1            # subsumed by lockstep batching on TPU
    POPULATION_CAP: int = 0
    POP_CAP_ELDEST: int = 0

    # --- World/topology ---
    WORLD_X: int = 60
    WORLD_Y: int = 60
    WORLD_GEOMETRY: int = 2         # nGeometry.h:30-37: 1=grid, 2=torus,
                                    # 3=clique, 4=hex, 6=lattice(z=1),
                                    # 7=random-connected, 8=scale-free
    SCALE_FREE_M: int = 3           # connections per new cell (geometry 8)
    SCALE_FREE_ALPHA: float = 1.0   # attachment power (1=linear)
    SCALE_FREE_ZERO_APPEAL: float = 0.0  # appeal of zero-degree cells
    # --- energy model (cAvidaConfig.h:649-667) ---
    ENERGY_ENABLED: int = 0
    ENERGY_GIVEN_ON_INJECT: float = 0.0
    ENERGY_GIVEN_AT_BIRTH: float = 0.0
    FRAC_PARENT_ENERGY_GIVEN_TO_ORG_AT_BIRTH: float = 0.5
    FRAC_ENERGY_DECAY_AT_ORG_BIRTH: float = 0.0
    ENERGY_CAP: float = -1.0
    NUM_CYCLES_EXC_BEFORE_0_ENERGY: int = 200
    FIX_METABOLIC_RATE: float = -1.0
    DISPERSAL_RATE: float = 1.0

    # --- File paths ---
    DATA_DIR: str = "data"
    EVENT_FILE: str = "events.cfg"
    ANALYZE_FILE: str = "analyze.cfg"
    ENVIRONMENT_FILE: str = "environment.cfg"

    # --- Mutation rates (cAvidaConfig.h mutation group) ---
    COPY_MUT_PROB: float = 0.0075
    COPY_INS_PROB: float = 0.0
    COPY_DEL_PROB: float = 0.0
    COPY_UNIFORM_PROB: float = 0.0
    COPY_SLIP_PROB: float = 0.0
    POINT_MUT_PROB: float = 0.0
    POINT_INS_PROB: float = 0.0
    POINT_DEL_PROB: float = 0.0
    DIV_MUT_PROB: float = 0.0
    DIV_INS_PROB: float = 0.0
    DIV_DEL_PROB: float = 0.0
    DIV_SLIP_PROB: float = 0.0
    DIVIDE_MUT_PROB: float = 0.0
    DIVIDE_INS_PROB: float = 0.05
    DIVIDE_DEL_PROB: float = 0.05
    DIVIDE_UNIFORM_PROB: float = 0.0
    DIVIDE_SLIP_PROB: float = 0.0
    INJECT_INS_PROB: float = 0.0
    INJECT_DEL_PROB: float = 0.0
    INJECT_MUT_PROB: float = 0.0
    PARENT_MUT_PROB: float = 0.0
    SLIP_FILL_MODE: int = 0
    MUT_RATE_SOURCE: int = 1

    # --- Birth / divide ---
    DIVIDE_FAILURE_RESETS: int = 0
    BIRTH_METHOD: int = 0           # 0=random in neighborhood (Definitions.h:67-82)
    PREFER_EMPTY: int = 1
    ALLOW_PARENT: int = 1
    DEATH_PROB: float = 0.0
    DEATH_METHOD: int = 2           # 2=die at genome_length*AGE_LIMIT insts
    AGE_LIMIT: int = 20
    AGE_DEVIATION: int = 0
    JUV_PERIOD: int = 0
    ALLOC_METHOD: int = 0           # 0=fill with default inst (op 0)
    DIVIDE_METHOD: int = 1          # 1=SPLIT: parent reset (2 offspring)
    EPIGENETIC_METHOD: int = 0
    GENERATION_INC_METHOD: int = 1  # both parent+child
    RESET_INPUTS_ON_DIVIDE: int = 0
    INHERIT_MERIT: int = 1
    INHERIT_MULTITHREAD: int = 0

    # --- Divide restrictions ---
    OFFSPRING_SIZE_RANGE: float = 2.0
    MIN_COPIED_LINES: float = 0.5
    MIN_EXE_LINES: float = 0.5
    MIN_GENOME_SIZE: int = 0
    MAX_GENOME_SIZE: int = 0
    MIN_CYCLES: int = 0
    REQUIRE_ALLOCATE: int = 1
    REQUIRED_TASK: int = -1
    REQUIRED_REACTION: int = -1
    REQUIRE_SINGLE_REACTION: int = 0
    REQUIRED_BONUS: float = 0.0
    REQUIRE_EXACT_COPY: int = 0

    # --- Recombination (sex) ---
    RECOMBINATION_PROB: float = 1.0
    MAX_BIRTH_WAIT_TIME: int = -1
    MODULE_NUM: int = 0
    CONT_REC_REGS: int = 1
    CORESPOND_REC_REGS: int = 1
    TWO_FOLD_COST_SEX: int = 0
    SAME_LENGTH_SEX: int = 0

    # --- Reversion/sterilization ---
    REVERT_FATAL: float = 0.0
    REVERT_DETRIMENTAL: float = 0.0
    REVERT_NEUTRAL: float = 0.0
    REVERT_BENEFICIAL: float = 0.0
    STERILIZE_FATAL: float = 0.0
    STERILIZE_DETRIMENTAL: float = 0.0
    STERILIZE_NEUTRAL: float = 0.0
    STERILIZE_BENEFICIAL: float = 0.0
    STERILIZE_UNSTABLE: int = 0

    # --- Time slicing (cAvidaConfig.h:544-561) ---
    AVE_TIME_SLICE: int = 30
    SLICING_METHOD: int = 1         # 0=const, 1=prob∝merit, 2=integrated
    BASE_MERIT_METHOD: int = 4      # 4=min(full, copied, executed)
    BASE_CONST_MERIT: int = 100
    DEFAULT_BONUS: float = 1.0
    MERIT_DEFAULT_BONUS: float = 0.0
    MERIT_INC_APPLY_IMMEDIATE: int = 0
    MAX_CPU_THREADS: int = 1
    THREAD_SLICING_METHOD: int = 0
    NO_CPU_CYCLE_TIME: int = 0
    MAX_LABEL_EXE_SIZE: int = 1

    # --- Hardware ---
    HARDWARE_TYPE: int = 0
    INST_SET: str = "-"
    INSTSET: str = "-"              # alias used by some configs

    # --- Test CPU ---
    TEST_CPU_TIME_MOD: int = 20

    # --- Demes ---
    NUM_DEMES: int = 1
    DEMES_USE_GERMLINE: int = 0
    DEMES_COMPETITION_STYLE: int = 0
    DEMES_TOURNAMENT_SIZE: int = 0
    GERMLINE_COPY_MUT: float = 0.0075
    DEMES_MAX_AGE: int = 500
    DEMES_MAX_BIRTHS: int = 100
    DEMES_MIGRATION_RATE: float = 0.0
    # --- Mating types / birth chamber (cAvidaConfig.h:427-440) ---
    MATING_TYPES: int = 0            # 0=off, 1=male/female pairing
    LEKKING: int = 0                 # males always wait in the chamber
    # (MODULE_NUM / CONT_REC_REGS / CORESPOND_REC_REGS live in the
    # Recombination block above)
    # --- Predator-prey (cAvidaConfig.h:814-819) ---
    PRED_PREY_SWITCH: int = -1       # -1 = no predation
    PRED_EFFICIENCY: float = 1.0
    DEMES_MIGRATION_METHOD: int = 0  # 0=any, 1=8-neighbor deme grid,
    #                                  2=list-adjacent, 4=MIGRATION_FILE matrix
    DEMES_NUM_X: int = 0             # deme-grid width for method 1
    MIGRATION_FILE: str = "-"        # DxD weight matrix for method 4

    # --- Energy model (off by default) ---
    ENERGY_ENABLED: int = 0

    # --- Parasites ---
    INJECT_METHOD: int = 0
    INFECTION_MECHANISM: int = 0
    PARASITE_VIRULENCE: float = -1.0
    PARASITE_MEM_SPACES: int = 1

    # ---- TPU-build specific knobs (no reference equivalent) ----
    # Hard cap on the per-organism memory buffer (the reference's
    # MAX_GENOME_LENGTH analogue, but this one sizes HBM tensors).
    TPU_MAX_MEMORY: int = 384
    # Safety cap on lockstep micro-steps per update (0 = uncapped: run to the
    # max sampled budget).  Uncapped matches reference scheduling semantics.
    TPU_MAX_STEPS_PER_UPDATE: int = 0
    # float dtype for merit/bonus math ("float32" is plenty: max bonus 2^25).
    TPU_FLOAT_DTYPE: str = "float32"
    # Pallas VMEM-resident cycle kernel (ops/pallas_cycles.py): 0 = auto
    # (use on TPU when the environment qualifies), 1 = force on (any
    # backend; interpret mode off-TPU), 2 = off (always XLA micro-steps).
    TPU_USE_PALLAS: int = 0
    # Budget-aware lane packing for the Pallas kernel (ops/pallas_cycles.py):
    # organisms are permuted into kernel lanes sorted by granted budget so
    # each block's while_loop runs close to its MEAN budget instead of its
    # max (the ~1.55x budget-tail waste; observability/counters.budget_tail).
    # Value = refresh period K in updates: the persistent permutation is
    # recomputed every K updates (K=1: re-sorted by this update's granted
    # vector -- the exact tail fix; K>1: sorted by merit, amortizing the
    # sort, with binomial budget noise left in the tail).  0 = off
    # (identity lanes).  The permutation rides pack/unpack as major-axis
    # row gathers -- NOT the lane-axis packed-state permute that was
    # reverted in rounds 4/5.
    TPU_LANE_PERM: int = 1
    # With TPU_LANE_PERM > 1: also refresh the permutation early whenever
    # the measured per-block budget utilization (granted.sum / lockstep
    # ceiling) of the CURRENT permutation falls below this threshold.
    TPU_LANE_PERM_MIN_UTIL: float = 0.5
    # Kernel launch sharding: the Pallas cycle kernel is shard_map'd over
    # the `cells` mesh axis (parallel/mesh.py), one independent launch per
    # shard (blocks never communicate, so the split is free).  0 = auto
    # (one shard per visible device -- single-device runs are unsharded),
    # N > 0 = exactly N shards (must not exceed the device count; tests
    # use 1 to force the unsharded reference trajectory).
    TPU_KERNEL_SHARDS: int = 0
    # Packed-resident update chunk (ops/packed_chunk.py; round 6): keep
    # the population in the Pallas kernel's [LP, N] plane layout across
    # a WHOLE update_scan chunk -- pack once, run the chunk's updates
    # with the packed-native birth flush (lane-axis rolls on the word
    # planes; ops/birth.flush_births_packed), unpack once at the chunk
    # boundary where checkpoints / trace drains / .dat readbacks already
    # synchronize.  1 = auto: engaged whenever the configuration
    # qualifies (Pallas path + torus birth fast path + asexual + no
    # demes/energy/caps/point-or-slip mutations/resource pools and
    # TPU_SYSTEMATICS=0 -- see packed_chunk.active).  0 = off: the
    # per-update pack/unpack path with TPU_LANE_PERM budget packing (the
    # round-5 engine, byte-identical behavior).  When active, the
    # resident planes are CELL-ordered, so the budget-sort lane
    # permutation is superseded (identity lanes); the budget tail is
    # attacked in-kernel instead (TPU_KERNEL_ROWSKIP row-tile skipping +
    # the per-block while_loop early exit).
    TPU_PACKED_CHUNK: int = 1
    # Fused packed-resident update (ops/packed_chunk.py; round 14): run
    # the cheap per-update phases (schedule, bank, stats) as ROW-SPACE
    # ops directly on the resident [rows, N] planes instead of
    # rebuilding the full WorldState inside the scan body, so a chunk
    # is pack-once -> scan{row phases + kernel + packed flush} ->
    # unpack-once with no full-state unpack between updates.  1 = auto:
    # engaged whenever the packed chunk itself is active and the flight
    # recorder is off (packed_chunk.fused_ineligible_reason).  0 = the
    # legacy row-space path that refreshes the canonical mirrors every
    # update (round-6..13 engine, byte-identical trajectories either
    # way -- the fused path is bit-exact by construction and gated by
    # tests/test_packed_fused.py).  Program-affecting and STATIC: a
    # serve batch must not mix values (see serve.NONSTATIC_VARS note).
    TPU_PACKED_FUSED: int = 1
    # Bit-packed resident genome plane (ops/pallas_cycles.py 5-bit
    # codec; round 14): store the genome shadow plane as 5-bit opcodes
    # packed 6-per-int32-word (ceil(L/6) rows) instead of 4 opcode
    # bytes per word (L/4 rows) -- a ~34% cut in the genome plane's HBM
    # residency at TPU_MAX_MEMORY=384 (256B -> 256B vs 384B per
    # organism; see README plane-width table).  Only the genome shadow
    # narrows: the kernel never reads it (tape/offspring planes keep
    # the byte layout the kernel's SWAR decode indexes).  Requires the
    # instruction set to fit 5-bit codes (num_insts <= 32 --
    # packed_chunk.bits_ineligible_reason is loud otherwise).  Packing
    # happens at chunk boundaries only; trajectories and checkpoint
    # bytes are identical on or off (tests/test_packed_fused.py).
    # Default off pending device-scale soak.  Program-affecting and
    # STATIC, like TPU_PACKED_FUSED.
    TPU_PACKED_BITS: int = 0
    # Persistent program cache (utils/compilecache.py): 1 = the cycle
    # library that nvcc builds (ops/cycles.py) is published into a
    # CRC-manifested on-disk store and loaded in milliseconds by later
    # processes -- a cold-spawned serve/fleet child skips the nvcc
    # build.  A corrupt entry, or one built by another toolchain or
    # source version, is journaled and rebuilt, never loaded.  0 is a
    # HARD kill switch (the env var TPU_COMPILE_CACHE=0 kills it too):
    # every process builds privately.  One decision per process: the
    # first world that reaches the kernel decides with its config.
    TPU_COMPILE_CACHE: int = 1
    # Cache root directory ("-" = resolve from the TPU_COMPILE_CACHE_DIR
    # env var, else avida_tpu_torch/_build); entries live under its
    # kernels-torch/ subdirectory.  The fleet orchestrator points
    # children at SPOOL/compile-cache so one child's build warms every
    # sibling.
    TPU_COMPILE_CACHE_DIR: str = "-"
    # Runtime telemetry (avida_tpu/observability/): 1 = phase-fenced
    # staged updates, device counters and a telemetry.jsonl run log in
    # DATA_DIR.  Opt-in: 0 (default) compiles to the identical update
    # program as before the subsystem existed (tests/test_telemetry.py)
    # and writes no files.  Telemetry forces per-update host dispatch
    # (no update_scan chunking) and fences every phase, so expect the
    # run to be slower -- it trades throughput for attribution.
    TPU_TELEMETRY: int = 0
    # Where `jax.profiler` traces go when telemetry is on ("-" = no trace
    # capture).  The first TPU_PROFILE_UPDATES updates are captured.
    TPU_PROFILE_DIR: str = "-"
    TPU_PROFILE_UPDATES: int = 3
    # Native bit-exact checkpoints (utils/checkpoint.py): directory for
    # rolling ckpt-<update> generations ("-" = checkpointing off).  With a
    # directory set, World.run installs SIGTERM/SIGINT handlers that stop
    # at the next update-chunk boundary, save a final checkpoint and
    # return cleanly (preemption handling); World.resume() restores the
    # newest valid generation bit-exactly (falling back past corrupt
    # ones via the per-array CRC manifest).
    TPU_CKPT_DIR: str = "-"
    # Auto-save period in updates (0 = save only on preemption; requires
    # TPU_CKPT_DIR).  Saves land at update-chunk boundaries, so the
    # actual spacing can overshoot by up to one chunk (<= 128 updates).
    TPU_CKPT_EVERY: int = 0
    # Rolling retention: how many checkpoint generations to keep.
    TPU_CKPT_KEEP: int = 2
    # State invariant auditor (utils/audit.py): run audit_state every K
    # updates inside World.run (0 = only at checkpoint save/load).  A
    # violation raises StateInvariantError naming the broken invariant.
    TPU_AUDIT_EVERY: int = 0
    # Silent-corruption integrity plane (ops/digest.py +
    # utils/integrity.py; README "Integrity plane").  TPU_STATE_DIGEST=1
    # computes an order-stable u32 tree digest of the full
    # PopulationState at every update-chunk boundary -- into the
    # checkpoint manifest (`state_digest`, re-verified by --resume /
    # ckpt_tool --verify), the metrics.prom heartbeat
    # (avida_state_digest) and DATA_DIR/integrity.jsonl.  Default 0:
    # nothing is built or traced, zero cost; either way the update
    # program itself is byte-identical (the digest is a SEPARATE jit,
    # the audit_state isolation rule).
    TPU_STATE_DIGEST: int = 0
    # Sampled shadow re-execution (scrubbing): every K-th update chunk
    # is re-executed from the retained pre-chunk state and the two
    # digests compared -- on this deterministic engine any mismatch is
    # silent data corruption (StateDivergenceError, child exit 67, the
    # supervisor's `sdc` rollback).  K=1 is full lockstep redundancy
    # (~2x chunk cost); larger K samples 1/K of chunks.  Default 0 =
    # off.  Implies manifest digests at checkpoint saves.
    TPU_SCRUB_EVERY: int = 0
    # Device-side flight recorder (observability/tracer.py): 1 = record
    # structured events (births/deaths, first task triggers, scheduler
    # stalls, state anomalies) into fixed-capacity ring buffers INSIDE
    # the jitted update, drained to {"record":"trace"} runlog lines only
    # at update-chunk boundaries (no mid-chunk host sync).  Opt-in: 0
    # (default) adds no state and traces the identical update program
    # (scripts/check_jaxpr.py digest unchanged); 1 leaves the evolved
    # trajectory bit-identical (the ring is append-only side state).
    TPU_TRACE: int = 0
    # Ring capacity in events.  Overflow drops the OLDEST events and
    # counts the drops (reported on the drain record) -- it never forces
    # an early host sync.  Size for the busiest expected window: roughly
    # (births + deaths + first-task triggers) per update x updates per
    # chunk (<= 128).
    TPU_TRACE_CAP: int = 4096
    # Emit a scheduler-stall event when the lockstep block utilization of
    # the granted budget vector falls below this fraction.
    TPU_TRACE_STALL_UTIL: float = 0.25
    # Prometheus-style metrics textfile (observability/exporter.py):
    # 1 = rewrite DATA_DIR/metrics.prom atomically at every update-chunk
    # boundary (tmp + rename, like checkpoints) so an external scraper /
    # `python -m avida_tpu --status DIR` can watch a live run.  Implied
    # by TPU_TRACE=1.
    TPU_METRICS: int = 0
    # Telemetry history rings (observability/history.py): every .prom
    # publish also appends one compact sample row -- wall time, update,
    # every family value -- to a bounded `.hist.jsonl` ring beside the
    # snapshot (rotation pair, non-durable appends: the zero-sync
    # pipeline is never fenced).  The rings feed the alert plane
    # (observability/alerts.py), the `--status` rate line and
    # `scripts/metrics_tool.py query`.  Host-side only: trajectories
    # are bit-identical on or off.  The environment spelling of these
    # knobs wins over the config file so operators can flip fleets.
    TPU_METRICS_HIST: int = 1
    # Sample every K-th publish (1 = heartbeat cadence).
    TPU_METRICS_HIST_EVERY: int = 1
    # Ring rotation cap in bytes per file (the live + `.1` pair bounds
    # disk at twice this).
    TPU_METRICS_HIST_MAX_BYTES: int = 4 << 20
    # Device performance attribution plane (observability/profiler.py;
    # README "Performance attribution").  TPU_PROFILE=1 -- config OR
    # environment, the TPU_STATE_DIGEST arming pattern -- arms per-chunk
    # attribution on the scanned-chunk path: unfenced chunk walls every
    # chunk, a FENCED staged phase probe + per-leaf resident-footprint
    # accounting on the first chunk and every TPU_PROFILE_EVERY-th
    # after, per-program XLA cost/memory analysis captured at
    # compile/cache-load time (utils/compilecache.py).  Lands as
    # avida_perf_* exposition families, {"record":"perf"} lines in
    # DATA_DIR/perf.jsonl and a `--status` perf block.  Probes run on
    # device-owned COPIES of the state: trajectories are bit-identical
    # on or off; default 0 builds, fences and writes nothing.  NOT the
    # telemetry jax.profiler knobs (TPU_PROFILE_DIR/TPU_PROFILE_UPDATES
    # above): this plane rides the chunked path telemetry cannot.
    TPU_PROFILE: int = 0
    # Fenced-probe cadence in chunks (0 = first chunk only; env wins,
    # the history-knob operator convention).
    TPU_PROFILE_EVERY: int = 16
    # 1 = the first fenced probe also captures a jax.profiler trace of
    # its staged phases into DATA_DIR/profiles/ (XProf-loadable).
    TPU_PROFILE_TRACE: int = 0

    # In-run analytics (analyze/pipeline.py): 1 = refresh an incremental
    # phenotype census + dominant-lineage replay at checkpoint
    # boundaries and run exit (needs TPU_CKPT_DIR/TPU_CKPT_EVERY for the
    # mid-run cadence), publishing DATA_DIR/analytics.prom and
    # DATA_DIR/analysis/analytics.jsonl for `--status` and the fleet
    # view.  Host-side only: trajectories are bit-identical on or off.
    TPU_ANALYTICS: int = 0
    # Live-mode knockout sweeps over the top-N genotypes per refresh
    # (0 = census/lineage only; sweeps cost one sandbox evaluation per
    # genome site -- memoized by genome content, so a stable dominant
    # only pays once -- and are opt-in while the run is alive).
    TPU_ANALYTICS_KNOCKOUT_TOP: int = 0
    # Sandbox PRNG seed for the live census/knockout evaluations (the
    # offline CLI's --seed); per-lane inputs are counter-stable, so a
    # given (seed, genotype) always scores identically.
    TPU_ANALYTICS_SEED: int = 0

    extras: dict = field(default_factory=dict)

    _FIELD_NAMES = None  # class-level cache

    @classmethod
    def field_names(cls):
        if cls._FIELD_NAMES is None:
            cls._FIELD_NAMES = {f.name for f in fields(cls) if f.name != "extras"}
        return cls._FIELD_NAMES

    def set(self, name: str, value):
        """Apply one NAME VALUE pair (file line or -set override)."""
        if name in self.field_names():
            cur = getattr(self, name)
            if isinstance(cur, str):
                setattr(self, name, str(value))
            elif isinstance(cur, float):
                setattr(self, name, float(value))
            else:
                setattr(self, name, int(float(value)))
        else:
            self.extras[name] = value

    def get(self, name: str, default=None):
        if name in self.field_names():
            return getattr(self, name)
        return self.extras.get(name, default)

    def copy(self) -> "AvidaConfig":
        c = dataclasses.replace(self)
        c.extras = dict(self.extras)
        return c


def load_avida_cfg(path: str, overrides=None) -> AvidaConfig:
    """Parse an avida.cfg file (ref format: cAvidaConfig::Load, cAvidaConfig.cc:64).

    Lines are `NAME VALUE  # comment`.  `overrides` is a list of (name, value)
    applied after the file, mirroring `-set NAME VALUE`.
    """
    cfg = AvidaConfig()
    seen_unknown = set()
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            name, value = parts[0], _parse_scalar(parts[1])
            if name == "VERSION_ID":
                continue
            if name not in AvidaConfig.field_names() and name not in seen_unknown:
                seen_unknown.add(name)
            cfg.set(name, value)
    if seen_unknown:
        warnings.warn(
            "avida.cfg variables not yet interpreted by avida-tpu (kept in "
            f"extras): {sorted(seen_unknown)}", stacklevel=2)
    for name, value in (overrides or []):
        cfg.set(name, _parse_scalar(str(value)))
    return cfg
