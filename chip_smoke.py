"""Smoke run of avida_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the cycle kernels from avida_tpu_torch/csrc (the Hopper kernel,
cycles.cu, and the first port it replaced, cycles_simple.cu, kept as its
yardstick), reports their registers, stack, spills and shared memory,
then drives four paths of World.run on a 320x320 world seeded
everywhere with the instruction set's ancestor, and two paths of
MultiWorld.run on a batch of 16 stock 60x60 worlds with their own seeds,
and checks that every update of each launched the Hopper kernel once:

  main_path     TPU_SYSTEMATICS=0: the packed-resident engine
  default_path  the reference's default, systematics on: the per-update
                engine (lane-permuted run_cycles, canonical birth flush,
                newborn ring, host phylogeny drain)
  sex_path      INST_SET heads_sex (BASELINE config 3), systematics on:
                the per-update engine with divide-sex, the birth chamber
                and the placement through the neighbor table
  costs_kernel  an instruction-set file with costs, first-time costs,
                prob_fail, addl_time_cost, unequal redundancies and the
                nops off opcodes 0-2, on the packed engine
  multiworld_path    the batch with systematics on: the batched
                per-update engine, one stacked launch per update
  multiworld_packed  the batch with TPU_SYSTEMATICS=0: the stacked
                packed-resident engine

and the micro-step cycle engine (TPU_USE_PALLAS=2, and every
configuration the kernel gate refuses), whose paths launch no kernel:

  kernel_limits     a 1088-site tape and 33 reactions refused on the
                    kernel route by name; TPU_USE_PALLAS=2 runs them
  xla_path          the 320x320 world with TPU_USE_PALLAS=2 (trips an
                    update, ms a cycle, its phases timed, a profiler
                    trace of a few cycles: kernels, busy and idle share)
  math_path         320x320, logic-9 plus math-family reactions with
                    fractional values under the default TPU_USE_PALLAS=0
  engines_agree     320x320, the reference's cross-engine configuration:
                    kernel and micro-step engine equal after every update
  xla_cross_device  card against CPU: a 24x24 math world and a W = 3
                    batch on the folded engine
  multiworld_fold   the 16 x 60x60 batch on the folded engine, members 0
                    and 15 against their solo runs on the CPU

and resource pools and demes (ROADMAP items 12a, 12b):

  resource_path     320x320, mixed programs, logic-9 with seven reactions
                    on global pools, one on a diffusing torus pool fed by
                    a by-product, one on a moving gradient: the
                    micro-step engine, 3 updates + 1 timed
  deme_path         320x320 in 16 demes with germlines and migration,
                    CompeteDemes at 10 and ReplicateDemes births at 24:
                    the kernel route's per-update engine, 30 launches;
                    K1 held against the plain version on its state
  deme_resource_path  320x320 in 16 demes whose rewards draw on deme
                    pools, a predicate-triggered ReplicateDemes: the
                    micro-step engine, 3 updates + 1 timed
  resources_cross_device  small worlds of the three paths on the card
                    and on the CPU, ending identical

and TransSMT hardware with host-parasite coevolution (ROADMAP item
12c, BASELINE config 4), on the micro-step engine (micro_step_smt):

  smt_path          320x320, INST_SET transsmt, every cell seeded with
                    the TransSMT ancestor and the stock parasite in every
                    other cell, PARASITE_VIRULENCE 0.8: World.run to
                    update 20, then one update timed phase by phase (the
                    flush with the injections) and run; hosts and
                    parasites alive, infections landing, no launch
  smt_cross_device  the same construction at 10x10 on the card and on
                    the CPU, INT_MIN and -1 planted under Val-Div and
                    Val-Mod: one cycle, then 14 updates, identical
  smt_fold          16 TransSMT 60x60 worlds on the folded engine for
                    18 updates, members 0 and 15 against their solo runs
                    on the CPU

and the rest of the birth flush, the topologies, mating types, energy
and threads (ROADMAP items 12d-12g):

  dispersal_path    320x320, BIRTH_METHOD 11 (DISPERSAL_RATE 1.0) and
                    POPULATION_CAP 80,000, KillProb 0.1 at update 10 and
                    SerialTransfer 20000 at 20: the kernel route's
                    per-update engine, 30 launches; K1 held against the
                    plain version on its state
  topology_path     a 320x320 hex world (20 launches, K1 held), random
                    connected and scale-free 60x60 worlds and a 16x16
                    clique (16 each): each table's width and build time
  mating_path       320x320, MATING_TYPES 1, male and female ancestors:
                    the micro-step engine until the first pairings, then
                    one update timed; pairings, juvenile drops, the store
  energy_path       320x320, ENERGY_ENABLED 1 (inject energy 1000,
                    BIRTH_METHOD 10): until the first births, then one
                    update timed; newborn merits from their energy
  threads_path      320x320, MAX_CPU_THREADS 4, THREAD_SLICING_METHOD 1,
                    a forking ancestor: 2 updates + 1 timed
  slice10_cross_device  12x12 worlds of each of these (geometries 3, 4,
                    7, 8; DISPERSAL_RATE 1.0 and 12.0 under both caps
                    with KillProb and SerialTransfer; mating, energy,
                    threads): the CPU alone to the first births, then
                    card and CPU from the CPU's state, field by field
                    after each update

and experimental hardware, the remaining print actions and the 5-bit
genome plane (ROADMAP items 12h, 12j, 12i):

  experimental_path  320x320 predator-prey world on experimental
                    hardware (hw_type 3: the pred_look set plus
                    attack-prey and the replication instructions), the
                    experimental ancestor everywhere and a predator in
                    every sixteenth cell, PRED_PREY_SWITCH 0: the
                    micro-step engine (no launch), 2 updates, then one
                    timed phase by phase; attacks, kills and moves
  experimental_cross_device  the same construction at 12x12 built and
                    run on the card and on the CPU: every field after
                    each update and the .dat files equal, with kills and
                    moves
  print_actions     a 60x60 kernel-route world with systematics on, the
                    eight new print actions and PrintData each update
                    for 10 updates on the card and on the CPU: every
                    .dat file byte for byte
  packed_bits_path  main_path's evolved world continued for 10 updates
                    with TPU_PACKED_BITS=1, births among them,
                    field-equal at each chunk boundary to the 8-bit run;
                    K1 held against the plain version on its state

and persistence (native checkpoints in the reference's format):

  persist_path      the 320x320 packed world saving every 10 updates
                    with the state digest on; a second World resumes at
                    update 20 and must end equal (state, .dat files, K1
                    launched once per resumed update, the manifest's
                    digest equal to the device digest); save, resume and
                    digest times, the generation's size
  persist_default   the default_path configuration saved at 15 and
                    resumed to 30: state, dominant.dat, systematics.json
  preempt_cli       `python -m avida_tpu_torch` as a child process, sent
                    SIGTERM after its save at 12: exit 0 with a
                    generation off persist_path's chunk boundaries,
                    then --resume to 40, whose final arrays must be
                    persist_path's byte for byte
  scrub_path        TPU_SCRUB_EVERY=1 for 10 updates: every chunk's
                    shadow replay (the same kernel on the same planes)
                    equal to the live chunk
  spop_path         SavePopulation / LoadPopulation on a 60x60 world: the
                    restore on the card equal to the one on the CPU
  multiworld_persist  multiworld_path's batch saved at 8, resumed by a
                    new batch to 16: every member equal, K3b once per
                    resumed update

On each path's evolved state it holds both kernels bit for bit against
the plain PyTorch version, times them on the same planes in turns (first
port, Hopper, Hopper, first port) and times the path's own phase
functions; a batch's stacked launch is also held, world by world,
against the solo launches, and two batch members against their solo
runs; small worlds and a small batch run on the card and on the CPU
must end identical (the CPU halves run in worker processes that see no
card, beside the card's phases: cpu_jobs); the geometry phase holds
both kernels to the plain version at the launch shapes the paths do not
reach (B = 128, 256, and L = 1024), and the size_range phase holds them
at OFFSPRING_SIZE_RANGE 1.1, where the divide's size limit rounds.
Each phase prints one JSON line; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before that
line.  Needs a CUDA device: without one it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the script's elapsed seconds
    (`t_s`), for planning the phases' depths against the time limit."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` runs (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_world(side, data_dir, device, events, extra=None, config_dir=None):
    from avida_tpu_torch import convert
    from avida_tpu_torch.world import World
    vals = dict(WORLD_X=side, WORLD_Y=side, RANDOM_SEED=11,
                TPU_SYSTEMATICS=0)
    vals.update(extra or {})
    if config_dir is None:
        w = World(cfg=convert.config_from_dict(vals), data_dir=data_dir,
                  device=device)
    else:
        w = World(config_dir=config_dir, overrides=list(vals.items()),
                  data_dir=data_dir, device=device)
    w.events = []
    for e in events:
        w.add_event(e)
    return w


# an environment using every reward type and requisite kind
ENV_TEXT = """
REACTION NOT  not  process:value=1.0:type=pow  requisite:max_count=2
REACTION NAND nand process:value=1.5:type=mult requisite:noreaction=NOT
REACTION AND  and  process:value=2.5:type=add  requisite:reaction=NOT
REACTION ORN  orn  process:value=2.0:type=pow  requisite:min_count=1:max_count=3
REACTION OR   or   process:value=3.0:type=pow
REACTION ANDN andn process:value=3.0:type=add
REACTION NOR  nor  process:value=4.0:type=pow
REACTION XOR  xor  process:value=4.0:type=pow
REACTION EQU  equ  process:value=5.0:type=pow
"""
# IO reads x; push/pop copies it to CX; nand/IO output ~x (NOT), then
# ~(x & y) (NAND), ...
TASK_GENOME = ["IO", "push", "pop", "nop-C", "nand", "IO", "nand", "IO",
               "nand", "IO", "swap", "IO", "inc", "IO"] + ["swap-stk"] * 6


def reseed_mixed(w):
    """Reseed a freshly InjectAll-ed world: a third of the cells get a
    task-performing program and a third random genomes of 30-89
    instructions, so every instruction and reward path runs.  One pass:
    each reseeded cell's genome, tape, lengths, merit and age limit are
    written at once (every other field is already fresh; the cell inputs
    stay InjectAll's)."""
    import numpy as np
    import torch
    from avida_tpu_torch.core.state import _max_executed
    names = w.instset.inst_names
    n, L = w.params.num_cells, w.params.max_memory
    rng = np.random.default_rng(7)
    st = w.state
    genome = st.genome.cpu().numpy().copy()
    glen = st.genome_len.cpu().numpy().copy()
    task = [names.index(x) for x in TASK_GENOME]
    for c in range(1, n, 3):
        genome[c] = 0
        genome[c, :len(task)] = task
        glen[c] = len(task)
    for c in range(2, n, 3):
        k = int(rng.integers(30, 90))
        genome[c] = 0
        genome[c, :k] = rng.integers(0, len(names), k)
        glen[c] = k
    dev = st.device
    g = torch.from_numpy(genome).to(dev)
    gl = torch.from_numpy(glen.astype(np.int32)).to(dev)
    max_exec = torch.tensor([_max_executed(w.params, int(x)) for x in glen],
                            dtype=torch.int32, device=dev)
    w.state = st.replace(genome=g, tape=g.to(torch.uint8) & 0x3F,
                         genome_len=gl, mem_len=gl.clone(),
                         executed_size=gl.clone(), copied_size=gl.clone(),
                         merit=gl.to(torch.float32), max_executed=max_exec)


# the heads opcodes with nop-A/B/C moved off 0-2 and every cost column
# of the instruction-set file in use
COSTS_INSTSET = """INSTSET heads_costs:hw_type=0
INST if-n-equ:cost=2
INST if-less
INST nop-B:redundancy=2
INST if-label:prob_fail=0.05
INST mov-head
INST jmp-head:ft_cost=3
INST get-head
INST set-flow
INST nop-C
INST shift-r
INST shift-l:prob_fail=0.1
INST inc:addl_time_cost=2
INST dec
INST push:cost=3
INST pop:ft_cost=2
INST swap-stk
INST swap
INST nop-A:redundancy=3
INST add
INST sub
INST nand:cost=2:ft_cost=4
INST h-copy:redundancy=4:addl_time_cost=1
INST h-alloc:ft_cost=5
INST h-divide:cost=2:addl_time_cost=3
INST IO:prob_fail=0.02:cost=2
INST h-search:redundancy=0.5
"""

CROSS_CASES = (
    # (name, side, updates, extra config, custom environment, mixed
    # programs, print every n updates (0 = no .dat files))
    ("default", 8, 16, {}, False, False, 0),
    ("mixed", 12, 16, dict(BASE_MERIT_METHOD=5, DIVIDE_METHOD=0,
                           GENERATION_INC_METHOD=0, REQUIRE_ALLOCATE=0,
                           COPY_MUT_PROB=0.05), True, True, 0),
    ("capped", 8, 24, dict(TPU_MAX_STEPS_PER_UPDATE=25), False, True, 0),
    ("systematics", 8, 16, dict(TPU_SYSTEMATICS=1), False, False, 4),
    ("sex", 8, 32, dict(TPU_SYSTEMATICS=1, INST_SET="heads_sex"), False,
     False, 4),
    ("costs", 8, 24, dict(COPY_MUT_PROB=0.02), False, True, 0),
    ("soup", 8, 16, dict(BIRTH_METHOD=4, WORLD_GEOMETRY=1), False, False,
     0),
)
# the engine each case must take, and words of its reason
CROSS_ENGINES = {"systematics": ("per-update", "TPU_SYSTEMATICS=1"),
                 "sex": ("per-update", "divide-sex"),
                 "soup": ("per-update", "off the torus fast path")}
PRINTS = ("PrintAverageData", "PrintCountData", "PrintTasksData",
          "PrintTimeData", "PrintDominantData")


def dat_bodies(data_dir):
    """{file: lines} of a run's .dat files, without the header's date."""
    out = {}
    for f in sorted(os.listdir(data_dir)):
        if f.endswith(".dat"):
            with open(os.path.join(data_dir, f)) as fh:
                lines = fh.read().splitlines()
            out[f] = lines[:1] + lines[2:]
    return out


def write_config_dir(cdir, env=False, instset=None):
    """A config directory: avida.cfg naming the instruction-set file (or
    the built-in set), and the custom environment when asked for."""
    os.makedirs(cdir)
    with open(os.path.join(cdir, "avida.cfg"), "w") as f:
        f.write("INST_SET instset.cfg\n" if instset else "INST_SET -\n")
    if instset:
        with open(os.path.join(cdir, "instset.cfg"), "w") as f:
            f.write(instset)
    if env:
        with open(os.path.join(cdir, "environment.cfg"), "w") as f:
            f.write(ENV_TEXT)
    return cdir


def cross_side(tmp, dev):
    """One device's half of cross_device: for each case, the state's
    arrays, the .dat bodies, the engine (checked against the case's) and
    the count of stretch boundaries holding a stored birth-chamber
    entry."""
    from avida_tpu_torch import convert
    out = []
    for name, side, updates, extra, custom_env, mixed, every in CROSS_CASES:
        cdir = None
        if custom_env or name == "costs":
            cdir = write_config_dir(
                os.path.join(tmp, f"cfg_{name}"), env=custom_env,
                instset=COSTS_INSTSET if name == "costs" else None)
        events = ["u begin InjectAll"] + (
            [f"u 0:{every}:end {a}" for a in PRINTS] if every else [])
        want = CROSS_ENGINES.get(name, ("packed", ""))
        ddir = os.path.join(tmp, f"x_{name}_{dev}")
        w = make_world(side, ddir, dev, events, extra, cdir)
        w.process_events()
        if mixed:
            reseed_mixed(w)
        n_stored = 0
        for u in range(4, updates + 1, 4):
            w.run(max_updates=u)
            n_stored += int(w.state.bc_valid)
        _sync(dev)
        rep = w.engine_report()
        if rep["engine"] != want[0] \
                or want[1] not in rep.get("fallback_reason", ""):
            raise AssertionError(f"{name}: engine {rep}, want {want}")
        out.append((convert.state_to_arrays(w.state),
                    dat_bodies(ddir) if every else {}, rep["engine"],
                    n_stored))
    return out


def phase_cross_device(tmp, cpu=None, device="cuda"):
    """Small worlds run on the card and on the CPU (the plain versions)
    must end in identical states (and, where they print, identical .dat
    bytes): the whole update path, kernel included, against its plain
    PyTorch counterpart, over default, mixed-program, capped and costs
    configurations of the packed engine and the systematics, heads-sex
    and soup (BIRTH_METHOD 4 on a grid) worlds of the per-update engine.
    Each world runs in stretches of 4 updates; the sexual one must hold
    a waiting birth-chamber entry at some stretch boundary.  `cpu` is
    the cpu_jobs job of cross_side's CPU half, else it runs here."""
    card = cross_side(tmp, device)
    host = cpu_half(cpu, cross_side, cpu_root(tmp), "cpu")
    results = []
    for case, (sa, da, ea, na), (sb, db, eb, _) in zip(CROSS_CASES, card,
                                                        host):
        name, side, updates, _, _, _, every = case
        bad = [k for k in sa if sa[k] is not None
               and sa[k].tobytes() != sb[k].tobytes()]
        bad += [f for f in set(da) | set(db) if da.get(f) != db.get(f)]
        births = int((sb["birth_update"] >= 0).sum())
        tasks = int((sb["task_exe_total"] > 0).any(axis=0).sum())
        if bad or births == 0 or (every and "dominant.dat" not in da) \
                or (name == "sex" and na == 0):
            raise AssertionError(f"{name}: cuda vs cpu differ in {bad} "
                                 f"(births {births}, files {sorted(da)}, "
                                 f"boundaries with a stored entry {na})")
        res = {"case": name, "world": f"{side}x{side}",
               "updates": updates, "engine": sorted({ea, eb}),
               "births": births, "tasks_seen": tasks,
               "dat_files_equal": sorted(da)}
        if name == "sex":
            res["boundaries_with_stored_entry"] = na
        results.append(res)
    return {"phase": "cross_device", "fields_equal": True, "cases": results}


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_main(side, updates, data_dir, device="cuda"):
    import torch
    from avida_tpu_torch.ops import cycles
    every = max(updates // 2, 1)
    ev = ["u begin InjectAll"] + [
        f"u 0:{every}:end {a}" for a in ("PrintAverageData",
                                         "PrintCountData", "PrintTasksData",
                                         "PrintTimeData")]
    w = make_world(side, data_dir, device, ev)
    _sync(device)
    cycles.reset_launches()
    t0 = time.perf_counter()
    insts = w.run(max_updates=updates)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = cycles.LAUNCHES
    alive = w.num_organisms
    files = sorted(f for f in os.listdir(data_dir) if f.endswith(".dat"))
    rows = {}
    for f in files:
        with open(os.path.join(data_dir, f)) as fh:
            rows[f] = [ln.split() for ln in fh if ln.strip()
                       and not ln.startswith("#")]
    merit = torch.where(w.state.alive, w.state.merit, 0.0)
    want = updates if torch.device(device).type == "cuda" else 0
    ok = (launches == want and w.update == updates and alive > 0
          and bool(torch.isfinite(merit).all())
          and files == ["average.dat", "count.dat", "tasks.dat", "time.dat"]
          and all(len(r) == updates // every + (updates % every > 0)
                  for r in rows.values())
          and all(math.isfinite(float(x)) for r in rows["average.dat"]
                  for x in r))
    res = {"phase": "main_path", "world": f"{side}x{side}",
           "engine_report": w.engine_report(), "updates": w.update,
           "kernel_launches": launches, "insts": insts,
           "org_inst_per_s": insts / wall, "ms_per_update": 1e3 * wall / updates,
           "wall_s": wall, "live_organisms": alive,
           "births_total": int(w._total_births), "dat_files": files}
    if not ok:
        raise AssertionError(f"main path check failed: {res}")
    return w, res


def phase_kernel(w, n_launch=3, time_it=True):
    """Hold the Hopper kernel and the first port against the plain version
    on full-width planes from the main path's evolved state, over
    consecutive launches.  Between launches the state advances through the
    main path's own phases."""
    import torch
    from avida_tpu_torch.ops import cycles, packed_chunk, update
    from avida_tpu_torch.utils import prng
    p = w.params
    pc = packed_chunk.pack_chunk(p, w.state)
    n = pc.tape_t.shape[1]
    B, n_pad, _ = cycles.dims(p, n, p.max_memory)
    cap = update.static_cap(p)
    u = w.update
    worst = 0.0
    times = []

    def padded(t):
        out = torch.zeros((t.shape[0], n_pad), dtype=t.dtype, device=t.device)
        out[:, :n] = t
        return out

    def planes():
        return (pc.tape_t, pc.off_t, pc.ivec, pc.fvec)

    for i in range(n_launch):
        ks = prng.split(prng.fold_in(w._run_key, u + i), 3)
        budgets, executed0 = packed_chunk.schedule_phase(p, pc, ks[0])
        seeds = cycles.block_seeds(ks[1], n_pad, B)
        kern, err, plain_ms = hold_both(
            p, tuple(padded(t) for t in planes()), seeds, cap, B,
            f"launch {i}")
        worst = max(worst, err)
        times.append(plain_ms)
        for dst, src in zip(planes(), kern):
            dst.copy_(src[:, :n])
        pc, _ = packed_chunk.bank_phase(p, pc, budgets, executed0)
        pc = packed_chunk.flush_phase(p, pc, ks[2], u + i)

    res = {"name": "cycles", "route": "cuda",
           "source": "avida_tpu_torch/csrc/cycles.cu",
           "replaces": "avida_tpu/ops/pallas_cycles.py:382",
           "launches": None, "max_abs_err": worst, "match": True,
           "checked_launches": n_launch, "plain_ms": min(times),
           "library_ms": None}
    if not time_it:
        return res

    # timing at the next launch's inputs, on copies of them
    ks = prng.split(prng.fold_in(w._run_key, u + n_launch), 3)
    packed_chunk.schedule_phase(p, pc, ks[0])
    seeds = cycles.block_seeds(ks[1], n_pad, B)
    base = tuple(padded(t) for t in planes())
    work = tuple(t.clone() for t in base)
    cycles.cycles(p, work, seeds, cap, B)
    res.update(kernel_bound(base, work, seeds))
    res.update(paired_ms(p, base, seeds, cap, B))
    res["reached"] = res["bound_ms"] / res["ms"]
    return res


def hold_both(p, base, seeds, cap, B, where, launch=None):
    """The Hopper kernel (`launch(work)`, by default one `cycles.cycles`)
    and the first port, each on a copy of `base`, held word for word
    against the plain version on a third copy: (the Hopper kernel's
    planes, max_abs_err, the plain version's host-clocked ms)."""
    from avida_tpu_torch.ops import cycles
    kern = tuple(t.clone() for t in base)
    simple = tuple(t.clone() for t in base)
    plain = tuple(t.clone() for t in base)
    if launch is None:
        cycles.cycles(p, kern, seeds, cap, B)
    else:
        launch(kern)
    cycles.cycles_simple(p, simple, seeds, cap, B)
    _sync(base[0].device)
    t0 = time.perf_counter()
    cycles.cycles_reference(p, plain, seeds, cap, B)
    _sync(base[0].device)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    worst = compare_planes(kern, plain, where)
    compare_planes(simple, plain, f"{where} (first port)")
    return kern, worst, plain_ms


def paired_ms(p, base, seeds, cap, B, launch=None):
    """CUDA-event ms of one launch of the Hopper kernel (`launch(work)`, by
    default one `cycles.cycles`) and of the first port on copies of
    `base`, taken in turns -- first port, Hopper, Hopper, first port --
    each turn the mean of 10 launches less the copy's own time:
    {"ms", "simple_ms", "turns_ms"}."""
    from avida_tpu_torch.ops import cycles
    new = launch or (lambda work: cycles.cycles(p, work, seeds, cap, B))

    def simple(work):
        cycles.cycles_simple(p, work, seeds, cap, B)

    work = tuple(t.clone() for t in base)

    def copy_only():
        for dst, src in zip(work, base):
            dst.copy_(src)

    def timed(fn):
        def one():
            copy_only()
            fn(work)
        return one

    copy = cuda_ms(copy_only, 10)
    turns = [cuda_ms(timed(f), 10) - copy for f in (simple, new, new, simple)]
    return {"ms": (turns[1] + turns[2]) / 2,
            "simple_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns}


def compare_planes(kern, plain, where):
    """max |kernel - plain| over the four planes; raises unless every word
    is equal."""
    import torch
    worst = 0.0
    for name, a, b in zip(("tape_t", "off_t", "ivec", "fvec"), kern, plain):
        worst = max(worst, float((a.double() - b.double()).abs().max()))
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            diff = (a.view(torch.int32) != b.view(torch.int32))
            raise AssertionError(
                f"kernel != plain at {where}: {int(diff.sum())} words of "
                f"{name} differ, (row, lane) "
                f"{diff.nonzero()[:10].tolist()}")
    return worst


def kernel_bound(inp, out, seeds, pad_lanes=0):
    """The cycle kernel's byte bound for one launch on these inputs: the
    planes it reads (tape_t, ivec, the phenotype rows of fvec) and the
    seeds read once, and only the words this launch changed written
    once (the planes are updated in place; off_t is written only for
    lanes that divided, tape_t only at copied or allocated bytes).  Of
    tape_t, each of `pad_lanes` lanes (a stacked launch's zero padding,
    granted nothing) is counted at the one word it reads (its
    pending-write value), not its whole column."""
    import torch
    from avida_tpu_torch.ops import cycles
    tape_t, _, ivec, fvec = inp
    tape_words = tape_t.numel() - (tape_t.shape[0] - 1) * pad_lanes
    read = 4 * (tape_words + ivec.numel() + seeds.numel()
                + (cycles.FV_LAST_MERIT_BASE + 1) * fvec.shape[1])
    changed = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                  for a, b in zip(inp, out))
    return {"bound_ms": 1e3 * (read + 4 * changed) / HBM_BYTES_PER_S,
            "bound_by": "bytes", "bytes_read": read,
            "bytes_written": 4 * changed}


def phase_breakdown(w, updates=5):
    """Per-phase device-synchronised wall time of the packed update body
    (the main path's own phase functions, in update_step_packed's order)
    on a copy of the world's state: the per-layer view of ms/update."""
    import torch
    from avida_tpu_torch.ops import packed_chunk
    from avida_tpu_torch.utils import prng
    p = w.params
    acc = {k: 0.0 for k in ("pack", "schedule", "kernel", "bank", "flush",
                            "stats", "unpack")}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        acc[name] += 1e3 * (time.perf_counter() - t0)
        return out

    pc = timed("pack", packed_chunk.pack_chunk, p, w.state)
    for i in range(updates):
        u = w.update + i
        ks = prng.split(prng.fold_in(w._run_key, u), 3)
        alive_before = packed_chunk.alive_rows(pc.ivec).sum().to(torch.int32)
        budgets, executed0 = timed("schedule", packed_chunk.schedule_phase,
                                   p, pc, ks[0])
        timed("kernel", packed_chunk.kernel_phase, p, pc, ks[1])
        pc, _ = timed("bank", packed_chunk.bank_phase, p, pc, budgets,
                      executed0)
        pc = timed("flush", packed_chunk.flush_phase, p, pc, ks[2], u)
        timed("stats", packed_chunk.stats_rows, pc, alive_before, u)
    timed("unpack", packed_chunk.unpack_chunk, p, pc)
    per = {k: v / updates for k, v in acc.items()
           if k not in ("pack", "unpack")}
    return {"phase": "breakdown", "updates": updates,
            "ms_per_update": per, "ms_per_update_total": sum(per.values()),
            "pack_ms": acc["pack"], "unpack_ms": acc["unpack"]}


def phase_default_path(side, updates, data_dir, device="cuda",
                       name="default_path", extra=None,
                       reason="TPU_SYSTEMATICS=1"):
    """The reference's default experiment (TPU_SYSTEMATICS=1): World.run
    through the per-update engine, one kernel launch per update, the host
    phylogeny fed from the newborn ring, dominant.dat written.  With
    `extra` = {"INST_SET": "heads_sex"} the same for the sexual world
    (sex_path), whose engine reason names divide-sex."""
    import torch
    from avida_tpu_torch.ops import cycles
    every = max(updates // 3, 1)
    ev = ["u begin InjectAll"] + [f"u 0:{every}:end {a}" for a in PRINTS]
    w = make_world(side, data_dir, device, ev,
                   dict({"TPU_SYSTEMATICS": 1}, **(extra or {})))
    host = time_host_drain(w)
    _sync(device)
    cycles.reset_launches()
    t0 = time.perf_counter()
    insts = w.run(max_updates=updates)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = cycles.LAUNCHES
    del w._feed_systematics, w.systematics.process      # the timers
    rep = w.engine_report()
    dats = dat_bodies(data_dir)
    rows = {f: [ln.split() for ln in v
                if ln.strip() and not ln.startswith("#")]
            for f, v in dats.items()}
    n_rows = updates // every + (updates % every > 0)
    merit = torch.where(w.state.alive, w.state.merit, 0.0)
    want = updates if torch.device(device).type == "cuda" else 0
    ok = (launches == want and w.update == updates
          and rep["engine"] == "per-update"
          and reason in rep["fallback_reason"]
          and w.num_organisms > 0 and bool(torch.isfinite(merit).all())
          and sorted(rows) == sorted(f"{a[5:-4].lower()}.dat"
                                     for a in PRINTS)
          and all(len(r) == n_rows for r in rows.values())
          and int(rows["count.dat"][-1][3]) > 0      # genotypes column
          and w.systematics.num_genotypes > 1
          and all(math.isfinite(float(x)) for r in rows["average.dat"]
                  for x in r))
    res = {"phase": name, "world": f"{side}x{side}",
           "inst_set": w.instset.name, "engine_report": rep,
           "updates": w.update,
           "kernel_launches": launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / updates, "wall_s": wall,
           "live_organisms": w.num_organisms,
           "births_total": int(w._total_births),
           "host_drain_s": host["drain_s"], "host_arbiter_s": host["arbiter_s"],
           "newborns_drained": host["newborns"],
           "genotypes": w.systematics.num_genotypes,
           "genotypes_total": len(w.systematics.genotypes),
           "dominant_row": rows["dominant.dat"][-1],
           "dat_files": sorted(rows)}
    if not ok:
        raise AssertionError(f"{name} check failed: {res}")
    return w, res


def time_host_drain(w):
    """Accumulate, over the run, the host time of the world's newborn
    drain (World._feed_systematics: the ring's copy to the host, which
    waits for the device work queued before it, and the phylogeny
    update) and of the arbiter's own share (GenotypeArbiter.process,
    pure host work).  Wraps the bound methods; changes nothing else."""
    acc = {"drain_s": 0.0, "arbiter_s": 0.0, "newborns": 0}
    feed, process = w._feed_systematics, w.systematics.process

    def timed_feed(snap=None):
        t0 = time.perf_counter()
        feed(snap)
        acc["drain_s"] += time.perf_counter() - t0

    def timed_process(update, alive, cells, *rest):
        t0 = time.perf_counter()
        process(update, alive, cells, *rest)
        acc["arbiter_s"] += time.perf_counter() - t0
        acc["newborns"] += len(cells)

    w._feed_systematics = timed_feed
    w.systematics.process = timed_process
    return acc


def phase_default_kernel(w, name="default_path"):
    """One per-update launch at a per-update path's evolved state, on the
    planes run_cycles builds there (lane-permuted by perm_phase): the
    Hopper kernel and the first port held against the plain version; then
    both kernels' CUDA-event times, in turns, and the bound."""
    import torch
    from avida_tpu_torch.ops import cycles, update
    from avida_tpu_torch.utils import prng
    p, st, u = w.params, w.state, w.update
    n = st.tape.shape[0]
    B, n_pad, _ = cycles.dims(p, n, p.max_memory)
    cap = update.static_cap(p)
    ks = prng.split(prng.fold_in(w._run_key, u), 3)
    _, granted, _ = update.schedule_phase(p, st, ks[0])
    st = update.perm_phase(p, st, granted, u)
    perm, inv = cycles.lane_order(p, st)
    if perm is None or bool((perm == torch.arange(
            n, dtype=perm.dtype, device=perm.device)).all()):
        raise AssertionError(f"{name}: no lane permutation in use")
    base = cycles.pack_state(p, st, granted, perm)
    seeds = cycles.block_seeds(ks[1], n_pad, B)
    kern, worst, plain_ms = hold_both(p, base, seeds, cap, B,
                                      f"the {name} launch")
    res = {"path": name, "max_abs_err": worst, "match": True,
           "lanes_permuted": True, "plain_ms": plain_ms}
    res.update(kernel_bound(base, kern, seeds))
    res.update(paired_ms(p, base, seeds, cap, B))
    res["reached"] = res["bound_ms"] / res["ms"]
    # the same organisms and budgets in cell order: what the permutation
    # buys each kernel
    ident = paired_ms(p, cycles.pack_state(p, st, granted), seeds, cap, B)
    res["ms_identity_lanes"] = ident["ms"]
    res["simple_ms_identity_lanes"] = ident["simple_ms"]
    return res


def kernel_ms(p, base, seeds, cap, B):
    """CUDA-event time of one launch on copies of `base` (the copy's own
    time subtracted); the seeds are drawn beforehand, as the wrapper's
    caller does."""
    from avida_tpu_torch.ops import cycles
    return launch_ms(base, lambda work: cycles.cycles(p, work, seeds, cap, B))


def launch_ms(base, launch):
    """CUDA-event time of launch(work) on copies `work` of `base`, the
    copy's own time subtracted."""
    work = tuple(t.clone() for t in base)

    def one():
        for dst, src in zip(work, base):
            dst.copy_(src)
        launch(work)

    def copy_only():
        for dst, src in zip(work, base):
            dst.copy_(src)

    return cuda_ms(one, 10) - cuda_ms(copy_only, 10)


# the helpers flush_births is composed of, timed inside the flush:
# (module, function name)
FLUSH_HELPERS = (("interpreter", "extract_offspring"),
                 ("birth", "recombine_sexual"),
                 ("birth", "fast_torus_placement"),
                 ("birth", "general_placement"),
                 ("birth", "newborn_fields"),
                 ("birth", "dual_births"),
                 ("birth", "ring_append"))


class timed_helpers:
    """Within the block, every FLUSH_HELPERS function is replaced by a
    device-synchronised timer around the original (the flush looks them
    up at call time), accumulating ms into `acc`."""

    def __init__(self, acc):
        from avida_tpu_torch.ops import birth, interpreter
        self.acc = acc
        self.mods = {"birth": birth, "interpreter": interpreter}
        self.saved = []

    def __enter__(self):
        import torch
        for mod_name, fn_name in FLUSH_HELPERS:
            mod = self.mods[mod_name]
            orig = getattr(mod, fn_name)

            def wrapper(*a, _orig=orig, _name=fn_name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                torch.cuda.synchronize()
                self.acc[_name] = self.acc.get(_name, 0.0) \
                    + 1e3 * (time.perf_counter() - t0)
                return out

            self.saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            setattr(mod, fn_name, orig)


def phase_default_breakdown(w, run, updates=3, name="default_breakdown"):
    """Per-phase device-synchronised wall time of the per-update engine's
    update (update_step's own phase functions, in its order, with
    run_cycles split into its pack / launch / unpack, and the flush split
    into the helpers it is composed of), on a copy of the path's state;
    beside it the host systematics drain per update, measured over the
    path's run (`run`, its result; births come in waves, so a few
    updates would not show it)."""
    import torch
    from avida_tpu_torch.ops import cycles, update
    from avida_tpu_torch.utils import prng
    p, st = w.params, w.state
    n = st.tape.shape[0]
    cap = update.static_cap(p)
    names = ("schedule", "perm", "pack", "kernel", "unpack", "bank",
             "flush", "stats")
    acc = dict.fromkeys(names, 0.0)
    split = {}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "flush":
            with timed_helpers(split):
                out = fn(*args)
        else:
            out = fn(*args)
        torch.cuda.synchronize()
        acc[name] += 1e3 * (time.perf_counter() - t0)
        return out

    st = st.replace(nb_count=torch.zeros_like(st.nb_count))
    for i in range(updates):
        u = w.update + i
        ks = prng.split(prng.fold_in(w._run_key, u), 3)
        alive_before = st.alive.sum().to(torch.int32)
        st = update.resource_phase(p, st, prng.fold_in(w._run_key, u), u)
        budgets, granted, _ = timed("schedule", update.schedule_phase, p, st,
                                    ks[0])
        st = timed("perm", update.perm_phase, p, st, granted, u)
        executed0 = st.insts_executed
        perm, inv = cycles.lane_order(p, st)
        planes = timed("pack", cycles.pack_state, p, st, granted, perm)
        timed("kernel", cycles.launch, p, planes, ks[1], cap, n)
        st = timed("unpack", cycles.unpack_state, p, st, planes, inv)
        st, _ = timed("bank", update.bank_phase, p, st, budgets, executed0)
        st = timed("flush", update.birth_phase, p, st, ks[2], ks[1], u)
        timed("stats", update.update_stats, p, st, alive_before, u)
    per = {k: v / updates for k, v in acc.items()}
    flush_split = {k: v / updates for k, v in split.items()}
    flush_split["rest"] = per["flush"] - sum(flush_split.values())
    n_run = run["updates"]
    return {"phase": name, "updates": updates,
            "ms_per_update": per, "ms_per_update_total": sum(per.values()),
            "flush_ms_per_update": flush_split,
            "run_host_drain_ms_per_update": 1e3 * run["host_drain_s"] / n_run,
            "run_host_arbiter_ms_per_update":
                1e3 * run["host_arbiter_s"] / n_run,
            "run_newborns_drained": run["newborns_drained"]}


def phase_costs_kernel(side, updates, tmp, device="cuda"):
    """The costs instruction set (COSTS_INSTSET: costs, first-time
    costs, prob_fail, addl_time_cost, unequal redundancies, nops off
    opcodes 0-2) at full width on the packed engine, one launch per
    update; then one launch at the evolved state held against the plain
    version, its CUDA-event time and byte bound."""
    from avida_tpu_torch.ops import cycles
    cdir = write_config_dir(os.path.join(tmp, "cfg_costs_kernel"),
                            instset=COSTS_INSTSET)
    w = make_world(side, os.path.join(tmp, "costs"), device,
                   ["u begin InjectAll"], None, cdir)
    _sync(device)
    cycles.reset_launches()
    t0 = time.perf_counter()
    insts = w.run(max_updates=updates)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = cycles.LAUNCHES
    rep = w.engine_report()
    p = w.params
    want = updates if w.device.type == "cuda" else 0
    ok = (launches == want and rep["engine"] == "packed"
          and w.num_organisms > 0 and bool(p.inst_cost)
          and bool(p.inst_ft_cost) and bool(p.inst_prob_fail)
          and bool(p.inst_addl_time_cost)
          and not cycles.uniform_mutation(p) and not p.is_nop[0]
          and bool((w.state.ft_paid_lo != 0).any()))
    kern = phase_kernel(w, n_launch=1)
    res = {"path": "costs_kernel", "world": f"{side}x{side}",
           "engine_report": rep, "updates": w.update, "launches": launches,
           "insts": insts, "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / updates,
           "live_organisms": w.num_organisms}
    res.update({k: v for k, v in kern.items()
                if k not in ("name", "route", "source", "replaces",
                             "launches", "match", "checked_launches",
                             "library_ms")})
    if not ok:
        raise AssertionError(f"costs_kernel check failed: {res}")
    return res


# (side, TPU_MAX_MEMORY): B = 128 (one CTA a cluster), B = 256 (a cluster
# of two), and the largest tile, L = 1024 (C = 64, a cluster of eight)
GEOMETRY_CASES = ((8, 384), (16, 384), (24, 1024))


def phase_geometry(tmp, updates=24, n_launch=3):
    """The Hopper kernel and the first port held word for word against the
    plain version at the launch geometries the 320x320 and 60x60 paths do
    not reach (GEOMETRY_CASES): each world runs the costs instruction set
    (COSTS_INSTSET) with mixed programs for `updates` updates on the card,
    then `n_launch` consecutive launches are checked on its state."""
    from avida_tpu_torch.ops import cycles
    cases = []
    for side, mem in GEOMETRY_CASES:
        cdir = write_config_dir(os.path.join(tmp, f"cfg_geom_{side}"),
                                instset=COSTS_INSTSET)
        w = make_world(side, os.path.join(tmp, f"geom_{side}"), "cuda",
                       ["u begin InjectAll"], {"TPU_MAX_MEMORY": mem}, cdir)
        w.process_events()
        reseed_mixed(w)
        w.run(max_updates=updates)
        kern = phase_kernel(w, n_launch=n_launch, time_it=False)
        p = w.params
        B, _, L = cycles.dims(p, p.num_cells, p.max_memory)
        C = cycles.cta_lanes(L, p.num_reactions, B)
        cases.append({"world": f"{side}x{side}", "B": B, "L": L, "C": C,
                      "cluster": B // C,
                      "smem_bytes": cycles.cta_smem_bytes(
                          L, p.num_reactions, C),
                      "checked_launches": n_launch,
                      "max_abs_err": kern["max_abs_err"],
                      "births": int(w._total_births),
                      "live_organisms": w.num_organisms})
    got = [(c["B"], c["L"], c["cluster"]) for c in cases]
    if got != [(128, 384, 1), (256, 384, 2), (512, 1024, 8)] \
            or any(c["births"] == 0 for c in cases):
        raise AssertionError(f"geometry phase reached {cases}")
    return {"phase": "geometry", "match": True, "cases": cases}


class one_thread:
    """Within the block, torch runs CPU operations on one intra-op thread
    (the plain versions on small worlds issue many tiny operations, which
    threads only slow down); the values are the same."""

    def __enter__(self):
        import torch
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        import torch
        torch.set_num_threads(self.n)


CPU_WORKERS = 3


def _cpu_worker_init():
    """A worker of cpu_jobs sees no card and runs torch on one intra-op
    thread, as one_thread does."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    torch.set_num_threads(1)


@contextlib.contextmanager
def cpu_jobs(workers=CPU_WORKERS):
    """Worker processes for the CPU halves of the cross-device phases,
    which then run beside the card's phases instead of after them.  A
    worker sees no card, so the card's kernels and timings share it with
    nothing; workers are spawned, not forked, as this process holds a
    CUDA context.  Leaving the block cancels the jobs not yet started and
    waits for the rest: no worker outlives it."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(workers, multiprocessing.get_context("spawn"),
                               initializer=_cpu_worker_init)
    try:
        yield pool
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def cpu_half(job, fn, *args):
    """The CPU half of a cross-device phase: its cpu_jobs job's result, or
    without a job fn(*args), run here on one thread."""
    if job is not None:
        return job.result()
    with one_thread():
        return fn(*args)


def cpu_root(tmp):
    """The directory the CPU halves write under: none of the card half's
    paths, whatever device the card half is given."""
    return os.path.join(tmp, "cpu_half")


def phase_size_range(tmp):
    """OFFSPRING_SIZE_RANGE 1.1 on the kernel route: every lane of an 8x8
    world set to divide a 29- or 30-site child of a 33-site genome (the
    reference's compiled minimum is 33 * f32(1 / 1.1f) = 29.999998 -> 29,
    a true division gives 30): both kernels held word for word against
    the plain version on one launch, and every lane divides."""
    import torch
    from avida_tpu_torch.ops import cycles, packed_chunk
    from avida_tpu_torch.utils import prng
    w = make_world(8, os.path.join(tmp, "size_range"), "cuda",
                   ["u begin InjectAll"], {"OFFSPRING_SIZE_RANGE": 1.1})
    w.process_events()
    st, p = w.state, w.params
    n = p.num_cells
    op = {nm: i for i, nm in enumerate(w.instset.inst_names)}
    tape = torch.full_like(st.tape, op["nop-A"])
    tape[:, 10] = op["h-divide"]
    tape[:, :30] |= 0x40
    tape[:, 30:60] |= 0x80
    heads = torch.tensor([10, 30, 0, 3], dtype=torch.int32,
                         device=w.device).expand(n, 4).clone()
    mem_len = 59 + torch.arange(n, dtype=torch.int32, device=w.device) % 2
    w.state = st.replace(tape=tape, heads=heads, mem_len=mem_len,
                         genome_len=torch.full_like(st.genome_len, 33),
                         mal_active=torch.ones_like(st.mal_active))
    pc = packed_chunk.pack_chunk(p, w.state)
    B, n_pad, _ = cycles.dims(p, n, p.max_memory)
    packed_chunk.schedule_phase(p, pc, prng.key(2, w.device))
    planes = []
    for t in (pc.tape_t, pc.off_t, pc.ivec, pc.fvec):
        out = torch.zeros((t.shape[0], n_pad), dtype=t.dtype,
                          device=t.device)
        out[:, :n] = t
        planes.append(out)
    seeds = cycles.block_seeds(prng.key(1, w.device), n_pad, B)
    kern, err, _ = hold_both(p, tuple(planes), seeds, 2, B, "size_range")
    divided = int(((kern[2][cycles.IV_FLAGS, :n] & cycles.FLAG_NEWDIV)
                   != 0).sum())
    if divided != n:
        raise AssertionError(f"size_range: {divided} of {n} lanes divided")
    return {"phase": "size_range", "offspring_size_range": 1.1,
            "lanes": n, "divided": divided, "max_abs_err": err}


def mw_members(side, seeds, tmp, tag, device, sysm, every, ckpt_root=None):
    """One World per seed, each seeded everywhere with the ancestor and
    printing every `every` updates into its own directory (dominant.dat
    with systematics); with ckpt_root, each saving a generation every
    MW_UPDATES/2 updates into its own directory under it."""
    ev = ["u begin InjectAll"] + [f"u 0:{every}:end {a}" for a in PRINTS
                                  if sysm or a != "PrintDominantData"]
    ck = ({} if ckpt_root is None
          else {"TPU_CKPT_EVERY": MW_UPDATES // 2, "TPU_CKPT_KEEP": 4})
    return [make_world(side, os.path.join(tmp, f"{tag}_{k:03d}"), device, ev,
                       dict(ck, RANDOM_SEED=s, TPU_SYSTEMATICS=sysm,
                            **({} if ckpt_root is None else {
                                "TPU_CKPT_DIR": os.path.join(
                                    ckpt_root, f"w{k:03d}")})))
            for k, s in enumerate(seeds)]


def phase_multiworld(name, sysm, tmp, side, seeds, updates, device="cuda",
                     ckpt_root=None):
    """A batch of len(seeds) worlds (MultiWorld.run, one stacked kernel
    launch per update for the batch): `multiworld_path` with systematics
    on (the batched per-update engine), `multiworld_packed` with
    TPU_SYSTEMATICS=0 (the stacked packed-resident engine).  Members 0
    and W-1 are then run solo on the same device and must equal their
    batch members: state bytes, .dat bytes apart from the date line, the
    genotype count."""
    import torch
    from avida_tpu_torch import convert
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    # with checkpoints, a print every 5 updates puts a chunk boundary at
    # each save (every MW_UPDATES/2)
    every = MW_CKPT_PRINTS if ckpt_root else 10
    mw = MultiWorld(mw_members(side, seeds, tmp, name, device, sysm, every,
                               ckpt_root))
    drains = [time_host_drain(w) for w in mw.worlds] if sysm else []
    _sync(device)
    cycles.reset_launches()
    t0 = time.perf_counter()
    insts = mw.run(max_updates=updates)
    _sync(device)
    wall = time.perf_counter() - t0
    launches, stacked = cycles.LAUNCHES, cycles.STACKED_LAUNCHES
    if sysm:
        for w in mw.worlds:
            del w._feed_systematics, w.systematics.process   # the timers
    W = len(seeds)
    solo = []
    for k in (0, W - 1):
        sw = mw_members(side, seeds[k:k + 1], tmp, f"{name}_solo{k}", device,
                        sysm, every)[0]
        _sync(device)
        t0 = time.perf_counter()
        s_insts = sw.run(max_updates=updates)
        _sync(device)
        s_wall = time.perf_counter() - t0
        mem = mw.worlds[k]
        a, b = convert.state_to_arrays(sw.state), \
            convert.state_to_arrays(mem.state)
        bad = [f for f in a if a[f] is not None
               and a[f].tobytes() != b[f].tobytes()]
        if dat_bodies(sw.data_dir) != dat_bodies(mem.data_dir):
            bad.append(".dat files")
        if sysm and sw.systematics.num_genotypes \
                != mem.systematics.num_genotypes:
            bad.append("genotype count")
        if bad:
            raise AssertionError(f"{name}: member {k} differs from its solo "
                                 f"run in {bad}")
        solo.append({"member": k, "seed": seeds[k], "insts": s_insts,
                     "org_inst_per_s": s_insts / s_wall,
                     "ms_per_update": 1e3 * s_wall / updates,
                     "genotypes": (sw.systematics.num_genotypes
                                   if sysm else None)})
    want = updates if torch.device(device).type == "cuda" else 0
    engine = "per-update" if sysm else "packed-stacked"
    files = sorted(dat_bodies(mw.worlds[0].data_dir))
    ok = (launches == want and stacked == want and mw.update == updates
          and mw.engine == engine
          and all(w.num_organisms > 0 for w in mw.worlds)
          and all(bool(torch.isfinite(w.state.merit).all())
                  for w in mw.worlds)
          and len(files) == (5 if sysm else 4))
    rate = insts / wall
    solo_rate = sum(s["org_inst_per_s"] for s in solo) / len(solo)
    res = {"phase": name, "worlds": W, "world": f"{side}x{side}",
           "organisms_per_world": side * side,
           "engine": mw.engine, "engine_report": mw.engine_report,
           "updates": mw.update, "kernel_launches": launches,
           "stacked_launches": stacked, "insts": insts,
           "org_inst_per_s": rate, "ms_per_update": 1e3 * wall / updates,
           "wall_s": wall, "solo": solo,
           "batch_efficiency": rate / (W * solo_rate),
           "batch_trip_efficiency": mw.trip_efficiency(),
           "live_organisms": sum(w.num_organisms for w in mw.worlds),
           "births_total": sum(int(w._total_births) for w in mw.worlds),
           "members_equal_solo": [s["member"] for s in solo],
           "dat_files": files}
    if sysm:
        res["host_drain_s"] = sum(d["drain_s"] for d in drains)
        res["host_arbiter_s"] = sum(d["arbiter_s"] for d in drains)
        res["newborns_drained"] = sum(d["newborns"] for d in drains)
        res["genotypes"] = [w.systematics.num_genotypes for w in mw.worlds]
    if not ok:
        raise AssertionError(f"{name} check failed: {res}")
    return mw, res


def mw_next_launch(mw):
    """The stacked planes the batch's next update hands the kernel (its
    engine's own phases up to the launch), with the worlds' k_steps keys:
    (base planes [rows, W * n_pad], k_steps)."""
    from avida_tpu_torch.core.state import stack_states, unstack_states
    from avida_tpu_torch.ops import cycles, packed_chunk, update
    from avida_tpu_torch.utils import prng
    p, u = mw.params, mw.update
    bst = stack_states([w.state for w in mw.worlds])
    ukeys = [prng.fold_in(w._run_key, u) for w in mw.worlds]
    if mw.engine == "packed-stacked":
        ks = [prng.split(k, 3) for k in ukeys]
        pw = packed_chunk.pack_worlds(p, bst)
        packed_chunk.schedule_phase_worlds(p, pw, [k[0] for k in ks])
        n_pad = cycles.dims(p, p.num_cells, p.max_memory)[1]
        return (packed_chunk.pad_worlds(
            (pw.tape_t, pw.off_t, pw.ivec, pw.fvec), n_pad),
            [k[1] for k in ks])
    pre = [update.mw_pre_phase(p, st, k, u)
           for st, k in zip(unstack_states(bst), ukeys)]
    return (update.mw_pack(p, [x[0] for x in pre], [x[1][1] for x in pre]),
            [x[1][3] for x in pre])


def phase_mw_kernel(mw, name, time_it=True):
    """One stacked launch on the batch's evolved planes held against the
    plain version on the same planes and seeds (max_abs_err; the first
    port too) and, world by world, against that world's solo launch; then
    the stacked launch's CUDA-event time, in turns with the first port's,
    beside the summed times of the W solo launches, and its bound."""
    from avida_tpu_torch.ops import cycles, update
    p = mw.params
    n = p.num_cells
    B, n_pad, _ = cycles.dims(p, n, p.max_memory)
    cap = update.static_cap(p)
    base, k_steps = mw_next_launch(mw)
    W = len(k_steps)
    wseeds = cycles.world_seed_bases(k_steps)
    seeds = cycles.stacked_block_seeds(wseeds, n_pad, B)

    def stacked(work):
        cycles.run_packed_stacked(p, work, wseeds, cap, B)

    kern, worst, plain_ms = hold_both(p, base, seeds, cap, B,
                                      f"the {name} stacked launch", stacked)

    def world(planes, w):
        return tuple(x[:, w * n_pad:(w + 1) * n_pad] for x in planes)

    solo_seeds = [cycles.block_seeds(k, n_pad, B) for k in k_steps]
    for w in range(W):
        sq = tuple(t.clone() for t in world(base, w))
        cycles.cycles(p, sq, solo_seeds[w], cap, B)
        compare_planes(world(kern, w), sq, f"{name} world {w}'s solo launch")
    res = {"path": name, "max_abs_err": worst, "match": True,
           "worlds_equal_solo_launches": W, "lanes": base[0].shape[1],
           "blocks": base[0].shape[1] // B, "plain_ms": plain_ms}
    res.update(kernel_bound(base, kern, seeds, pad_lanes=W * (n_pad - n)))
    if time_it:
        res.update(paired_ms(p, base, seeds, cap, B, stacked))
        res["reached"] = res["bound_ms"] / res["ms"]
        res["solo_ms_sum"] = sum(
            kernel_ms(p, tuple(t.clone() for t in world(base, w)),
                      solo_seeds[w], cap, B) for w in range(W))
    return res


def phase_mw_breakdown(mw, run, name, updates=2):
    """Per-phase device-synchronised wall time of one batched update (the
    engine's own phase functions, world by world, the launch once), on
    copies of the batch's state; with systematics, beside it the host
    drain per update measured over the path's run."""
    import torch
    from avida_tpu_torch.core.state import stack_states
    from avida_tpu_torch.ops import cycles, packed_chunk, update
    from avida_tpu_torch.utils import prng
    p, W = mw.params, mw.num_worlds
    cap = update.static_cap(p)
    B = cycles.dims(p, p.num_cells, p.max_memory)[0]
    acc = {}

    def timed(phase, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        acc[phase] = acc.get(phase, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    sts = [w.state.replace(nb_count=torch.zeros_like(w.state.nb_count))
           for w in mw.worlds]
    pw = None
    if mw.engine == "packed-stacked":
        pw = timed("pack", packed_chunk.pack_worlds, p, stack_states(sts))
    for i in range(updates):
        un = [mw.update + i] * W
        ukeys = [prng.fold_in(w._run_key, un[0]) for w in mw.worlds]
        if pw is not None:
            ks = [prng.split(k, 3) for k in ukeys]
            ab = packed_chunk.alive_rows(pw.ivec).sum(dim=1).to(torch.int32)
            budgets, e0, _ = timed("schedule",
                                   packed_chunk.schedule_phase_worlds, p, pw,
                                   [k[0] for k in ks])
            timed("kernel", packed_chunk.kernel_phase_worlds, p, pw,
                  [k[1] for k in ks])
            pw, _ = timed("bank", packed_chunk.bank_phase_worlds, p, pw,
                          budgets, e0)
            pw = timed("flush", packed_chunk.flush_phase_worlds, p, pw,
                       [k[2] for k in ks], un)
            timed("stats", packed_chunk.stats_rows_worlds, pw, ab, un)
            continue
        ab = [st.alive.sum().to(torch.int32) for st in sts]
        pre = timed("schedule+perm", lambda: [
            update.mw_pre_phase(p, st, k, u)
            for st, k, u in zip(sts, ukeys, un)])
        sts = [x[0] for x in pre]
        budgets, granted, _, k_steps, k_birth = zip(*[x[1] for x in pre])
        e0 = [st.insts_executed for st in sts]
        flat = timed("pack", update.mw_pack, p, sts, granted)
        timed("kernel", lambda: cycles.run_packed_stacked(
            p, flat, cycles.world_seed_bases(k_steps), cap, B))
        sts = timed("unpack", update.mw_unpack, p, sts, flat)
        sts = timed("bank", lambda: [
            update.bank_phase(p, st, b, e)[0]
            for st, b, e in zip(sts, budgets, e0)])
        sts = timed("flush", lambda: [
            update.birth_phase(p, st, kb, kst, u)
            for st, kb, kst, u in zip(sts, k_birth, k_steps, un)])
        timed("stats", lambda: [update.update_stats(p, st, a, u)
                                for st, a, u in zip(sts, ab, un)])
    if pw is not None:
        timed("unpack", packed_chunk.unpack_worlds, p, pw)
    per = {k: v / updates for k, v in acc.items()
           if pw is None or k not in ("pack", "unpack")}
    res = {"phase": name, "worlds": W, "updates": updates,
           "ms_per_update": per, "ms_per_update_total": sum(per.values())}
    if pw is not None:
        res.update(pack_ms=acc["pack"], unpack_ms=acc["unpack"])
    if "host_drain_s" in run:
        res["run_host_drain_ms_per_update"] = \
            1e3 * run["host_drain_s"] / run["updates"]
        res["run_host_arbiter_ms_per_update"] = \
            1e3 * run["host_arbiter_s"] / run["updates"]
    return res


MW_CROSS_SEEDS = (3, 11, 29)


def mw_cross_side(tmp, dev):
    """One device's half of multiworld_cross_device: for each engine, the
    members' state arrays and .dat bodies, and the batch's engine."""
    from avida_tpu_torch import convert
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    out = []
    for sysm in (1, 0):
        mw = MultiWorld(mw_members(8, MW_CROSS_SEEDS, tmp, f"mwx{sysm}_{dev}",
                                   dev, sysm, 4))
        mw.run(max_updates=16)
        _sync(dev)
        out.append(([convert.state_to_arrays(w.state) for w in mw.worlds],
                    [dat_bodies(w.data_dir) for w in mw.worlds], mw.engine))
    return out


def phase_mw_cross_device(tmp, cpu=None, device="cuda"):
    """A W = 3 batch of 8x8 worlds, 16 updates, on each engine, run on the
    card and on the CPU (the plain versions): every member must end in
    identical states and .dat bytes.  `cpu` is the cpu_jobs job of
    mw_cross_side's CPU half, else it runs here."""
    card = mw_cross_side(tmp, device)
    host = cpu_half(cpu, mw_cross_side, cpu_root(tmp), "cpu")
    results = []
    for (sa, da, ea), (sb, db, eb) in zip(card, host):
        bad = [(k, f) for k in range(len(sa)) for f in sa[k]
               if sa[k][f] is not None
               and sa[k][f].tobytes() != sb[k][f].tobytes()]
        bad += [(k, "dat") for k in range(len(da)) if da[k] != db[k]]
        births = sum(int((s["birth_update"] >= 0).sum()) for s in sb)
        if bad or ea != eb or births == 0:
            raise AssertionError(f"multiworld cross-device ({ea}, {eb}) "
                                 f"differs in {bad[:10]} (births {births})")
        results.append({"engine": ea, "worlds": len(sa), "world": "8x8",
                        "updates": 16, "births": births,
                        "dat_files_equal": sorted(da[0])})
    return {"phase": "multiworld_cross_device", "fields_equal": True,
            "cases": results}


# ---- the micro-step cycle engine (TPU_USE_PALLAS=2, and every
# configuration the kernel gate refuses) ----

# logic-9 plus math-family reactions with fractional values: an output
# that repeats a positive input performs math_1AJ (|x|) and, for the
# smaller of two inputs, math_2AC (x % y) -- several fractional rewards
# of one process type in one cycle
MATH_ENV_TEXT = """
REACTION NOT  not  process:value=1.0:type=pow requisite:max_count=1
REACTION NAND nand process:value=1.0:type=pow requisite:max_count=1
REACTION AND  and  process:value=2.0:type=pow requisite:max_count=1
REACTION ORN  orn  process:value=2.0:type=pow requisite:max_count=1
REACTION OR   or   process:value=3.0:type=pow requisite:max_count=1
REACTION ANDN andn process:value=3.0:type=pow requisite:max_count=1
REACTION NOR  nor  process:value=4.0:type=pow requisite:max_count=1
REACTION XOR  xor  process:value=4.0:type=pow requisite:max_count=1
REACTION EQU  equ  process:value=5.0:type=pow requisite:max_count=1
REACTION ABS1 math_1AJ process:value=1.37:type=mult requisite:max_count=2
REACTION REM1 math_2AC process:value=0.615:type=pow requisite:max_count=3
REACTION ABS2 math_1AJ process:value=0.83:type=mult
REACTION SUM2 math_2AN process:value=0.25:type=add
REACTION REM2 math_2AC process:value=1.19:type=mult
REACTION ABS3 math_1AJ process:value=0.3:type=pow
REACTION REM3 math_2AC process:value=0.77:type=add
REACTION ABS4 math_1AJ process:value=-0.45:type=pow
REACTION ABS5 math_1AJ process:value=0.33:type=add
REACTION ABS6 math_1AJ process:value=1.7:type=add
"""
XLA_PRINTS = PRINTS[:4]


def math_config_dir(cdir, text=MATH_ENV_TEXT):
    os.makedirs(cdir)
    with open(os.path.join(cdir, "avida.cfg"), "w") as f:
        f.write("INST_SET -\n")
    with open(os.path.join(cdir, "environment.cfg"), "w") as f:
        f.write(text)
    return cdir


def xla_breakdown(w, updates):
    """Per-phase device-synchronised wall ms of the per-update engine on
    the micro-step engine (update_step's phases in order) on the world's
    state, and each update's trip count (the cycles it runs, max_k)."""
    import torch
    from avida_tpu_torch.ops import update
    from avida_tpu_torch.utils import prng
    p, st = w.params, w.state
    # TransSMT offspring wait in the write buffer: no extraction phase
    smt = p.hw_type != 0
    acc = {k: 0.0 for k in ("schedule", "cycles", "materialize", "bank",
                            "flush", "stats") if not (smt and
                                                      k == "materialize")}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        acc[name] += 1e3 * (time.perf_counter() - t0)
        return out

    trips = []
    for i in range(updates):
        u = w.update + i
        key = prng.fold_in(w._run_key, u)
        ks = prng.split(key, 3)
        alive_before = st.alive.sum().to(torch.int32)
        budgets, granted, max_k = timed("schedule", update.schedule_phase,
                                        p, st, ks[0])
        trips.append(int(max_k))
        executed0 = st.insts_executed
        pending = st.divide_pending
        st = timed("cycles", update.run_micro_steps, p, st, ks[1], granted,
                   max_k)
        if not smt:
            st = timed("materialize", update.materialize_offspring, p, st,
                       pending)
        st, _ = timed("bank", update.bank_phase, p, st, budgets, executed0)
        st = timed("flush", update.birth_phase, p, st, ks[2], ks[1], u,
                   w.neighbors)
        timed("stats", update.update_stats, p, st, alive_before, u)
    per = {k: v / updates for k, v in acc.items()}
    return {"updates": updates, "trips": trips,
            "ms_per_update": per, "ms_per_update_total": sum(per.values()),
            "ms_per_cycle": acc["cycles"] / max(sum(trips), 1)}


def xla_trace(w, n_cycles=5):
    """torch.profiler over n_cycles micro-step cycles of the world's next
    update (after one untraced warm-up cycle): CUDA kernels a cycle, the
    device's busy ms a cycle (the kernels' summed time), the traced wall
    ms a cycle and the device's idle share.  The profiler adds host time,
    so the idle share is an upper bound; a trace with no device time
    reports null."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from avida_tpu_torch.ops import update
    from avida_tpu_torch.utils import prng
    p, st = w.params, w.state
    ks = prng.split(prng.fold_in(w._run_key, w.update), 3)
    _, granted, max_k = update.schedule_phase(p, st, ks[0])
    n = max(min(n_cycles, int(max_k)), 1)
    update.run_micro_steps(p, st, ks[1], granted, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        update.run_micro_steps(p, st, ks[1], granted, n)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_us, kernels = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels += ev.count
            busy_us += getattr(ev, "self_device_time_total",
                               getattr(ev, "self_cuda_time_total", 0.0))
    if busy_us == 0.0:
        return {"cycles": n, "traced_wall_ms_per_cycle": wall_ms / n,
                "device_busy_ms_per_cycle": None, "kernels_per_cycle": None,
                "idle_share": None}
    return {"cycles": n, "traced_wall_ms_per_cycle": wall_ms / n,
            "device_busy_ms_per_cycle": busy_us / 1e3 / n,
            "kernels_per_cycle": kernels / n,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms}


def _xla_run(w, updates):
    """World.run on the card with the cycle kernel's launches counted:
    (instructions, wall s, launches)."""
    import torch
    from avida_tpu_torch.ops import cycles
    torch.cuda.synchronize()
    cycles.reset_launches()
    t0 = time.perf_counter()
    insts = w.run(max_updates=updates)
    torch.cuda.synchronize()
    return insts, time.perf_counter() - t0, cycles.LAUNCHES


def _check_xla_world(w, name, res, files=None, reason="kernel off"):
    """The micro-step world's checks: routed off the kernel (for
    `reason`), no launch, live organisms with finite merits, the .dat
    files written."""
    import torch
    rep = w.engine_report()
    ok = (res["kernel_launches"] == 0 and rep["engine"] == "per-update"
          and reason in rep["fallback_reason"]
          and w.num_organisms > 0
          and bool(torch.isfinite(w.state.merit).all())
          and (files is None or sorted(dat_bodies(w.data_dir)) == files))
    if not ok:
        raise AssertionError(f"{name} check failed: {res} {rep}")


def phase_xla_path(side, updates, data_dir, smi):
    """The headline world (every cell seeded, systematics off) with
    TPU_USE_PALLAS=2: World.run on the micro-step engine, no kernel
    launch; then its phases timed one by one over two more updates."""
    ev = ["u begin InjectAll"] + [f"u 0:{updates}:end {a}"
                                  for a in XLA_PRINTS]
    w = make_world(side, data_dir, "cuda", ev, {"TPU_USE_PALLAS": 2})
    insts, wall, launches = _xla_run(w, updates)
    res = {"phase": "xla_path", "world": f"{side}x{side}",
           "engine_report": w.engine_report(), "updates": w.update,
           "kernel_launches": launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / updates, "wall_s": wall,
           "live_organisms": w.num_organisms, "nvidia_smi": smi}
    _check_xla_world(w, "xla_path", res, ["average.dat", "count.dat",
                                          "tasks.dat", "time.dat"])
    res["breakdown"] = xla_breakdown(w, 2)
    res["trace"] = xla_trace(w)
    return res


def phase_math_path(side, updates, tmp, smi):
    """Logic-9 plus math-family reactions with fractional values under the
    default TPU_USE_PALLAS=0: the kernel gate refuses math tasks, so the
    world routes to the micro-step engine (no launch); a third of the
    cells run a task program, a third random genomes, and the math
    reactions must reward."""
    import torch
    cdir = math_config_dir(os.path.join(tmp, "cfg_math"))
    w = make_world(side, os.path.join(tmp, "math"), "cuda",
                   ["u begin InjectAll"], {}, cdir)
    w.process_events()
    reseed_mixed(w)
    insts, wall, launches = _xla_run(w, updates)
    st = w.state
    performed = st.task_exe_total.sum(dim=0).tolist()
    frac = st.cur_bonus[st.alive]
    res = {"phase": "math_path", "world": f"{side}x{side}",
           "reactions": w.params.num_reactions,
           "engine_report": w.engine_report(), "updates": w.update,
           "kernel_launches": launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / updates, "wall_s": wall,
           "math_performed": performed[9:],
           "fractional_bonus_organisms": int((frac != frac.round()).sum()),
           "nvidia_smi": smi}
    _check_xla_world(w, "math_path", res)
    if sum(performed[9:]) == 0 or res["fractional_bonus_organisms"] == 0 \
            or not bool(torch.isfinite(st.cur_bonus).all()):
        raise AssertionError(f"math_path: no math reward: {res}")
    res["breakdown"] = xla_breakdown(w, 1)
    return res


def _fields_equal(a, b, skip=("lane_perm", "lane_inv")):
    """Names of the state fields that differ bit for bit (on the card)."""
    import dataclasses
    import torch
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in skip or x is None:
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(f.name)
    return bad


def phase_engines_agree(side, updates, tmp):
    """The reference's cross-engine configuration at full width: mutations
    off, SLICING_METHOD 0, AVE_TIME_SLICE 100, TPU_MAX_STEPS_PER_UPDATE
    100.  The kernel (packed engine) and the micro-step engine start from
    one state; after every update every field but the lane permutation
    must be equal."""
    import torch
    extra = dict(COPY_MUT_PROB=0.0, DIVIDE_INS_PROB=0.0, DIVIDE_DEL_PROB=0.0,
                 SLICING_METHOD=0, AVE_TIME_SLICE=100,
                 TPU_MAX_STEPS_PER_UPDATE=100)
    wk = make_world(side, os.path.join(tmp, "agree_k"), "cuda",
                    ["u begin InjectAll"], dict(extra, TPU_USE_PALLAS=0))
    wx = make_world(side, os.path.join(tmp, "agree_x"), "cuda",
                    ["u begin InjectAll"], dict(extra, TPU_USE_PALLAS=2))
    from avida_tpu_torch.ops import cycles
    walls = {"kernel": 0.0, "micro_step": 0.0}
    launches = 0
    for u in range(1, updates + 1):
        for name, w in (("kernel", wk), ("micro_step", wx)):
            torch.cuda.synchronize()
            cycles.reset_launches()
            t0 = time.perf_counter()
            w.run(max_updates=u)
            torch.cuda.synchronize()
            walls[name] += time.perf_counter() - t0
            if name == "kernel":
                launches += cycles.LAUNCHES
            elif cycles.LAUNCHES:
                raise AssertionError("engines_agree: the micro-step world "
                                     "launched the kernel")
        bad = _fields_equal(wk.state, wx.state)
        if bad:
            raise AssertionError(f"engines_agree: update {u}: the engines "
                                 f"differ in {bad}")
    divides = int(wx.state.num_divides.sum())
    births = int(wx._total_births)
    if divides == 0 or births == 0 or launches != updates \
            or wk.engine_report()["engine"] != "packed":
        raise AssertionError(f"engines_agree: divides {divides}, births "
                             f"{births}, launches {launches}")
    return {"phase": "engines_agree", "world": f"{side}x{side}",
            "updates": updates, "fields_equal": True,
            "skipped": ["lane_perm", "lane_inv"], "divides": divides,
            "births": births, "kernel_launches": launches,
            "ms_per_update": {k: 1e3 * v / updates for k, v in walls.items()}}


XLA_CROSS_SEEDS = (3, 11, 29)
XLA_CROSS_UPDATES = 7


def xla_cross_side(tmp, dev, updates=XLA_CROSS_UPDATES):
    """One device's half of xla_cross_device: the solo math world's state
    arrays and .dat bodies, the batch members' arrays and .dat bodies,
    and the batch's engine."""
    from avida_tpu_torch import convert
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    cdir = math_config_dir(os.path.join(tmp, "cfg_xla_cross"))
    ev = ["u begin InjectAll"] + [f"u 0:4:end {a}" for a in XLA_PRINTS]
    extra = {"TPU_USE_PALLAS": 2, "AVE_TIME_SLICE": 60}
    w = make_world(24, os.path.join(tmp, f"xla_x_{dev}"), dev, ev, extra,
                   cdir)
    w.process_events()
    reseed_mixed(w)
    mw = MultiWorld([make_world(
        8, os.path.join(tmp, f"xla_mw_{dev}_{k}"), dev, ev,
        dict(extra, RANDOM_SEED=s)) for k, s in enumerate(XLA_CROSS_SEEDS)])
    w.run(max_updates=updates)
    mw.run(max_updates=updates)
    _sync(dev)
    return (convert.state_to_arrays(w.state), dat_bodies(w.data_dir),
            [convert.state_to_arrays(x.state) for x in mw.worlds],
            [dat_bodies(x.data_dir) for x in mw.worlds], mw.engine)


def phase_xla_cross_device(tmp, cpu=None, device="cuda",
                           updates=XLA_CROSS_UPDATES):
    """TPU_USE_PALLAS=2 on the card and on the CPU must end identical: a
    24x24 world with mutations on, mixed programs and the math
    environment, and a W = 3 batch of 8x8 worlds (the folded engine);
    states and .dat bytes.  `cpu` is the cpu_jobs job of xla_cross_side's
    CPU half, else it runs here."""
    sa, da, ma, mda, ea = xla_cross_side(tmp, device, updates)
    sb, db, mb, mdb, eb = cpu_half(cpu, xla_cross_side, cpu_root(tmp), "cpu",
                                   updates)
    bad = [k for k in sa if sa[k] is not None
           and sa[k].tobytes() != sb[k].tobytes()]
    if da != db:
        bad.append(".dat files")
    bad += [(k, f) for k in range(len(ma)) for f in ma[k]
            if ma[k][f] is not None and ma[k][f].tobytes() != mb[k][f].tobytes()]
    bad += [(k, "dat") for k in range(len(mda)) if mda[k] != mdb[k]]
    births = int((sb["birth_update"] >= 0).sum())
    mw_births = sum(int((s["birth_update"] >= 0).sum()) for s in mb)
    if bad or births == 0 or mw_births == 0 or ea != "per-update" \
            or eb != ea:
        raise AssertionError(f"xla_cross_device: cuda vs cpu differ in "
                             f"{bad[:10]} (births {births}, {mw_births})")
    return {"phase": "xla_cross_device", "fields_equal": True,
            "cases": [{"case": "solo_math", "world": "24x24",
                       "updates": updates, "births": births,
                       "math_performed": int(sb["task_exe_total"][:, 9:].sum()),
                       "dat_files_equal": sorted(da)},
                      {"case": "batch", "worlds": len(ma), "world": "8x8",
                       "engine": ea, "updates": updates,
                       "births": mw_births}]}


def fold_member(kind, side, seed, updates, data_dir, device):
    """A member of a folded batch: multiworld_fold's stock world with
    TPU_USE_PALLAS=2 ("heads") or smt_fold's TransSMT host-parasite world
    ("smt"), printing at `updates`."""
    ev = [f"u 0:{updates}:end {a}" for a in XLA_PRINTS]
    if kind == "smt":
        return smt_world(side, data_dir, device, {"RANDOM_SEED": seed}, ev)
    return make_world(side, data_dir, device, ["u begin InjectAll"] + ev,
                      {"RANDOM_SEED": seed, "TPU_USE_PALLAS": 2})


def fold_solo(tmp, kind, side, seed, updates, device="cpu"):
    """A folded batch's member run alone: its state arrays and .dat
    bodies after `updates`."""
    from avida_tpu_torch import convert
    w = fold_member(kind, side, seed, updates,
                    os.path.join(tmp, f"{kind}_fold_solo_{seed}_{device}"),
                    device)
    w.run(max_updates=updates)
    _sync(device)
    return convert.state_to_arrays(w.state), dat_bodies(w.data_dir)


def fold_members_equal(tmp, mw, kind, name, seeds, updates, cpu):
    """Members FOLD_CHECKED of a folded batch on the card against their
    solo runs on the CPU (`cpu`: their cpu_jobs jobs, else run here):
    state arrays and .dat bytes; the members checked."""
    from avida_tpu_torch import convert
    side = mw.worlds[0].params.world_x
    for j, k in enumerate(FOLD_CHECKED):
        sb, db = cpu_half(None if cpu is None else cpu[j], fold_solo,
                          cpu_root(tmp), kind, side, seeds[k], updates)
        sa = convert.state_to_arrays(mw.worlds[k].state)
        bad = [f for f in sa if sa[f] is not None
               and sa[f].tobytes() != sb[f].tobytes()]
        if dat_bodies(mw.worlds[k].data_dir) != db:
            bad.append(".dat files")
        if bad:
            raise AssertionError(f"{name}: member {k} differs from its solo "
                                 f"run on the CPU in {bad}")
    return list(FOLD_CHECKED)


def phase_multiworld_fold(tmp, side, seeds, updates, smi, cpu=None):
    """16 stock 60x60 worlds with TPU_USE_PALLAS=2: MultiWorld.run on the
    folded micro-step engine (one micro_step a cycle for the whole batch),
    no launch; members 0 and 15 equal their solo runs on the CPU."""
    import torch
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    mw = MultiWorld([fold_member("heads", side, s, updates,
                                 os.path.join(tmp, f"fold_{k:03d}"), "cuda")
                     for k, s in enumerate(seeds)])
    torch.cuda.synchronize()
    cycles.reset_launches()
    t0 = time.perf_counter()
    insts = mw.run(max_updates=updates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, stacked = cycles.LAUNCHES, cycles.STACKED_LAUNCHES
    checked = fold_members_equal(tmp, mw, "heads", "multiworld_fold", seeds,
                                 updates, cpu)
    res = {"phase": "multiworld_fold", "worlds": len(seeds),
           "world": f"{side}x{side}", "engine": mw.engine,
           "engine_report": mw.engine_report, "updates": mw.update,
           "kernel_launches": launches, "stacked_launches": stacked,
           "insts": insts, "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / updates, "wall_s": wall,
           "batch_trip_efficiency": mw.trip_efficiency(),
           "live_organisms": sum(w.num_organisms for w in mw.worlds),
           "members_equal_solo": checked, "nvidia_smi": smi}
    if launches or stacked or mw.engine != "per-update" \
            or any(w.num_organisms == 0 for w in mw.worlds):
        raise AssertionError(f"multiworld_fold check failed: {res}")
    return res


def phase_kernel_limits(tmp):
    """On the card, the kernel route refuses what csrc/cycles.cu cannot
    hold at World construction, naming the limit (a 1088-site tape, 33
    reactions); TPU_USE_PALLAS=2 runs the same configurations."""
    from avida_tpu_torch.ops import cycles
    env33 = "".join(f"REACTION R{k} not process:value=1.0:type=pow\n"
                    for k in range(33))
    cdir = math_config_dir(os.path.join(tmp, "cfg_r33"), env33)
    cases = []
    for name, extra, cfg, needle in (
            ("tape_1088", {"TPU_MAX_MEMORY": 1088}, None, "1024 sites"),
            ("reactions_33", {}, cdir, "32 reactions")):
        try:
            make_world(8, os.path.join(tmp, f"lim_{name}"), "cuda", [],
                       extra, cfg)
        except NotImplementedError as e:
            if needle not in str(e) or "TPU_USE_PALLAS=2" not in str(e):
                raise AssertionError(f"{name}: refusal does not name the "
                                     f"limit: {e}")
        else:
            raise AssertionError(f"{name}: the kernel route was not refused")
        w = make_world(8, os.path.join(tmp, f"lim2_{name}"), "cuda",
                       ["u begin InjectAll"], dict(extra, TPU_USE_PALLAS=2),
                       cfg)
        cycles.reset_launches()
        w.run(max_updates=1)
        if cycles.LAUNCHES or w.num_organisms == 0:
            raise AssertionError(f"{name}: the micro-step run failed")
        cases.append({"case": name, "refused_with": needle,
                      "micro_step_runs": True})
    return {"phase": "kernel_limits", "cases": cases}


# TransSMT hardware and host-parasite coevolution (BASELINE config 4) on
# the headline construction: PARASITE_VIRULENCE as in the reference's
# host-parasite scenario (tests/test_transsmt.py)
SMT = {"INST_SET": "transsmt", "TPU_MAX_MEMORY": 384,
       "PARASITE_VIRULENCE": 0.8}
I32_MIN = -2**31


def smt_world(side, data_dir, device, extra=None, events=()):
    """A TransSMT world with every cell seeded with the ancestor
    (InjectAll) and the stock parasite in every other cell."""
    import torch
    from avida_tpu_torch.world import default_parasite
    w = make_world(side, data_dir, device, ["u begin InjectAll"]
                   + list(events), dict(SMT, **(extra or {})))
    w.process_events()
    n = w.params.num_cells
    w.inject_parasite(default_parasite(w.instset),
                      torch.arange(n, device=w.device) % 2 == 0)
    return w


def smt_counts(st):
    """(living hosts, living parasites) of a TransSMT state."""
    return (int(st.alive.sum()), int((st.alive & st.parasite_active).sum()))


def smt_run(w, updates):
    """World.run one update at a time up to `updates`, on the card with
    the cycle kernel's launches counted: (instructions, wall s, launches,
    infections per update).  An infection is a cell whose parasite flag
    the birth flush's injections set."""
    import torch
    from avida_tpu_torch.ops import cycles
    torch.cuda.synchronize()
    cycles.reset_launches()
    infections, insts, wall = [], 0, 0.0
    for u in range(w.update + 1, updates + 1):
        before = w.state.parasite_active.clone()
        t0 = time.perf_counter()
        insts += w.run(max_updates=u)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        infections.append(int((w.state.parasite_active & ~before).sum()))
    return insts, wall, cycles.LAUNCHES, infections


def phase_smt_path(side, updates, data_dir, smi):
    """The headline world on TransSMT hardware, hosts and parasites: the
    micro-step engine (micro_step_smt), no kernel launch.  World.run to
    `updates`, then one more update timed phase by phase (its flush
    includes the injections) and run: hosts and parasites alive,
    infections landing."""
    import torch
    w = smt_world(side, data_dir, "cuda", events=[
        f"u 0:{updates}:end {a}" for a in XLA_PRINTS])
    hosts0, para0 = smt_counts(w.state)
    insts, wall, launches, infections = smt_run(w, updates)
    breakdown = xla_breakdown(w, 1)
    t_insts, t_wall, t_launches, t_inf = smt_run(w, updates + 1)
    hosts, para = smt_counts(w.state)
    res = {"phase": "smt_path", "world": f"{side}x{side}",
           "engine_report": w.engine_report(), "updates": w.update,
           "kernel_launches": launches + t_launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / updates, "wall_s": wall,
           "timed_update": {"update": w.update, "insts": t_insts,
                            "ms": 1e3 * t_wall,
                            "org_inst_per_s": t_insts / t_wall,
                            "infections": t_inf[0]},
           "breakdown": breakdown,
           "hosts_start": hosts0, "parasites_start": para0,
           "hosts": hosts, "parasites": para,
           "infections_per_update": infections + t_inf,
           "births": int(w._total_births), "nvidia_smi": smi}
    _check_xla_world(w, "smt_path", res, ["average.dat", "count.dat",
                                          "tasks.dat", "time.dat"],
                     reason="non-heads hardware")
    if hosts == 0 or para == 0 or sum(infections + t_inf) == 0 \
            or not bool(torch.isfinite(w.state.fitness).all()):
        raise AssertionError(f"smt_path: hosts {hosts}, parasites {para}, "
                             f"infections {infections + t_inf}")
    return res


def plant_division(w):
    """Cells 1, 3, 5 and 7 (no parasite): Val-Div, Val-Mod, Val-Div,
    Val-Mod under the host's IP over BX = INT_MIN and CX = -1 (cells 5
    and 7: CX = 0, no push)."""
    st = w.state
    names = w.instset.inst_names
    tape, stacks = st.tape.clone(), st.smt_stacks.clone()
    for c, op, b in ((1, "Val-Div", -1), (3, "Val-Mod", -1),
                     (5, "Val-Div", 0), (7, "Val-Mod", 0)):
        tape[c, 0] = names.index(op)
        tape[c, 1] = names.index("Val-Inc")
        stacks[c, 0, 1] = I32_MIN
        stacks[c, 0, 2] = b
    w.state = st.replace(tape=tape, smt_stacks=stacks)


SMT_CROSS_UPDATES = 14


def smt_cross_side(tmp, dev, updates=SMT_CROSS_UPDATES):
    """One device's half of smt_cross_device: the BX stack tops after the
    planted divisions' cycle, the state arrays then and after every
    update, the .dat bodies, the infections and births of the run and the
    living hosts and parasites."""
    import torch
    from avida_tpu_torch import convert
    from avida_tpu_torch.ops.interpreter_smt import micro_step_smt
    from avida_tpu_torch.utils import prng
    extra = {"TPU_MAX_MEMORY": 160, "AVE_TIME_SLICE": 100,
             "TPU_MAX_STEPS_PER_UPDATE": 100, "RANDOM_SEED": 31}
    ev = [f"u 0:1:end {a}" for a in XLA_PRINTS]
    w = smt_world(10, os.path.join(tmp, f"smt_x_{dev}"), dev, extra, ev)
    plant_division(w)
    st = micro_step_smt(w.params, w.state, prng.key(5, w.device),
                        w.state.alive)
    sp = st.smt_sp[[1, 3, 5, 7], 0, 1].long()
    tops = st.smt_stacks[[1, 3, 5, 7], 0, 1][torch.arange(4), sp]
    first = convert.state_to_arrays(st)
    per_update, infections = [], 0
    for u in range(1, updates + 1):
        before = w.state.parasite_active.clone()
        w.run(max_updates=u)
        infections += int((w.state.parasite_active & ~before).sum())
        per_update.append(convert.state_to_arrays(w.state))
    _sync(dev)
    return (tops.tolist(), first, per_update, dat_bodies(w.data_dir),
            infections, int(w._total_births), smt_counts(w.state))


def phase_smt_cross_device(tmp, cpu=None, device="cuda",
                           updates=SMT_CROSS_UPDATES):
    """TransSMT on the card and on the CPU must end identical: the smt_path
    construction at 10x10 (the reference's TransSMT tests' world: 160
    sites, time slices of 100), INT_MIN and -1 planted under Val-Div and
    Val-Mod; first one micro_step_smt cycle (INT_MIN // -1 = INT_MIN and
    INT_MIN % -1 = 0 on the BX stack, the same on both devices), then
    World.run: states and .dat bytes after every update, births and
    infections in the run.  `cpu` is the cpu_jobs job of smt_cross_side's
    CPU half, else it runs here."""
    ta, fa, ua, da, ia, ba, ca = smt_cross_side(tmp, device, updates)
    tb, fb, ub, db, ib, bb, cb = cpu_half(cpu, smt_cross_side, cpu_root(tmp),
                                          "cpu", updates)
    bad = [k for k in fa if fa[k] is not None
           and fa[k].tobytes() != fb[k].tobytes()]
    bad += [(u + 1, k) for u in range(updates) for k in ua[u]
            if ua[u][k] is not None and ua[u][k].tobytes() != ub[u][k].tobytes()]
    if da != db:
        bad.append(".dat files")
    if bad or ta != tb or ta != [I32_MIN, 0, I32_MIN, I32_MIN] \
            or ia == 0 or ba == 0:
        raise AssertionError(f"smt_cross_device: cuda vs cpu differ in "
                             f"{bad[:10]}; BX tops {ta} / {tb}; infections "
                             f"{ia}, births {ba}")
    return {"phase": "smt_cross_device", "fields_equal": True,
            "world": "10x10", "updates": updates,
            "division_tops": ta, "births": ba, "infections": ia,
            "hosts_parasites": ca, "dat_files_equal": sorted(da)}


def phase_smt_fold(tmp, side, seeds, updates, smi, cpu=None):
    """16 TransSMT host-parasite worlds of 60x60 (the fleet's seeds) on the
    folded micro-step engine: MultiWorld.run, no launch; members 0 and 15
    equal their solo runs on the CPU."""
    import torch
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    mw = MultiWorld([fold_member("smt", side, s, updates,
                                 os.path.join(tmp, f"smt_fold_{k:03d}"),
                                 "cuda")
                     for k, s in enumerate(seeds)])
    torch.cuda.synchronize()
    cycles.reset_launches()
    t0 = time.perf_counter()
    insts = mw.run(max_updates=updates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, stacked = cycles.LAUNCHES, cycles.STACKED_LAUNCHES
    checked = fold_members_equal(tmp, mw, "smt", "smt_fold", seeds, updates,
                                 cpu)
    counts = [smt_counts(w.state) for w in mw.worlds]
    res = {"phase": "smt_fold", "worlds": len(seeds),
           "world": f"{side}x{side}", "engine": mw.engine,
           "engine_report": mw.engine_report, "updates": mw.update,
           "kernel_launches": launches, "stacked_launches": stacked,
           "insts": insts, "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / updates, "wall_s": wall,
           "batch_trip_efficiency": mw.trip_efficiency(),
           "hosts": sum(c[0] for c in counts),
           "parasites": sum(c[1] for c in counts),
           "members_equal_solo": checked, "nvidia_smi": smi}
    if launches or stacked or mw.engine != "per-update" \
            or any(c[0] == 0 for c in counts):
        raise AssertionError(f"smt_fold check failed: {res}")
    return res


MW_SIDE, MW_UPDATES = 60, 16   # the fleet batch: 16 stock 60x60 worlds
MW_CKPT_PRINTS = MW_UPDATES // 4   # the saving batch prints every 4
MW_SEEDS = tuple(range(101, 117))  # TPU_FLEET_MAX_BATCH = 16 members
FOLD_CHECKED = (0, len(MW_SEEDS) - 1)   # folded members held to solo runs

SIDE, UPDATES = 320, 50        # the main path's full-width world
DEFAULT_UPDATES = 30           # the default and sexual paths' depth
COSTS_UPDATES = 10             # the costs world's depth
XLA_UPDATES = 3                # the micro-step paths' depth at 320x320
AGREE_UPDATES = 6              # engines_agree: the first divides land
FOLD_UPDATES = 6               # the folded batch's depth
# the TransSMT paths' depth: at time slices of 30 the first divides and
# injections land from about update 16 (a 12x12 CPU run, seed 11; the
# 320x320 world's first infections at 16); the batch stops at 18
SMT_UPDATES, SMT_FOLD_UPDATES = 20, 18


# ---- persistence (native checkpoints, resume, preemption, the digest
# and the scrub, .spop) ----

PERSIST_UPDATES, PERSIST_AT = 40, 20    # persist_path: saves every 10
PERSIST_EVENTS = ["u begin InjectAll"] + [
    f"u 0:10:end {a}" for a in PRINTS[:4]]


def persist_config_dir(tmp):
    """The headline world's config directory for persist_path and the
    preempt_cli child: avida.cfg with the built-in set, events.cfg with
    PERSIST_EVENTS (the CLI reads its events from there)."""
    cdir = write_config_dir(os.path.join(tmp, "persist_cfg"))
    with open(os.path.join(cdir, "events.cfg"), "w") as f:
        f.write("\n".join(PERSIST_EVENTS) + "\n")
    return cdir


def gen_mb(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)) / 1e6


def state_diff(a, b):
    """Fields where two worlds' states differ (the newborn ring's record
    rows compared up to its cursor: past it they are scratch whose
    contents depend on where drains fell)."""
    from avida_tpu_torch import convert
    sa, sb = convert.state_to_arrays(a.state), convert.state_to_arrays(b.state)
    cnt = int(sa["nb_count"])
    bad = []
    for k, v in sa.items():
        if v is None:
            continue
        w = sb[k]
        if k.startswith("nb_") and k != "nb_count":
            v, w = v[:cnt], w[:cnt]
        if v.tobytes() != w.tobytes():
            bad.append(k)
    return bad


def generation_arrays_equal(a, b):
    """Names of the .npy files that differ between two generations."""
    fa = sorted(f for f in os.listdir(a) if f.endswith(".npy"))
    fb = sorted(f for f in os.listdir(b) if f.endswith(".npy"))
    if fa != fb:
        return ["file set"]
    bad = []
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            if x.read() != y.read():
                bad.append(f)
    return bad


def phase_persist_path(tmp, smi):
    """The headline world on the packed engine with TPU_CKPT_EVERY=10 and
    TPU_STATE_DIGEST=1 for PERSIST_UPDATES updates; a second World
    resumes the generation at PERSIST_AT and runs to the end.  Checks:
    the resumed state equals the uninterrupted one field by field, every
    .dat file equal, K1 launched once per resumed update, the manifest's
    digest equal to the device digest of the live state.  Times: a save,
    a resume, a digest (CUDA-synchronised wall)."""
    import shutil

    import torch
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.ops.digest import state_digest
    from avida_tpu_torch.utils import checkpoint as ckpt_mod
    cdir = persist_config_dir(tmp)
    ck = os.path.join(tmp, "persist_ck")
    extra = {"TPU_CKPT_DIR": ck, "TPU_CKPT_EVERY": 10, "TPU_CKPT_KEEP": 8,
             "TPU_STATE_DIGEST": 1}
    a = make_world(SIDE, os.path.join(tmp, "persist_a"), "cuda",
                   PERSIST_EVENTS, extra, config_dir=cdir)
    a.run(max_updates=PERSIST_UPDATES)
    _sync("cuda")
    gens = [ckpt_mod.generation_update(g)
            for g in ckpt_mod.list_generations(ck)]
    last = os.path.join(ck, ckpt_mod.generation_name(PERSIST_UPDATES))
    stored = ckpt_mod.verify_generation(last)["state_digest"]
    t0 = time.perf_counter()
    live = int(state_digest(a.state))
    digest_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    path = a.save_checkpoint(os.path.join(tmp, "persist_timed"))
    save_ms = 1e3 * (time.perf_counter() - t0)

    d_b = os.path.join(tmp, "persist_b")
    shutil.copytree(a.data_dir, d_b)
    ck_b = os.path.join(tmp, "persist_ck_b")
    shutil.copytree(ck, ck_b)
    b = make_world(SIDE, d_b, "cuda", PERSIST_EVENTS,
                   dict(extra, TPU_CKPT_DIR=ck_b), config_dir=cdir)
    _sync("cuda")
    t0 = time.perf_counter()
    at = b.resume(at_update=PERSIST_AT)
    _sync("cuda")
    resume_ms = 1e3 * (time.perf_counter() - t0)
    cycles.reset_launches()
    b.run(max_updates=PERSIST_UPDATES)
    _sync("cuda")
    launches = cycles.LAUNCHES
    bad = state_diff(a, b)
    if dat_bodies(a.data_dir) != dat_bodies(d_b):
        bad.append(".dat files")
    res = {"phase": "persist_path", "nvidia_smi": smi,
           "world": f"{SIDE}x{SIDE}", "engine_report": b.engine_report(),
           "updates": b.update, "resumed_at": at, "generations": gens,
           "kernel_launches_after_resume": launches,
           "state_digest": f"{live:#010x}",
           "manifest_digest": f"{stored:#010x}", "digest_ms": digest_ms,
           "save_ms": save_ms, "resume_ms": resume_ms,
           "generation_mb": gen_mb(path), "differs": bad,
           "dat_files": sorted(dat_bodies(d_b))}
    ok = (not bad and at == PERSIST_AT and launches == PERSIST_UPDATES - at
          and stored == live and gens == [10, 20, 30, 40]
          and b.num_organisms > 0
          and bool(torch.isfinite(b.state.merit).all()))
    if not ok:
        raise AssertionError(f"persist_path check failed: {res}")
    return res, os.path.join(ck, ckpt_mod.generation_name(PERSIST_UPDATES))


def phase_persist_default(tmp, smi, updates=DEFAULT_UPDATES):
    """The default_path configuration (systematics on, per-update engine),
    saved at updates/2 and resumed to `updates`: the state, dominant.dat
    and every .dat file, and systematics.json of the end generation equal
    to the uninterrupted run's."""
    import shutil

    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.utils import checkpoint as ckpt_mod
    half = updates // 2
    every = max(updates // 6, 1)
    ev = ["u begin InjectAll"] + [f"u 0:{every}:end {a}" for a in PRINTS]
    ck = os.path.join(tmp, "pdef_ck")
    extra = {"TPU_SYSTEMATICS": 1, "TPU_CKPT_DIR": ck,
             "TPU_CKPT_EVERY": half, "TPU_CKPT_FINAL": 1}
    a = make_world(SIDE, os.path.join(tmp, "pdef_a"), "cuda", ev, extra)
    a.run(max_updates=updates)
    d_b = os.path.join(tmp, "pdef_b")
    shutil.copytree(a.data_dir, d_b)
    ck_b = os.path.join(tmp, "pdef_ck_b")
    shutil.copytree(ck, ck_b)
    b = make_world(SIDE, d_b, "cuda", ev, dict(extra, TPU_CKPT_DIR=ck_b))
    at = b.resume(at_update=half)
    cycles.reset_launches()
    b.run(max_updates=updates)
    _sync("cuda")
    launches = cycles.LAUNCHES
    bad = state_diff(a, b)
    da, db = dat_bodies(a.data_dir), dat_bodies(d_b)
    bad += [f for f in da if da[f] != db.get(f)]
    sysa, sysb = (open(os.path.join(c, ckpt_mod.generation_name(updates),
                                    "systematics.json"), "rb").read()
                  for c in (ck, ck_b))
    if sysa != sysb:
        bad.append("systematics.json")
    res = {"phase": "persist_default", "nvidia_smi": smi,
           "world": f"{SIDE}x{SIDE}", "engine_report": b.engine_report(),
           "updates": b.update, "resumed_at": at,
           "kernel_launches_after_resume": launches,
           "genotypes": b.systematics.num_genotypes,
           "dominant_rows": len(db.get("dominant.dat", [])),
           "systematics_json_bytes": len(sysb), "differs": bad}
    if bad or launches != updates - half or "dominant.dat" not in db:
        raise AssertionError(f"persist_default check failed: {res}")
    return res


def phase_preempt_cli(tmp, smi, persist_gen):
    """`python -m avida_tpu_torch` on persist_path's world as a child
    process, SIGTERM once its first auto-save (update 12) is on disk: it
    must exit 0 with a generation at the update it stopped at (its chunks
    of 2 updates and saves every 11 put that where persist_path never
    chunked);
    `--resume`
    to the end with TPU_CKPT_FINAL=1 must publish a final generation
    whose arrays are byte for byte persist_path's at the same update."""
    import signal
    from avida_tpu_torch.utils import checkpoint as ckpt_mod
    cdir = os.path.join(tmp, "persist_cfg")
    ck = os.path.join(tmp, "cli_ck")
    base = [sys.executable, "-m", "avida_tpu_torch", "-c", cdir,
            "-s", "11", "-d", os.path.join(tmp, "cli_d"),
            "-set", "WORLD_X", str(SIDE), "-set", "WORLD_Y", str(SIDE),
            "-set", "TPU_SYSTEMATICS", "0", "-set", "TPU_CKPT_DIR", ck,
            "-set", "TPU_CKPT_KEEP", "8", "-set", "TPU_STATE_DIGEST", "1"]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    # chunks of 2 updates (TPU_MAX_STRETCH 3) and the first save at 12:
    # the stop lands at 12, 14 or 16, where persist_path (chunks of 8 and
    # 2) has no boundary, however late after the save the signal is seen
    proc = subprocess.Popen(base + ["-u", "400", "-set", "TPU_CKPT_EVERY",
                                    "11", "-set", "TPU_MAX_STRETCH", "3"],
                            cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        while not ckpt_mod.list_generations(ck):
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError(
                    f"preempt_cli: no generation before the signal: "
                    f"{proc.stderr.read().decode()[-2000:]}")
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stop_rc = proc.returncode
    rep = json.loads(out.decode().strip().splitlines()[-1])
    stopped = rep["updates"]
    gens = [ckpt_mod.generation_update(g)
            for g in ckpt_mod.list_generations(ck)]
    t1 = time.perf_counter()
    res2 = subprocess.run(base + ["-u", str(PERSIST_UPDATES), "--resume",
                                  "-set", "TPU_CKPT_FINAL", "1"],
                          cwd=root, capture_output=True, timeout=600)
    resume_s = time.perf_counter() - t1
    final = os.path.join(ck, ckpt_mod.generation_name(PERSIST_UPDATES))
    bad = (generation_arrays_equal(persist_gen, final)
           if os.path.isdir(final) else ["no final generation"])
    res = {"phase": "preempt_cli", "nvidia_smi": smi,
           "world": f"{SIDE}x{SIDE}", "stop_exit_code": stop_rc,
           "preempted": rep.get("preempted"), "stopped_at": stopped,
           "generations_after_stop": gens,
           "resume_exit_code": res2.returncode, "resume_wall_s": resume_s,
           "final_equals_persist_path": not bad, "differs": bad}
    if stop_rc != 0 or not rep.get("preempted") or stopped not in gens \
            or stopped % 10 in (0, 8) or res2.returncode != 0 or bad:
        res["stderr"] = (err.decode()[-1500:], res2.stderr.decode()[-1500:])
        raise AssertionError(f"preempt_cli check failed: {res}")
    return res


def phase_scrub_path(tmp, smi, updates=10):
    """TPU_SCRUB_EVERY=1 on the headline world: every chunk is replayed
    from its retained pre-chunk state by the same kernel and the digests
    must agree (the kernel is deterministic: same planes, same bits)."""
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.utils import integrity
    ev = ["u begin InjectAll"] + [f"u 0:5:end {a}" for a in PRINTS[:4]]
    w = make_world(SIDE, os.path.join(tmp, "scrub"), "cuda", ev,
                   {"TPU_SCRUB_EVERY": 1})
    n0 = integrity.counters()
    cycles.reset_launches()
    _sync("cuda")
    t0 = time.perf_counter()
    w.run(max_updates=updates)
    _sync("cuda")
    wall = time.perf_counter() - t0
    launches = cycles.LAUNCHES
    n1 = integrity.counters()
    with open(os.path.join(w.data_dir, integrity.INTEGRITY_LOG)) as f:
        recs = [json.loads(ln) for ln in f]
    scrubs = [r for r in recs if r["event"] == "scrub"]
    res = {"phase": "scrub_path", "nvidia_smi": smi,
           "world": f"{SIDE}x{SIDE}", "updates": w.update,
           "scrubs": n1["scrubs"] - n0["scrubs"],
           "mismatches": n1["mismatches"] - n0["mismatches"],
           "kernel_launches": launches,
           "last_verified_update": w._last_verified_update,
           "digest_ms": n1["digest_ms"] - n0["digest_ms"],
           "ms_per_update_with_scrub": 1e3 * wall / updates,
           "chunks": [r["chunk_updates"] for r in scrubs]}
    ok = (all(r["ok"] for r in scrubs) and res["mismatches"] == 0
          and res["scrubs"] == len(scrubs) > 0
          and sum(res["chunks"]) == updates
          and w._last_verified_update == updates
          and launches == 2 * updates)
    if not ok:
        raise AssertionError(f"scrub_path check failed: {res}")
    return res, launches


SPOP_AT = 12


def spop_save(tmp, side=MW_SIDE, updates=SPOP_AT):
    """A side x side world on the card saving its population with
    SavePopulation at `updates`: the .spop file's path."""
    d = os.path.join(tmp, "spop")
    w = make_world(side, d, "cuda", ["u begin InjectAll",
                                     f"u {updates} SavePopulation"],
                   {"AVE_TIME_SLICE": 100})
    w.run(max_updates=updates + 1)
    return os.path.join(d, f"detail-{updates}.spop")


def spop_load(path, tmp, dev, side=MW_SIDE):
    """LoadPopulation of `path` into a fresh side x side world on dev (each
    organism fast-forwarded its gestation offset with micro-steps): the
    state's arrays, the load's ms and the organisms loaded."""
    from avida_tpu_torch import convert
    x = make_world(side, os.path.join(tmp, f"spop_{dev}"), dev, [],
                   {"AVE_TIME_SLICE": 100})
    x.inject()
    _sync(dev)
    t0 = time.perf_counter()
    x._action_LoadPopulation([path])
    _sync(dev)
    return (convert.state_to_arrays(x.state),
            1e3 * (time.perf_counter() - t0), x.num_organisms)


def phase_spop_path(tmp, smi, path, cpu=None, side=MW_SIDE):
    """SavePopulation / LoadPopulation on a 60x60 world: the population
    spop_save saved on the card, reloaded on the card and on the CPU:
    equal.  `cpu` is the cpu_jobs job of spop_load's CPU half, else it
    runs here."""
    a, card_ms, organisms = spop_load(path, tmp, "cuda", side)
    b, cpu_ms, _ = cpu_half(cpu, spop_load, path, cpu_root(tmp), "cpu", side)
    bad = [k for k, v in a.items() if v is not None
           and v.tobytes() != b[k].tobytes()]
    with open(path) as f:
        genotypes = sum(1 for ln in f if ln.strip() and ln[0] != "#")
    res = {"phase": "spop_path", "nvidia_smi": smi, "world": f"{side}x{side}",
           "saved_at": SPOP_AT, "genotypes": genotypes,
           "organisms": organisms, "load_ms_cuda": card_ms,
           "load_ms_cpu": cpu_ms, "differs": bad}
    if bad or organisms == 0 or genotypes < 2:
        raise AssertionError(f"spop_path check failed: {res}")
    return res


def phase_multiworld_persist(tmp, smi, mw_a, ck_root):
    """The 16 x 60x60 batch of multiworld_path (systematics on), which
    saved per-world generations every MW_UPDATES/2 updates: a new batch
    resumes them at the midpoint and runs to MW_UPDATES; every member
    equals the uninterrupted batch's, with one stacked launch (K3b) per
    resumed update."""
    import shutil

    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    half = MW_UPDATES // 2
    d = os.path.join(tmp, "mwp")
    members = mw_members(MW_SIDE, MW_SEEDS, d, "m", "cuda", 1,
                         MW_CKPT_PRINTS,
                         ckpt_root=os.path.join(tmp, "mwp_ck"))
    shutil.copytree(ck_root, os.path.join(tmp, "mwp_ck"))
    for w, src in zip(members, mw_a.worlds):
        shutil.copytree(src.data_dir, w.data_dir, dirs_exist_ok=True)
    mw = MultiWorld(members)
    at = mw.resume(at_update=half)
    cycles.reset_launches()
    _sync("cuda")
    t0 = time.perf_counter()
    mw.run(max_updates=MW_UPDATES)
    _sync("cuda")
    wall = time.perf_counter() - t0
    launches, stacked = cycles.LAUNCHES, cycles.STACKED_LAUNCHES
    bad = []
    for k, (x, y) in enumerate(zip(mw_a.worlds, mw.worlds)):
        diff = state_diff(x, y)
        if dat_bodies(x.data_dir) != dat_bodies(y.data_dir):
            diff.append(".dat files")
        if diff:
            bad.append((k, diff))
    res = {"phase": "multiworld_persist", "nvidia_smi": smi,
           "worlds": len(MW_SEEDS), "world": f"{MW_SIDE}x{MW_SIDE}",
           "resumed_at": at, "updates": mw.update,
           "stacked_launches_after_resume": stacked,
           "kernel_launches_after_resume": launches,
           "ms_per_update": 1e3 * wall / (MW_UPDATES - half),
           "members_equal": len(MW_SEEDS) - len(bad), "differs": bad}
    if bad or at != half or stacked != MW_UPDATES - half:
        raise AssertionError(f"multiworld_persist check failed: {res}")
    return res, stacked


# ---- resource pools and demes (ROADMAP items 12a and 12b) ----

# logic-9 with seven reactions on their own global pools, XOR on a
# diffusing torus pool (xdiffuse = ydiffuse = 1.0: two stencil sub-steps)
# fed by AND's by-product, EQU on a moving gradient pool; stock values,
# requisite max_count=1, the stock resource rates (inflow 100, outflow
# 0.01, frac 0.0025, max 25)
RES_GLOBAL = ("not", "nand", "and", "orn", "or", "andn", "nor")
RES_VALUES = dict(zip(RES_GLOBAL + ("xor", "equ"), (1, 1, 2, 2, 3, 3, 4, 4,
                                                    5)))
RESOURCE_ENV_TEXT = "".join(
    f"RESOURCE r_{t}:inflow=100:outflow=0.01:initial=1000\n"
    for t in RES_GLOBAL) + (
    "RESOURCE r_xor:geometry=torus:xdiffuse=1.0:ydiffuse=1.0:inflow=100:"
    "outflow=0.01:initial=1\n"
    "GRADIENT_RESOURCE r_equ:height=8:spread=40:plateau=2:updatestep=2:"
    "move_a_scaler=2\n") + "".join(
    f"REACTION {t.upper()} {t} process:value={RES_VALUES[t]}.0:type=pow:"
    f"resource=r_{t}:frac=0.0025:max=25"
    + (":product=r_xor:conversion=0.5" if t == "and" else "")
    + " requisite:max_count=1\n" for t in RES_VALUES)
# deme pools bound to NOT and NAND (the task program's), global AND / ORN
DEME_RES_ENV_TEXT = """
RESOURCE d_food:inflow=50:outflow=0.01:initial=500:demeresource=1
RESOURCE g_and:inflow=100:outflow=0.01:initial=1000
RESOURCE g_orn:inflow=100:outflow=0.01:initial=1000
REACTION NOT  not  process:value=1.0:type=pow:resource=d_food:frac=0.0025:max=25
REACTION NAND nand process:value=1.0:type=pow:resource=d_food:frac=0.005:max=25
REACTION AND  and  process:value=2.0:type=pow:resource=g_and:frac=0.0025:max=25
REACTION ORN  orn  process:value=2.0:type=pow:resource=g_orn:frac=0.0025:max=25
"""
DEMES = dict(NUM_DEMES=16, DEMES_USE_GERMLINE=1, DEMES_MIGRATION_RATE=0.01,
             DEMES_MIGRATION_METHOD=0)
DEME_UPDATES, DEME_REPLICATE_AT = 30, 24


def pool_breakdown(w, updates):
    """Per-phase device-synchronised wall ms of update_step's phases in
    order (resources, schedule, lane permutation, the cycles on the routed
    engine, bank, flush, stats) on the world's state."""
    import torch
    from avida_tpu_torch.ops import update
    from avida_tpu_torch.utils import prng
    p, st = w.params, w.state
    acc = {k: 0.0 for k in ("resources", "schedule", "perm", "cycles",
                            "bank", "flush", "stats")}

    def timed(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc[name] += 1e3 * (time.perf_counter() - t0)
        return out

    trips = []
    for i in range(updates):
        u = w.update + i
        key = prng.fold_in(w._run_key, u)
        ks = prng.split(key, 3)
        alive_before = st.alive.sum().to(torch.int32)
        st = timed("resources", update.resource_phase, p, st, key, u)
        budgets, granted, max_k = timed("schedule", update.schedule_phase,
                                        p, st, ks[0])
        trips.append(int(max_k))
        st = timed("perm", update.perm_phase, p, st, granted, u)
        executed0 = st.insts_executed
        st = timed("cycles", update.interpret_phase, p, st, ks[1], granted,
                   update.static_cap(p), max_k)
        st, _ = timed("bank", update.bank_phase, p, st, budgets, executed0)
        st = timed("flush", update.birth_phase, p, st, ks[2], ks[1], u,
                   w.neighbors)
        timed("stats", update.update_stats, p, st, alive_before, u)
    per = {k: v / updates for k, v in acc.items()}
    return {"updates": updates, "trips": trips, "ms_per_update": per,
            "ms_per_update_total": sum(per.values())}


def _pool_levels(st):
    """Finite pool levels: (global levels, spatial totals, deme levels)."""
    import torch
    for t in (st.resources, st.res_grid, st.deme_resources):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("a resource pool is not finite")
    return (st.resources.tolist(), st.res_grid.sum(dim=1).tolist(),
            st.deme_resources.tolist())


def phase_resource_path(side, updates, tmp, smi):
    """The headline world reseeded with mixed programs (reseed_mixed),
    RESOURCE_ENV_TEXT under the default TPU_USE_PALLAS=0: the kernel gate
    refuses resource-bound reactions, so the micro-step engine runs (no
    launch); `updates` updates, resource.dat every update, then one more
    timed phase by phase."""
    import torch
    cdir = math_config_dir(os.path.join(tmp, "cfg_res"), RESOURCE_ENV_TEXT)
    ddir = os.path.join(tmp, "res")
    w = make_world(side, ddir, "cuda",
                   ["u begin InjectAll", "u 0:1:end PrintResourceData"], {},
                   cdir)
    w.process_events()
    reseed_mixed(w)
    insts, wall, launches = _xla_run(w, updates)
    glob, spatial, _ = _pool_levels(w.state)
    rows = [ln.split() for ln in dat_bodies(ddir)["resource.dat"]
            if ln.strip() and not ln.startswith("#")]
    rewarded = w.state.task_exe_total.sum(dim=0).tolist()
    res = {"phase": "resource_path", "world": f"{side}x{side}",
           "reactions": w.params.num_reactions,
           "pools": {"global": w.params.num_global_res,
                     "spatial": w.params.num_spatial_res},
           "engine_report": w.engine_report(), "updates": w.update,
           "kernel_launches": launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / updates, "wall_s": wall,
           "global_levels": glob, "spatial_totals": spatial,
           "gradient_peak": w.state.grad_peak[1].tolist(),
           "tasks_performed": rewarded, "resource_dat_rows": len(rows),
           "nvidia_smi": smi}
    _check_xla_world(w, "resource_path", res)
    if len(rows) != updates or min(glob) >= 1000.0 \
            or rewarded[0] == 0 or spatial[0] <= 0.0:
        raise AssertionError(f"resource_path: pools not drawn: {res}")
    res["breakdown"] = pool_breakdown(w, 1)
    return res


def deme_world(side, ddir, events, extra):
    return make_world(side, ddir, "cuda", events, dict(DEMES, **extra))


def phase_deme_path(side, tmp, smi):
    """The headline world in 16 demes (bands of 6,400 cells) with
    germlines and migration (rate 0.01, method 0) on the kernel route's
    per-update engine: CompeteDemes 1 at update 10 and ReplicateDemes
    births at DEME_REPLICATE_AT, one launch an update.  At update 10 no
    deme has reproduced yet (the ancestor's first gestation ends near
    update 12), so the roulette is uniform; the replaced demes restart as
    fresh clones and first reproduce near update 22.  DEMES_MAX_BIRTHS is
    the median of the per-deme birth counts at DEME_REPLICATE_AT, read
    from a first run of the same world, so that some demes trigger and
    some do not; the measured run is the second, with that value set."""
    import torch
    from avida_tpu_torch.ops import cycles
    events = ["u begin InjectAll", "u 10 CompeteDemes 1",
              f"u {DEME_REPLICATE_AT} ReplicateDemes births"]
    probe = deme_world(side, os.path.join(tmp, "deme_probe"), events, {})
    probe.run(max_updates=DEME_REPLICATE_AT)
    counts = sorted(probe.state.deme_birth_count.tolist())
    del probe
    above = [c for c in counts if c > counts[0]]
    if not above:
        raise AssertionError(f"deme_path: every deme has {counts[0]} "
                             f"births at update {DEME_REPLICATE_AT}")
    threshold = max(counts[len(counts) // 2], above[0])
    ev = events + [f"u 0:10:end {a}" for a in XLA_PRINTS]
    w = deme_world(side, os.path.join(tmp, "deme"), ev,
                   {"DEMES_MAX_BIRTHS": threshold})
    torch.cuda.synchronize()
    cycles.reset_launches()
    t0 = time.perf_counter()
    insts = w.run(max_updates=DEME_REPLICATE_AT)
    births_at = w.state.deme_birth_count.tolist()
    germ_before = w.state.germ_mem.clone()
    insts += w.run(max_updates=DEME_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cycles.LAUNCHES
    triggered = [d for d, c in enumerate(births_at) if c >= threshold]
    germ_changed = (w.state.germ_mem != germ_before).any(dim=1)
    age = w.state.deme_age.tolist()
    fired = DEME_UPDATES - DEME_REPLICATE_AT
    rep = w.engine_report()
    res = {"phase": "deme_path", "world": f"{side}x{side}",
           "demes": w.params.num_demes, "engine_report": rep,
           "updates": w.update, "kernel_launches": launches,
           "insts": insts, "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / DEME_UPDATES, "wall_s": wall,
           "births_total": int(w._total_births),
           "live_organisms": w.num_organisms,
           "demes_max_births": threshold,
           "deme_births_at_replicate": births_at,
           "demes_triggered": triggered,
           "demes_not_triggered": [d for d in range(len(births_at))
                                   if d not in triggered],
           "germlines_changed": int(germ_changed.sum()),
           "deme_age": age, "nvidia_smi": smi}
    ok = (launches == DEME_UPDATES and rep["engine"] == "per-update"
          and "demes" in rep["fallback_reason"]
          and 0 < len(triggered) < len(births_at)
          and all(age[d] == fired for d in triggered)
          and all(a in (fired, DEME_UPDATES - 10) for a in age)
          and w.num_organisms > 0
          and bool(torch.isfinite(w.state.merit).all()))
    if not ok:
        raise AssertionError(f"deme_path check failed: {res}")
    res["breakdown"] = pool_breakdown(w, 1)
    return w, res


def phase_deme_resource_path(side, updates, tmp, smi):
    """The headline world in 16 demes whose NOT and NAND rewards draw on
    per-deme pools (DEME_RES_ENV_TEXT), reseeded with mixed programs, on
    the micro-step engine (no launch); a
    Pred_DemeResourceThresholdPredicate and ReplicateDemes
    sat-deme-predicate after the first update."""
    import torch
    cdir = math_config_dir(os.path.join(tmp, "cfg_deme_res"),
                           DEME_RES_ENV_TEXT)
    w = make_world(side, os.path.join(tmp, "deme_res"), "cuda",
                   ["u begin InjectAll",
                    "u begin Pred_DemeResourceThresholdPredicate d_food "
                    "<= 480",
                    "u 1 ReplicateDemes sat-deme-predicate"],
                   dict(DEMES, DEMES_USE_GERMLINE=0), cdir)
    w.process_events()
    reseed_mixed(w)
    insts, wall, launches = _xla_run(w, updates)
    _, _, deme_levels = _pool_levels(w.state)
    levels = [x[0] for x in deme_levels]
    res = {"phase": "deme_resource_path", "world": f"{side}x{side}",
           "demes": w.params.num_demes,
           "engine_report": w.engine_report(), "updates": w.update,
           "kernel_launches": launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / updates, "wall_s": wall,
           "deme_levels": levels,
           "deme_age": w.state.deme_age.tolist(), "nvidia_smi": smi}
    _check_xla_world(w, "deme_resource_path", res)
    if max(levels) >= 500.0:                  # every deme drew its pool
        raise AssertionError(f"deme_resource_path: deme pools: {res}")
    res["breakdown"] = pool_breakdown(w, 1)
    return res


# (name, side, updates, extra config, environment or None, mixed
# programs, events after InjectAll)
POOL_CROSS_CASES = (
    ("resources", 12, 6, {}, RESOURCE_ENV_TEXT, True,
     ["u 0:2:end PrintResourceData"]),
    ("demes_kernel", 8, 24, dict(DEMES, NUM_DEMES=4, DEMES_MAX_BIRTHS=10,
                                 DEMES_MIGRATION_RATE=0.2), None, True,
     ["u 14 CompeteDemes 2", "u 18 ReplicateDemes births",
      "u 20 ReplicateDemes all"]),
    ("deme_resources", 12, 6, dict(DEMES, NUM_DEMES=4, DEMES_USE_GERMLINE=0,
                                   DEMES_MIGRATION_RATE=0.1),
     DEME_RES_ENV_TEXT, True,
     ["u begin Pred_DemeResourceThresholdPredicate d_food <= 480",
      "u 3 ReplicateDemes sat-deme-predicate", "u 4 CompeteDemes 2"]),
)
# the micro-step cases run 6 updates (each update is ~80 cycles of about
# 14 ms on the CPU and 20 ms on the card), too few for the ancestor's
# first birth: they are held to rewards and pool levels instead; births,
# migration and the deme flush are the kernel-route case's


def pool_cross_side(tmp, dev):
    """One device's half of resources_cross_device: for each case, the
    state arrays, the .dat bodies and the engine."""
    from avida_tpu_torch import convert
    out = []
    for name, side, updates, extra, env, mixed, events in POOL_CROSS_CASES:
        cdir = (math_config_dir(os.path.join(tmp, f"cfg_pc_{name}"), env)
                if env else None)
        ddir = os.path.join(tmp, f"pc_{name}_{dev}")
        w = make_world(side, ddir, dev, ["u begin InjectAll"] + events,
                       extra, cdir)
        w.process_events()
        if mixed:
            reseed_mixed(w)
        w.run(max_updates=updates)
        _sync(dev)
        out.append((convert.state_to_arrays(w.state),
                    dat_bodies(ddir) if os.path.isdir(ddir) else {},
                    w.engine_report()["engine"]))
    return out


def phase_resources_cross_device(tmp, cpu=None, device="cuda"):
    """Small worlds of the new paths run on the card and on the CPU (the
    plain versions) must end identical: a resource world on the
    micro-step engine (resource.dat included), a 4-deme world with
    germlines, migration, CompeteDemes and ReplicateDemes on the kernel
    route, a deme-pool world with a predicate-triggered replication.
    `cpu` is the cpu_jobs job of pool_cross_side's CPU half, else it runs
    here."""
    card = pool_cross_side(tmp, device)
    host = cpu_half(cpu, pool_cross_side, cpu_root(tmp), "cpu")
    results = []
    for case, (sa, da, _), (sb, db, eb) in zip(POOL_CROSS_CASES, card, host):
        name, side, updates, _, env, _, _ = case
        bad = [k for k in sa if sa[k] is not None
               and sa[k].tobytes() != sb[k].tobytes()]
        if da != db:
            bad.append(".dat files")
        births = int((sb["birth_update"] >= 0).sum())
        rewards = int(sb["task_exe_total"].sum())
        if bad or rewards == 0 or (env is None and births == 0):
            raise AssertionError(f"resources_cross_device {name}: cuda vs "
                                 f"cpu differ in {bad} (births {births}, "
                                 f"rewards {rewards})")
        results.append({"case": name, "world": f"{side}x{side}",
                        "updates": updates, "births": births,
                        "rewards": rewards, "engine": eb,
                        "dat_files_equal": sorted(da)})
    return {"phase": "resources_cross_device", "fields_equal": True,
            "cases": results}


# ---- slice 10: the rest of the birth flush and the topologies on the
# kernel route (ROADMAP items 12d, 12g), mating types, energy and threads
# on the micro-step engine (12e, 12f) ----

DISPERSAL = dict(BIRTH_METHOD=11, DISPERSAL_RATE=1.0, POPULATION_CAP=80000)
DISPERSAL_UPDATES = 30
DISPERSAL_EVENTS = ["u begin InjectAll", "u 10 KillProb 0.1",
                    "u 20 SerialTransfer 20000"]
HEX_UPDATES = 20
# (name, side, geometry, updates) of topology_path's small worlds
SMALL_TOPOLOGIES = (("random_connected", 60, 7, 16),
                    ("scale_free", 60, 8, 16), ("clique", 16, 3, 16))
MATING_NAMES = ("set-mating-type-male", "set-mating-type-female",
                "set-mating-type-juvenile", "if-mating-type-male",
                "if-mating-type-female")
THREAD_NAMES = ("fork-th", "kill-th", "id-th")
ENERGY = dict(ENERGY_ENABLED=1, ENERGY_GIVEN_ON_INJECT=1000.0,
              BIRTH_METHOD=10)
THREADS = dict(MAX_CPU_THREADS=4, THREAD_SLICING_METHOD=1)
THREAD_UPDATES = 2
UNTIL_CAP = 40          # the most updates run waiting for births


def instset_text(names, hw_type=0):
    """An instruction-set file of hardware `hw_type` (heads by default)
    listing `names`."""
    return f"INSTSET case:hw_type={hw_type}\n" + "".join(
        f"INST {n}\n" for n in names)


def feature_config_dir(cdir, names):
    return write_config_dir(cdir, instset=instset_text(names))


def with_inserted(genome, at, ops, drop_from):
    """`genome` with `ops` inserted at `at` and as many filler nops
    dropped from `drop_from` on (the length stays)."""
    g = list(genome)
    g[at:at] = ops
    del g[drop_from:drop_from + len(ops)]
    return g


def mating_ancestors(names):
    """The sexual ancestor set to male and to female: set-mating-type-*
    right after h-alloc, one filler nop dropped.  (The first filler nop
    itself never runs: the first h-search jumps over the filler.)"""
    from avida_tpu_torch.config import heads_sex_instset
    from avida_tpu_torch.world import default_ancestor
    anc = default_ancestor(heads_sex_instset())
    return [with_inserted(anc, 1, [names.index(f"set-mating-type-{t}")], 6)
            for t in ("male", "female")]


def thread_ancestor(names):
    """The stock ancestor with fork-th and id-th right after h-alloc, two
    filler nops dropped: the primary thread forks once a gestation and
    skips id-th; the new thread runs id-th and the same copy loop one
    cycle behind, until the primary divides and the organism resets to
    one thread."""
    from avida_tpu_torch.config import default_instset
    from avida_tpu_torch.world import default_ancestor
    anc = default_ancestor(default_instset())
    return with_inserted(anc, 1, [names.index("fork-th"),
                                  names.index("id-th")], 7)


def reseed_alternating(w, genomes):
    """Every cell c of a freshly InjectAll-ed world reseeded with
    genomes[c % len(genomes)] in one pass (genome, tape, lengths, sizes,
    merit and age limit; every other field is already fresh)."""
    import numpy as np
    import torch
    from avida_tpu_torch.core.state import _max_executed
    n, L = w.params.num_cells, w.params.max_memory
    genome = np.zeros((n, L), np.int8)
    glen = np.zeros(n, np.int32)
    for c, g in enumerate(genomes):
        genome[c::len(genomes), :len(g)] = g
        glen[c::len(genomes)] = len(g)
    st, dev = w.state, w.state.device
    g = torch.from_numpy(genome).to(dev)
    gl = torch.from_numpy(glen).to(dev)
    max_exec = torch.tensor([_max_executed(w.params, int(x)) for x in glen],
                            dtype=torch.int32, device=dev)
    w.state = st.replace(genome=g, tape=g.to(torch.uint8) & 0x3F,
                         genome_len=gl, mem_len=gl.clone(),
                         executed_size=gl.clone(), copied_size=gl.clone(),
                         merit=gl.to(torch.float32), max_executed=max_exec)


def give_inject_energy(w):
    """Every cell's energy set as Inject sets it (ENERGY_GIVEN_ON_INJECT;
    InjectAll's blanket reseed gives none, in the reference too)."""
    import torch
    w.state = w.state.replace(energy=torch.full_like(
        w.state.energy, float(w.params.energy_given_on_inject)))


def watch_actions(w, actions):
    """Wrap the world's `actions` so each firing records the update and
    the organisms alive before and after it."""
    marks = []
    for act in actions:
        orig = getattr(w, f"_action_{act}")

        def wrapped(args, orig=orig, act=act):
            before = int(w.state.alive.sum())
            orig(args)
            marks.append({"action": act, "update": w.update,
                          "args": list(args), "alive_before": before,
                          "alive_after": int(w.state.alive.sum())})
        setattr(w, f"_action_{act}", wrapped)
    return marks


def timed_world(make):
    """make() with the neighbor table's build timed: (world, seconds
    spent in birth.neighbor_table, 0.0 for a cached table)."""
    from avida_tpu_torch.ops import birth
    orig, spent = birth.neighbor_table, []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        spent.append(time.perf_counter() - t0)
        return out
    birth.neighbor_table = timed
    try:
        w = make()
    finally:
        birth.neighbor_table = orig
    return w, sum(spent)


def run_counted(w, updates, per_update=None):
    """World.run one update at a time to `updates`, on the card with the
    cycle kernel's launches counted: (instructions, wall s, launches,
    [per_update(w) after each update])."""
    import torch
    from avida_tpu_torch.ops import cycles
    torch.cuda.synchronize()
    cycles.reset_launches()
    insts, wall, rows = 0, 0.0, []
    for u in range(w.update + 1, updates + 1):
        t0 = time.perf_counter()
        insts += w.run(max_updates=u)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        if per_update is not None:
            rows.append(per_update(w))
    return insts, wall, cycles.LAUNCHES, rows


def run_until_births(w, name):
    """World.run one update at a time until the first births land (at
    most UNTIL_CAP updates): (instructions, wall s, launches)."""
    import torch
    from avida_tpu_torch.ops import cycles
    torch.cuda.synchronize()
    cycles.reset_launches()
    insts, wall = 0, 0.0
    while int(w._total_births) == 0:
        if w.update >= UNTIL_CAP:
            raise AssertionError(f"{name}: no birth in {UNTIL_CAP} updates")
        t0 = time.perf_counter()
        insts += w.run(max_updates=w.update + 1)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    return insts, wall, cycles.LAUNCHES


def update_breakdown(w, updates=1):
    """Per-phase wall ms of one update on the world's state and its own
    neighbor table: pool_breakdown on the kernel route, xla_breakdown on
    the micro-step engine."""
    from avida_tpu_torch.ops import cycles
    if cycles.use_kernel(w.params):
        return pool_breakdown(w, updates)
    return xla_breakdown(w, updates)


def dispersal_trips(w):
    """The Poisson sampler's trip count in the next update's flush (the
    flush's own key derivation, outside the run)."""
    from avida_tpu_torch.utils import prng
    k_birth = prng.split(prng.fold_in(w._run_key, w.update), 3)[2]
    k11 = prng.fold_in(prng.split(k_birth, 4)[0], 11)
    rate = w.params.dispersal_rate
    draw = (prng._poisson_knuth if prng.round_f32(rate) < 10
            else prng._poisson_rejection)
    return draw(prng.fold_in(k11, 0), rate, (w.params.num_cells,))[1]


def phase_dispersal_path(side, tmp, smi):
    """The headline world with BIRTH_METHOD 11 (DISPERSAL_RATE 1.0) and
    POPULATION_CAP 80,000 on the kernel route's per-update engine: the
    InjectAll soup is cut to the cap at the first flush, KillProb 0.1 at
    update 10 and SerialTransfer 20000 at update 20 fire through events;
    one launch an update.  K1 is then held against the plain version on
    the phase's own state (phase_default_kernel)."""
    import torch
    w = make_world(side, os.path.join(tmp, "dispersal"), "cuda",
                   DISPERSAL_EVENTS + [f"u 0:10:end {a}"
                                       for a in XLA_PRINTS], DISPERSAL)
    marks = watch_actions(w, ("KillProb", "SerialTransfer"))
    n = w.params.num_cells
    insts, wall, launches, rows = run_counted(
        w, DISPERSAL_UPDATES,
        lambda w: (int(w.state.alive.sum()), int(w._total_births)))
    alive = [r[0] for r in rows]
    rep = w.engine_report()
    trips = dispersal_trips(w)
    res = {"phase": "dispersal_path", "world": f"{side}x{side}",
           "config": DISPERSAL, "engine_report": rep, "updates": w.update,
           "kernel_launches": launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / DISPERSAL_UPDATES, "wall_s": wall,
           "cap_kills_first_flush": n - alive[0],
           "births_first_update": rows[0][1],
           "alive_per_update": alive, "events": marks,
           "births_total": int(w._total_births),
           "poisson_trips_next_flush": trips,
           "breakdown": update_breakdown(w), "nvidia_smi": smi}
    kp = [m for m in marks if m["action"] == "KillProb"]
    stx = [m for m in marks if m["action"] == "SerialTransfer"]
    ok = (launches == DISPERSAL_UPDATES and rep["engine"] == "per-update"
          and "off the torus fast path" in rep["fallback_reason"]
          and rows[0][1] == 0 and alive[0] == DISPERSAL["POPULATION_CAP"]
          and max(alive) <= DISPERSAL["POPULATION_CAP"]
          and len(kp) == 1 and kp[0]["update"] == 10
          and 0 < kp[0]["alive_after"] < kp[0]["alive_before"]
          and len(stx) == 1 and stx[0]["alive_after"]
          == min(int(stx[0]["args"][0]), stx[0]["alive_before"])
          and res["births_total"] > 0 and w.num_organisms > 0
          and bool(torch.isfinite(w.state.merit).all()))
    if not ok:
        raise AssertionError(f"dispersal_path check failed: {res}")
    return w, res


def phase_topology_path(side, tmp, smi):
    """Placement through other graphs on the kernel route's per-update
    engine: a hex world (WORLD_GEOMETRY 4) at the headline width for
    HEX_UPDATES updates, one launch each, then random connected (7) and
    scale-free (8) worlds at 60x60 and a clique (3) at 16x16 (the
    reference's builders are quadratic in the cells), each table's width
    and build seconds reported.  The hex world's K1 is then held against
    the plain version (phase_default_kernel)."""
    import torch
    events = ["u begin InjectAll"]
    w, build_s = timed_world(lambda: make_world(
        side, os.path.join(tmp, "hex"), "cuda",
        events + [f"u 0:10:end {a}" for a in XLA_PRINTS],
        {"WORLD_GEOMETRY": 4}))
    insts, wall, launches, _ = run_counted(w, HEX_UPDATES)
    rep = w.engine_report()
    res = {"phase": "topology_path", "world": f"{side}x{side}",
           "geometry": 4, "engine_report": rep, "updates": w.update,
           "kernel_launches": launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / HEX_UPDATES, "wall_s": wall,
           "table_width": int(w.neighbors.shape[1]),
           "table_build_s": build_s,
           "births_total": int(w._total_births),
           "breakdown": update_breakdown(w), "nvidia_smi": smi}
    ok = (launches == HEX_UPDATES and rep["engine"] == "per-update"
          and "off the torus fast path" in rep["fallback_reason"]
          and res["table_width"] == 8 and w.num_organisms > 0
          and bool(torch.isfinite(w.state.merit).all()))
    small, total = [], launches
    for name, s, geo, ups in SMALL_TOPOLOGIES:
        ws, bs = timed_world(lambda: make_world(
            s, os.path.join(tmp, f"topo_{name}"), "cuda", events,
            {"WORLD_GEOMETRY": geo}))
        i2, wall2, l2, _ = run_counted(ws, ups)
        total += l2
        deg = (ws.neighbors >= 0).sum(dim=1)
        small.append({"case": name, "world": f"{s}x{s}", "geometry": geo,
                      "updates": ups, "kernel_launches": l2,
                      "table_width": int(ws.neighbors.shape[1]),
                      "degree_min": int(deg.min()),
                      "degree_mean": float(deg.float().mean()),
                      "table_build_s": bs, "ms_per_update": 1e3 * wall2 / ups,
                      "births_total": int(ws._total_births),
                      "live_organisms": ws.num_organisms})
        ok = ok and l2 == ups and ws._total_births > 0 \
            and ws.engine_report()["engine"] == "per-update"
        del ws
    res["small_worlds"] = small
    res["kernel_launches_total"] = total
    if not ok:
        raise AssertionError(f"topology_path check failed: {res}")
    return w, res


def mating_world(side, ddir, device, tmp, tag, extra=None):
    """A MATING_TYPES world of the heads-sex set plus the five mating
    instructions, male ancestors in even cells and female ones in odd
    cells."""
    from avida_tpu_torch.config import heads_sex_instset
    names = list(heads_sex_instset().inst_names) + list(MATING_NAMES)
    cdir = feature_config_dir(os.path.join(tmp, f"cfg_mating_{tag}"), names)
    w = make_world(side, ddir, device, ["u begin InjectAll"],
                   dict({"MATING_TYPES": 1}, **(extra or {})), cdir)
    w.process_events()
    reseed_alternating(w, mating_ancestors(names))
    return w


def watch_pairing(acc):
    """Wrap birth.recombine_sexual: each flush adds its sexual offspring
    by parent type, its pairings (placeable rows) and its juvenile drops
    to `acc`, as device tensors.  Returns the restore function."""
    from avida_tpu_torch.ops import birth
    orig = birth.recombine_sexual

    def wrapped(params, st, key, off_mem, off_len, pending):
        out = orig(params, st, key, off_mem, off_len, pending)
        sexp = pending & st.off_sex
        for k, v in (("juvenile_drops", sexp & (st.mating_type == -1)),
                     ("male_offspring", sexp & (st.mating_type == 1)),
                     ("female_offspring", sexp & (st.mating_type == 0)),
                     ("paired", sexp & out[3])):
            acc[k] = acc.get(k, 0) + v.sum()
        return out
    birth.recombine_sexual = wrapped

    def restore():
        birth.recombine_sexual = orig
    return restore


def phase_mating_path(side, tmp, smi):
    """The headline world with MATING_TYPES 1 on the micro-step engine (no
    launch): the heads-sex set plus the five mating instructions, male
    ancestors in even cells and female ones in odd cells.  World.run
    until the first pairings are born, then one update timed phase by
    phase and run; pairings, juvenile drops and the birth chamber's
    store reported."""
    import torch
    w = mating_world(side, os.path.join(tmp, "mating"), "cuda", tmp, "path")
    acc = {}
    restore = watch_pairing(acc)
    try:
        insts, wall, launches = run_until_births(w, "mating_path")
        breakdown = update_breakdown(w)
        t_insts, t_wall, t_launches, _ = run_counted(w, w.update + 1)
    finally:
        restore()
    mt = w.state.mating_type
    res = {"phase": "mating_path", "world": f"{side}x{side}",
           "engine_report": w.engine_report(), "updates": w.update,
           "kernel_launches": launches + t_launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / max(w.update - 1, 1),
           "wall_s": wall,
           "timed_update": {"update": w.update, "insts": t_insts,
                            "ms": 1e3 * t_wall,
                            "org_inst_per_s": t_insts / t_wall},
           "breakdown": breakdown,
           **{k: int(v) for k, v in acc.items()},
           "store": {"valid": bool(w.state.bc_valid),
                     "type": int(w.state.bc_type)},
           "males": int((w.state.alive & (mt == 1)).sum()),
           "females": int((w.state.alive & (mt == 0)).sum()),
           "juveniles": int((w.state.alive & (mt == -1)).sum()),
           "births_total": int(w._total_births), "nvidia_smi": smi}
    _check_xla_world(w, "mating_path", res)
    if res.get("paired", 0) == 0 or res["males"] == 0 or res["females"] == 0:
        raise AssertionError(f"mating_path: no pairing: {res}")
    return res


def phase_energy_path(side, tmp, smi):
    """The headline world with the energy model (ENERGY_ENABLED 1,
    ENERGY_GIVEN_ON_INJECT 1000, BIRTH_METHOD 10: the reference's
    tests/test_energy.py world) on the micro-step engine, every cell
    given its inject energy: World.run until the first births, then one
    update timed phase by phase and run.  Every newborn's merit is its
    energy's (x 100 / NUM_CYCLES_EXC_BEFORE_0_ENERGY)."""
    import torch
    from avida_tpu_torch.ops.interpreter import convert_energy_to_merit
    w = make_world(side, os.path.join(tmp, "energy"), "cuda",
                   ["u begin InjectAll"], ENERGY)
    w.process_events()
    give_inject_energy(w)
    e0 = float(w.state.energy.sum())
    insts, wall, launches = run_until_births(w, "energy_path")
    breakdown = update_breakdown(w)
    t_insts, t_wall, t_launches, _ = run_counted(w, w.update + 1)
    st = w.state
    born = st.alive & (st.birth_update >= 0)
    merit_ok = bool((st.merit[born] == convert_energy_to_merit(
        w.params, st.energy[born])).all())
    e = st.energy[st.alive]
    res = {"phase": "energy_path", "world": f"{side}x{side}",
           "engine_report": w.engine_report(), "updates": w.update,
           "kernel_launches": launches + t_launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / max(w.update - 1, 1),
           "wall_s": wall,
           "timed_update": {"update": w.update, "insts": t_insts,
                            "ms": 1e3 * t_wall,
                            "org_inst_per_s": t_insts / t_wall},
           "breakdown": breakdown, "births_total": int(w._total_births),
           "newborns_alive": int(born.sum()), "energy_start": e0,
           "energy_alive": float(e.sum()), "energy_min": float(e.min()),
           "energy_max": float(e.max()), "newborn_merit_from_energy":
           merit_ok, "nvidia_smi": smi}
    _check_xla_world(w, "energy_path", res)
    if not merit_ok or res["newborns_alive"] == 0 or res["energy_min"] <= 0:
        raise AssertionError(f"energy_path check failed: {res}")
    return res


def thread_world(side, ddir, device, tmp, tag, extra=None):
    """A MAX_CPU_THREADS world (THREADS) of the stock heads set plus
    fork-th, kill-th and id-th, every cell seeded with the forking
    ancestor."""
    from avida_tpu_torch.config import default_instset
    names = list(default_instset().inst_names) + list(THREAD_NAMES)
    cdir = feature_config_dir(os.path.join(tmp, f"cfg_thr_{tag}"), names)
    w = make_world(side, ddir, device, ["u begin InjectAll"],
                   dict(THREADS, **(extra or {})), cdir)
    w.process_events()
    reseed_alternating(w, [thread_ancestor(names)])
    return w


def phase_threads_path(side, tmp, smi):
    """The headline world with MAX_CPU_THREADS 4 and THREAD_SLICING_METHOD
    1 on the micro-step engine (no launch), every cell seeded with the
    forking ancestor: THREAD_UPDATES updates, then one timed phase by
    phase and run; live threads an organism reported."""
    import torch
    w = thread_world(side, os.path.join(tmp, "threads"), "cuda", tmp, "path")

    def threads(w):
        st = w.state
        live = (1 + st.t_alive.sum(dim=1))[st.alive]
        return float(live.float().mean()), int(live.max())
    insts, wall, launches, rows = run_counted(w, THREAD_UPDATES, threads)
    breakdown = update_breakdown(w)
    t_insts, t_wall, t_launches, t_rows = run_counted(
        w, THREAD_UPDATES + 1, threads)
    res = {"phase": "threads_path", "world": f"{side}x{side}",
           "config": THREADS, "engine_report": w.engine_report(),
           "updates": w.update, "kernel_launches": launches + t_launches,
           "insts": insts, "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / THREAD_UPDATES, "wall_s": wall,
           "timed_update": {"update": w.update, "insts": t_insts,
                            "ms": 1e3 * t_wall,
                            "org_inst_per_s": t_insts / t_wall},
           "breakdown": breakdown,
           "threads_per_organism": [r[0] for r in rows + t_rows],
           "threads_max": max(r[1] for r in rows + t_rows),
           "nvidia_smi": smi}
    _check_xla_world(w, "threads_path", res,
                     reason="non-heads hardware or multi-threaded")
    if res["threads_max"] < 2 or min(res["threads_per_organism"]) <= 1.0:
        raise AssertionError(f"threads_path: no forks: {res}")
    return res


# (name, side, extra config, events, builder) of slice10_cross_device;
# the builder is make_world after InjectAll (None), mating_world or
# thread_world; "energy" gives every cell its inject energy
SLICE10_CROSS = (
    ("clique", 12, dict(WORLD_GEOMETRY=3), (), None),
    ("hex", 12, dict(WORLD_GEOMETRY=4), (), None),
    ("random_connected", 12, dict(WORLD_GEOMETRY=7), (), None),
    ("scale_free", 12, dict(WORLD_GEOMETRY=8), (), None),
    ("dispersal", 12, dict(DISPERSAL, POPULATION_CAP=110),
     ("u 12 KillProb 0.1", "u 13 SerialTransfer 70"), None),
    ("dispersal_rejection", 12, dict(BIRTH_METHOD=11, DISPERSAL_RATE=12.0,
                                     POP_CAP_ELDEST=120), (), None),
    ("mating", 12, {}, (), "mating"),
    ("energy", 12, ENERGY, (), "energy"),
    ("threads", 12, dict(MAX_CPU_THREADS=2, THREAD_SLICING_METHOD=1), (),
     "threads"),
)
# the CPU runs SLICE10_WARM updates alone (the ancestors' first births
# land from update 11 at the default time slices of 30), then the card
# and the CPU run SLICE10_COMPARED more from the CPU's state, compared
# after each (short slices keep the CPU's plain versions cheap)
SLICE10_WARM, SLICE10_COMPARED = 11, 3


def slice10_world(name, side, extra, events, kind, ddir, device, tmp, tag):
    if kind == "mating":
        return mating_world(side, ddir, device, tmp, tag, extra)
    if kind == "threads":
        return thread_world(side, ddir, device, tmp, tag, extra)
    w = make_world(side, ddir, device, ["u begin InjectAll"] + list(events),
                   extra)
    w.process_events()
    if kind == "energy":
        give_inject_energy(w)
    return w


def slice10_cpu_side(tmp, k):
    """The CPU half of slice10_cross_device's case k: its world run alone
    to SLICE10_WARM updates, the state's arrays, world key and update
    then, its state arrays after each of SLICE10_COMPARED more updates,
    and the seconds of each stretch."""
    from avida_tpu_torch import convert
    name, side, extra, events, kind = SLICE10_CROSS[k]
    t0 = time.perf_counter()
    w = slice10_world(name, side, extra, events, kind,
                      os.path.join(tmp, f"s10_{name}_cpu"), "cpu", tmp,
                      f"{name}_cpu")
    w.run(max_updates=SLICE10_WARM)
    warm = (convert.state_to_arrays(w.state), w.key.cpu().numpy(), w.update)
    t1 = time.perf_counter()
    after = []
    for u in range(SLICE10_WARM + 1, SLICE10_WARM + SLICE10_COMPARED + 1):
        w.run(max_updates=u)
        after.append(convert.state_to_arrays(w.state))
    return warm, after, t1 - t0, time.perf_counter() - t1


def phase_slice10_cross_device(tmp, cpu=None, device="cuda"):
    """Small worlds of the slice's paths, run on the card and on the CPU
    (the plain versions), must be identical field by field after every
    compared update: the clique, hex, random connected and scale-free
    geometries and BIRTH_METHOD 11 (rates 1.0 and 12.0: Knuth's and the
    rejection sampler) under both population caps, with KillProb and
    SerialTransfer, on the kernel route; mating types, energy and threads
    on the micro-step engine.  The CPU runs the first SLICE10_WARM
    updates alone (to the first births); the card's world then takes the
    CPU's state, world key and update, and both run SLICE10_COMPARED
    updates.  `cpu` holds the cpu_jobs job of slice10_cpu_side for each
    case, else they run here."""
    import torch
    from avida_tpu_torch import convert
    from avida_tpu_torch.ops import cycles
    results = []
    for k, (name, side, extra, events, kind) in enumerate(SLICE10_CROSS):
        (warm, key, at), after, warm_s, cpu_s = cpu_half(
            None if cpu is None else cpu[k], slice10_cpu_side,
            cpu_root(tmp), k)
        w = slice10_world(name, side, extra, events, kind,
                          os.path.join(tmp, f"s10_{name}_{device}"), device,
                          tmp, f"{name}_{device}")
        w.state = convert.state_from_arrays(warm, device)
        w.key = torch.from_numpy(key).to(device)
        w.update = at
        bad, births, card_s = [], 0, 0.0
        for u, sb in zip(range(at + 1, at + SLICE10_COMPARED + 1), after):
            t0 = time.perf_counter()
            w.run(max_updates=u)
            _sync(device)
            card_s += time.perf_counter() - t0
            sa = convert.state_to_arrays(w.state)
            bad += [(u, f) for f in sa if sa[f] is not None
                    and sa[f].tobytes() != sb[f].tobytes()]
            births += int((sa["birth_update"] == u - 1).sum())
        if bad or births == 0 or len(after) != SLICE10_COMPARED:
            raise AssertionError(f"slice10_cross_device {name}: card vs cpu "
                                 f"differ at (update, field) {bad[:8]} "
                                 f"(births {births})")
        results.append({"case": name, "world": f"{side}x{side}",
                        "updates_warm": at,
                        "updates_compared": SLICE10_COMPARED,
                        "births_compared": births,
                        "warm_s_cpu": warm_s,
                        "compared_s": {"card": card_s, "cpu": cpu_s},
                        "engine": w.engine_report()["engine"],
                        "kernel_route": cycles.use_kernel(w.params),
                        "alive": w.num_organisms})
    return {"phase": "slice10_cross_device", "fields_equal": True,
            "compared": "every field after every compared update",
            "cases": results}


# ---- slice 11: experimental hardware, the print actions, the 5-bit
# genome plane ----

PRED = dict(PRED_PREY_SWITCH=0, PRED_EFFICIENCY=1.0)
# a stock predator: look, attack the faced prey, step into its cell, turn
PREDATOR = ("look-ahead", "nop-C", "attack-prey", "nop-B", "move", "nop-B",
            "inc", "nop-C", "rotate-x", "nop-C", "attack-prey", "nop-B",
            "move", "nop-B")
PREDATOR_EVERY = 16
EXP_UPDATES = 2                 # experimental_path: 2 updates + 1 timed
#                                 phase by phase
EXP_CROSS_SIDE, EXP_CROSS_UPDATES = 12, 2
PRINT_SIDE, PRINT_UPDATES = 60, 10
BITS_UPDATES, BITS_EVERY = 10, 5
NEW_PRINTS = ("PrintFitnessData", "PrintStatsData",
              "PrintInstructionAbundanceHistogram", "PrintDepthHistogram",
              "PrintGenotypeAbundanceHistogram", "PrintTasksExeData",
              "PrintTasksQualData")
PRINT_DATA = ("PrintData mydata.dat core.update,core.world.organisms,"
              "core.world.ave_fitness,core.world.ave_merit,"
              "core.world.ave_gestation_time,core.world.ave_generation,"
              "core.world.ave_age,core.world.max_fitness,"
              "core.world.births,core.world.genotypes")


def avatars_names():
    """The avatars set: pred_look's sensing set plus attack-prey (as
    tests/test_experimental.py:166-176 builds it), then the experimental
    set's replication instructions, so the experimental ancestor runs."""
    from avida_tpu_torch.config.instset import (experimental_instset,
                                                pred_look_instset)
    pl = list(pred_look_instset().inst_names)
    return pl + ["attack-prey"] + [n for n in experimental_instset().inst_names
                                   if n not in pl]


def experimental_world(side, ddir, device, tmp, tag, events=()):
    """A predator-prey world (PRED) of the avatars set: the experimental
    ancestor in every cell (InjectAll), and the predator with forage
    target -2 in every PREDATOR_EVERY-th."""
    from avida_tpu_torch.world import default_ancestor
    names = avatars_names()
    cdir = write_config_dir(os.path.join(tmp, f"cfg_exp_{tag}"),
                            instset=instset_text(names, hw_type=3))
    w = make_world(side, ddir, device, ["u begin InjectAll"] + list(events),
                   PRED, cdir)
    w.process_events()
    anc = list(default_ancestor(w.instset))
    reseed_alternating(w, [[names.index(x) for x in PREDATOR]]
                       + [anc] * (PREDATOR_EVERY - 1))
    ft = w.state.forage_target.clone()
    ft[::PREDATOR_EVERY] = -2
    w.state = w.state.replace(forage_target=ft)
    return w


@contextlib.contextmanager
def watch_predation(acc):
    """Add each cycle's successful attacks, kills and moves to `acc` as
    device tensors (no host read): wraps interpreter._apply_attacks and
    _apply_moves, which micro_step calls after the cycle's merge."""
    from avida_tpu_torch.ops import interpreter
    orig_a, orig_m = interpreter._apply_attacks, interpreter._apply_moves

    def attacks(params, st, pre, atk_ok, atk_tgt):
        out = orig_a(params, st, pre, atk_ok, atk_tgt)
        acc["attacks"] = acc.get("attacks", 0) + atk_ok.sum()
        acc["kills"] = acc.get("kills", 0) + (st.alive & ~out.alive).sum()
        return out

    def moves(st, won, target):
        acc["moves"] = acc.get("moves", 0) + won.sum()
        return orig_m(st, won, target)
    interpreter._apply_attacks, interpreter._apply_moves = attacks, moves
    try:
        yield acc
    finally:
        interpreter._apply_attacks, interpreter._apply_moves = orig_a, orig_m


def predation(w):
    st = w.state
    pred = st.alive & (st.forage_target == -2)
    return {"predators": int(pred.sum()),
            "prey": int((st.alive & ~pred).sum())}


def phase_experimental_path(side, tmp, smi):
    """The headline world on experimental hardware (hw_type 3, the
    micro-step engine, no launch): the avatars set, the experimental
    ancestor everywhere and a predator in every sixteenth cell,
    PRED_PREY_SWITCH 0, PRED_EFFICIENCY 1.0.  World.run for EXP_UPDATES
    updates, then the next update timed phase by phase (on the world's
    state; the world stays where it is); attacks, kills and moves
    counted on the device in each."""
    import torch
    from avida_tpu_torch.ops import cycles
    w = experimental_world(side, os.path.join(tmp, "experimental"), "cuda",
                           tmp, "path")
    start = predation(w)
    acc = {}
    with watch_predation(acc):
        insts, wall, launches, _ = run_counted(w, EXP_UPDATES)
    run_counts = {k: int(v) for k, v in acc.items()}
    acc = {}
    cycles.reset_launches()
    with watch_predation(acc):
        breakdown = update_breakdown(w)
    torch.cuda.synchronize()
    t_launches = cycles.LAUNCHES
    t_counts = {k: int(v) for k, v in acc.items()}
    res = {"phase": "experimental_path", "world": f"{side}x{side}",
           "config": PRED, "inst_set": len(w.instset.inst_names),
           "engine_report": w.engine_report(), "updates": w.update,
           "kernel_launches": launches + t_launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / EXP_UPDATES, "wall_s": wall,
           "timed_update": {"update": w.update + 1,
                            "ms": breakdown["ms_per_update_total"],
                            **t_counts},
           "breakdown": breakdown,
           "ms_per_cycle": breakdown["ms_per_cycle"],
           "trips": breakdown["trips"], "run": run_counts,
           "start": start, "end": predation(w),
           "births_total": int(w._total_births), "nvidia_smi": smi}
    _check_xla_world(w, "experimental_path", res,
                     reason="non-heads hardware")
    if (run_counts["kills"] + t_counts["kills"] == 0
            or run_counts["moves"] + t_counts["moves"] == 0):
        raise AssertionError(f"experimental_path: no kill or move: {res}")
    return res


def exp_cross_side(tmp, dev, updates=EXP_CROSS_UPDATES):
    """One half of experimental_cross_device: the 12x12 predator-prey
    world built on `dev`, its state arrays at the start and after each
    update, each update's kills and moves, its .dat files, the seconds."""
    from avida_tpu_torch import convert
    t0 = time.perf_counter()
    w = experimental_world(
        EXP_CROSS_SIDE, os.path.join(tmp, f"exp_cross_{dev}"), dev, tmp,
        f"cross_{dev}", [f"u 0:1:end {a}" for a in PRINTS[:4]])
    arrays = [convert.state_to_arrays(w.state)]
    counts = []
    for u in range(1, updates + 1):
        acc = {}
        with watch_predation(acc):
            w.run(max_updates=u)
        counts.append({k: int(v) for k, v in acc.items()})
        arrays.append(convert.state_to_arrays(w.state))
    return arrays, counts, dat_bodies(w.data_dir), time.perf_counter() - t0


def phase_experimental_cross_device(tmp, cpu=None, device="cuda"):
    """The 12x12 predator-prey world built and run on the card and on the
    CPU (`cpu`: its cpu_jobs job): every field equal at the start and
    after each of EXP_CROSS_UPDATES updates, the .dat files byte for
    byte, with kills and moves inside the compared updates."""
    a_cpu, c_cpu, d_cpu, s_cpu = cpu_half(cpu, exp_cross_side,
                                          cpu_root(tmp), "cpu")
    a_dev, c_dev, d_dev, s_dev = exp_cross_side(tmp, device)
    bad = [(u, f) for u, (x, y) in enumerate(zip(a_dev, a_cpu)) for f in x
           if x[f] is not None and x[f].tobytes() != y[f].tobytes()]
    kills = sum(c.get("kills", 0) for c in c_dev)
    moves = sum(c.get("moves", 0) for c in c_dev)
    res = {"phase": "experimental_cross_device",
           "world": f"{EXP_CROSS_SIDE}x{EXP_CROSS_SIDE}",
           "updates_compared": EXP_CROSS_UPDATES, "per_update": c_dev,
           "kills": kills, "moves": moves, "dat_files": sorted(d_dev),
           "seconds": {"card": s_dev, "cpu": s_cpu},
           "fields_equal": not bad, "dat_equal": d_dev == d_cpu,
           "counts_equal": c_dev == c_cpu}
    if bad or d_dev != d_cpu or c_dev != c_cpu or not kills or not moves \
            or len(a_dev) != EXP_CROSS_UPDATES + 1:
        raise AssertionError(f"experimental_cross_device: {res} "
                             f"(update, field) {bad[:8]}")
    return res


def print_side(tmp, dev):
    """One half of print_actions: a PRINT_SIDE world on the kernel route
    with systematics on, every new print action and PrintData each update
    for PRINT_UPDATES updates: (.dat files, kernel launches, seconds)."""
    import torch
    from avida_tpu_torch.ops import cycles
    t0 = time.perf_counter()
    w = make_world(PRINT_SIDE, os.path.join(tmp, f"prints_{dev}"), dev,
                   ["u begin InjectAll"]
                   + [f"u 0:1:end {a}" for a in NEW_PRINTS + (PRINT_DATA,)],
                   {"TPU_SYSTEMATICS": 1})
    cycles.reset_launches()
    w.run(max_updates=PRINT_UPDATES)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return dat_bodies(w.data_dir), cycles.LAUNCHES, time.perf_counter() - t0


def phase_print_actions(tmp, smi, cpu=None, device="cuda"):
    """The eight print actions (ROADMAP 12j) on the card and on the CPU
    (`cpu`: its cpu_jobs job): every .dat file byte for byte."""
    d_cpu, _, s_cpu = cpu_half(cpu, print_side, cpu_root(tmp), "cpu")
    d_dev, launches, s_dev = print_side(tmp, device)
    want = sorted(["fitness.dat", "stats.dat", "instruction_histogram.dat",
                   "depth_histogram.dat", "genotype_abundance_histogram.dat",
                   "tasks_exe.dat", "tasks_quality.dat", "mydata.dat"])
    rows = {f: sum(1 for ln in v if ln.strip() and not ln.startswith("#"))
            for f, v in d_dev.items()}
    res = {"phase": "print_actions", "world": f"{PRINT_SIDE}x{PRINT_SIDE}",
           "updates": PRINT_UPDATES, "kernel_launches": launches,
           "rows": rows, "seconds": {"card": s_dev, "cpu": s_cpu},
           "dat_equal": d_dev == d_cpu, "nvidia_smi": smi}
    if d_dev != d_cpu or sorted(d_dev) != want \
            or min(rows.values()) < PRINT_UPDATES:
        raise AssertionError(f"print_actions check failed: {res}")
    return res


def phase_packed_bits_path(side, tmp, smi, start):
    """The main path with the 5-bit genome shadow plane (TPU_PACKED_BITS
    =1, ROADMAP 12i): from `start`, main_path's evolved (state, world
    key, update), BITS_UPDATES more updates on the packed engine (births
    among them), one K1 launch each, the state at each chunk boundary
    field-equal to the same run's with the 8-bit plane (run beside it;
    its launches are the comparison's and not counted)."""
    import torch
    from avida_tpu_torch import convert
    from avida_tpu_torch.core.state import clone_state
    from avida_tpu_torch.ops import cycles
    ev = [f"u 0:{BITS_EVERY}:end {a}" for a in PRINTS[:4]]
    w5 = make_world(side, os.path.join(tmp, "bits5"), "cuda", ev,
                    {"TPU_PACKED_BITS": 1})
    w8 = make_world(side, os.path.join(tmp, "bits8"), "cuda", ev)
    state, key, u0 = start
    for w in (w5, w8):
        w.state, w.key, w.update = clone_state(state), key.clone(), u0
    launches, insts, wall, bad = 0, 0, 0.0, []
    for u in range(u0 + BITS_EVERY, u0 + BITS_UPDATES + 1, BITS_EVERY):
        torch.cuda.synchronize()
        cycles.reset_launches()
        t0 = time.perf_counter()
        insts += w5.run(max_updates=u)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        launches += cycles.LAUNCHES
        w8.run(max_updates=u)
        a, b = convert.state_to_arrays(w5.state), convert.state_to_arrays(
            w8.state)
        bad += [(u, f) for f in a if a[f] is not None
                and a[f].tobytes() != b[f].tobytes()]
    rep = w5.engine_report()
    res = {"phase": "packed_bits_path", "world": f"{side}x{side}",
           "engine_report": rep, "updates": w5.update - u0,
           "kernel_launches": launches, "insts": insts,
           "org_inst_per_s": insts / wall,
           "ms_per_update": 1e3 * wall / BITS_UPDATES, "wall_s": wall,
           "gen_plane_rows": {"bits5": -(-w5.params.max_memory // 6),
                              "bits8": -(-w5.params.max_memory // 4)},
           "equal_8_bit_run": not bad, "updates_from": u0,
           "births_total": int(w5._total_births), "nvidia_smi": smi}
    if bad or launches != BITS_UPDATES or rep.get("packed_bits") != 1 \
            or w8.engine_report()["packed_bits"] != 0 \
            or w5.num_organisms == 0 or res["births_total"] == 0:
        raise AssertionError(f"packed_bits_path check failed: {res} "
                             f"{bad[:8]}")
    return w5, res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from avida_tpu_torch.ops import cycles

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    lib = cycles.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib), "flags": list(cycles.NVCC_FLAGS),
          "resources": cycles.resources()})

    with tempfile.TemporaryDirectory() as tmp, cpu_jobs() as pool:
        # the CPU halves of the cross-device phases run in the workers
        # beside the card's phases, queued in the order the phases need
        # them
        ctmp = cpu_root(tmp)
        jobs = {key: pool.submit(fn, ctmp, "cpu") for key, fn in (
            ("cross", cross_side), ("mw_cross", mw_cross_side),
            ("xla_cross", xla_cross_side), ("pool_cross", pool_cross_side),
            ("smt_cross", smt_cross_side))}
        spop_file = spop_save(tmp)
        jobs["spop"] = pool.submit(spop_load, spop_file, ctmp, "cpu")
        for kind, n in (("heads", FOLD_UPDATES), ("smt", SMT_FOLD_UPDATES)):
            jobs[f"{kind}_fold"] = [
                pool.submit(fold_solo, ctmp, kind, MW_SIDE, MW_SEEDS[k], n)
                for k in FOLD_CHECKED]
        jobs["slice10"] = [pool.submit(slice10_cpu_side, ctmp, k)
                           for k in range(len(SLICE10_CROSS))]
        jobs["exp_cross"] = pool.submit(exp_cross_side, ctmp, "cpu")
        jobs["prints"] = pool.submit(print_side, ctmp, "cpu")
        emit(phase_geometry(tmp))
        emit(phase_size_range(tmp))
        w, main_res = phase_main(SIDE, UPDATES, os.path.join(tmp, "data"))
        emit(main_res)
        kern = phase_kernel(w)
        emit(phase_breakdown(w))
        # packed_bits_path continues the evolved main path
        from avida_tpu_torch.core.state import clone_state
        main_end = (clone_state(w.state), w.key.clone(), w.update)
        del w
        wd, def_res = phase_default_path(SIDE, DEFAULT_UPDATES,
                                         os.path.join(tmp, "default"))
        emit(def_res)
        dkern = phase_default_kernel(wd)
        emit(phase_default_breakdown(wd, def_res))
        del wd
        ws, sex_res = phase_default_path(
            SIDE, DEFAULT_UPDATES, os.path.join(tmp, "sex"),
            name="sex_path", extra={"INST_SET": "heads_sex"},
            reason="divide-sex")
        emit(sex_res)
        skern = phase_default_kernel(ws, name="sex_path")
        emit(phase_default_breakdown(ws, sex_res, name="sex_breakdown"))
        del ws
        ckern = phase_costs_kernel(SIDE, COSTS_UPDATES, tmp)
        emit(dict(ckern, phase="costs_kernel"))
        emit(phase_cross_device(tmp, jobs["cross"]))
        emit(phase_mw_cross_device(tmp, jobs["mw_cross"]))
        # persistence: each resumed run counts its own launches
        pres, persist_gen = phase_persist_path(tmp, smi)
        emit(pres)
        dres = phase_persist_default(tmp, smi)
        emit(dres)
        emit(phase_preempt_cli(tmp, smi, persist_gen))
        scrub_res, scrub_launches = phase_scrub_path(tmp, smi)
        emit(scrub_res)
        emit(phase_spop_path(tmp, smi, spop_file, jobs["spop"]))
        persist_launches = (pres["kernel_launches_after_resume"]
                            + dres["kernel_launches_after_resume"]
                            + scrub_launches)
        mw_runs = []
        mw_ck = os.path.join(tmp, "mw_ck")
        for path, sysm in (("multiworld_path", 1), ("multiworld_packed", 0)):
            mw, mw_res = phase_multiworld(
                path, sysm, tmp, MW_SIDE, MW_SEEDS, MW_UPDATES,
                ckpt_root=mw_ck if sysm else None)
            emit(mw_res)
            mwk = phase_mw_kernel(mw, path)
            emit(dict(mwk, phase=f"{path}_kernel", nvidia_smi=smi))
            emit(phase_mw_breakdown(mw, mw_res, f"{path}_breakdown"))
            if sysm:
                mres, mw_resumed = phase_multiworld_persist(tmp, smi, mw,
                                                            mw_ck)
                emit(mres)
            del mw
            mw_runs.append((mw_res, mwk))
        # the micro-step engine (no kernel launch on its paths)
        emit(phase_kernel_limits(tmp))
        emit(phase_xla_path(SIDE, XLA_UPDATES, os.path.join(tmp, "xla"),
                            smi))
        emit(phase_math_path(SIDE, XLA_UPDATES, tmp, smi))
        emit(phase_engines_agree(SIDE, AGREE_UPDATES, tmp))
        emit(phase_xla_cross_device(tmp, jobs["xla_cross"]))
        emit(phase_multiworld_fold(tmp, MW_SIDE, MW_SEEDS, FOLD_UPDATES,
                                   smi, jobs["heads_fold"]))
        # resource pools and demes
        emit(phase_resource_path(SIDE, XLA_UPDATES, tmp, smi))
        wdeme, deme_res = phase_deme_path(SIDE, tmp, smi)
        emit(deme_res)
        demek = phase_default_kernel(wdeme, name="deme_path")
        del wdeme
        emit(phase_deme_resource_path(SIDE, XLA_UPDATES, tmp, smi))
        emit(phase_resources_cross_device(tmp, jobs["pool_cross"]))
        # TransSMT hardware and host-parasite coevolution
        emit(phase_smt_path(SIDE, SMT_UPDATES, os.path.join(tmp, "smt"),
                            smi))
        emit(phase_smt_cross_device(tmp, jobs["smt_cross"]))
        emit(phase_smt_fold(tmp, MW_SIDE, MW_SEEDS, SMT_FOLD_UPDATES,
                            smi, jobs["smt_fold"]))
        # slice 10: dispersal, population control and topologies on the
        # kernel route; mating types, energy and threads on the
        # micro-step engine
        wdisp, disp_res = phase_dispersal_path(SIDE, tmp, smi)
        emit(disp_res)
        dispk = phase_default_kernel(wdisp, name="dispersal_path")
        del wdisp
        whex, topo_res = phase_topology_path(SIDE, tmp, smi)
        emit(topo_res)
        topok = phase_default_kernel(whex, name="topology_path")
        del whex
        emit(phase_mating_path(SIDE, tmp, smi))
        emit(phase_energy_path(SIDE, tmp, smi))
        emit(phase_threads_path(SIDE, tmp, smi))
        emit(phase_slice10_cross_device(tmp, jobs["slice10"]))
        # slice 11: experimental hardware on the micro-step engine, the
        # print actions, the 5-bit genome plane on the packed engine
        emit(phase_experimental_path(SIDE, tmp, smi))
        emit(phase_experimental_cross_device(tmp, jobs["exp_cross"]))
        emit(phase_print_actions(tmp, smi, jobs["prints"]))
        wbits, bits_res = phase_packed_bits_path(SIDE, tmp, smi, main_end)
        del main_end
        emit(bits_res)
        bitsk = phase_kernel(wbits, n_launch=2)
        del wbits
    timing = ("max_abs_err", "ms", "simple_ms", "turns_ms", "reached",
              "plain_ms", "bound_ms", "bytes_read", "bytes_written")
    per_path = [
        dict({k: kern[k] for k in timing}, path="main_path",
             launches=main_res["kernel_launches"]),
        dict(dkern, launches=def_res["kernel_launches"]),
        dict(skern, launches=sex_res["kernel_launches"]),
        {k: ckern[k] for k in ("path", "launches") + timing},
        dict(demek, launches=deme_res["kernel_launches"]),
        dict(dispk, launches=disp_res["kernel_launches"]),
        dict(topok, launches=topo_res["kernel_launches_total"]),
        dict({k: bitsk[k] for k in timing}, path="packed_bits_path",
             launches=bits_res["kernel_launches"])]
    per_path += [dict({k: mwk[k] for k in ("path", "solo_ms_sum") + timing},
                      launches=mw_res["kernel_launches"], stacked=True)
                 for mw_res, mwk in mw_runs]
    emit({"phase": "kernel_paths", "nvidia_smi": smi, "paths": per_path})
    # the kernels line: K1 with its solo launches (the seven solo paths,
    # deme_path, dispersal_path, topology_path and packed_bits_path
    # included, and the resumed and scrubbed persistence runs),
    # the worst error of all, times and bound at the sexual path; K3b,
    # the stacked launch, with its launches over the two batch paths and
    # the resumed batch, and
    # its times and bound at the default batch path (multiworld_path).
    # Each launch is counted once, under the wrapper that made it.
    kern.update(launches=sum(q["launches"] for q in per_path
                             if not q.get("stacked")) + persist_launches,
                max_abs_err=max(q["max_abs_err"] for q in per_path),
                **{k: skern[k] for k in ("ms", "simple_ms", "reached",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "bytes_read", "bytes_written")})
    mwk = mw_runs[0][1]
    stacked = {"name": "cycles_stacked", "route": "cuda",
               "source": "avida_tpu_torch/csrc/cycles.cu",
               "replaces": "avida_tpu/ops/pallas_cycles.py:1729",
               "launches": sum(r["stacked_launches"] for r, _ in mw_runs)
               + mw_resumed,
               "max_abs_err": max(k["max_abs_err"] for _, k in mw_runs),
               "library_ms": None,
               **{k: mwk[k] for k in ("ms", "simple_ms", "reached",
                                      "plain_ms", "bound_ms", "bound_by")}}
    emit({"phase": "kernels", "nvidia_smi": smi, "kernels": [kern, stacked]})
    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: x[k] for k in keys} for x in (kern, stacked)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
