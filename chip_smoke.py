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
                    and 15 against their solo runs

On each path's evolved state it holds both kernels bit for bit against
the plain PyTorch version, times them on the same planes in turns (first
port, Hopper, Hopper, first port) and times the path's own phase
functions; a batch's stacked launch is also held, world by world,
against the solo launches, and two batch members against their solo
runs; small worlds and a small batch run on the card and on the CPU
must end identical; the geometry phase holds both kernels to the plain
version at the launch shapes the paths do not reach (B = 128, 256, and
L = 1024).  Each phase prints one JSON line; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before that
line.  Needs a CUDA device: without one it exits 2 and prints no result.
"""

from __future__ import annotations

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
    ("default", 8, 24, {}, False, False, 0),
    ("mixed", 12, 16, dict(BASE_MERIT_METHOD=5, DIVIDE_METHOD=0,
                           GENERATION_INC_METHOD=0, REQUIRE_ALLOCATE=0,
                           COPY_MUT_PROB=0.05), True, True, 0),
    ("capped", 8, 24, dict(TPU_MAX_STEPS_PER_UPDATE=25), False, True, 0),
    ("systematics", 8, 16, dict(TPU_SYSTEMATICS=1), False, False, 4),
    ("sex", 8, 32, dict(TPU_SYSTEMATICS=1, INST_SET="heads_sex"), False,
     False, 4),
    ("costs", 8, 24, dict(COPY_MUT_PROB=0.02), False, True, 0),
    ("soup", 8, 24, dict(BIRTH_METHOD=4, WORLD_GEOMETRY=1), False, False,
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


def phase_cross_device(tmp, devices=("cuda", "cpu")):
    """Small worlds run on the card and on the CPU (the plain versions)
    must end in identical states (and, where they print, identical .dat
    bytes): the whole update path, kernel included, against its plain
    PyTorch counterpart, over default, mixed-program, capped and costs
    configurations of the packed engine and the systematics, heads-sex
    and soup (BIRTH_METHOD 4 on a grid) worlds of the per-update engine.
    Each world runs in stretches of 4 updates; the sexual one must hold
    a waiting birth-chamber entry at some stretch boundary."""
    from avida_tpu_torch import convert
    results = []
    for name, side, updates, extra, custom_env, mixed, every in CROSS_CASES:
        cdir = None
        if custom_env or name == "costs":
            cdir = write_config_dir(
                os.path.join(tmp, f"cfg_{name}"), env=custom_env,
                instset=COSTS_INSTSET if name == "costs" else None)
        states, dats, engines, stored = [], [], set(), []
        events = ["u begin InjectAll"] + (
            [f"u 0:{every}:end {a}" for a in PRINTS] if every else [])
        want = CROSS_ENGINES.get(name, ("packed", ""))
        for dev in devices:
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
            states.append(convert.state_to_arrays(w.state))
            dats.append(dat_bodies(ddir) if every else {})
            rep = w.engine_report()
            engines.add(rep["engine"])
            stored.append(n_stored)
            if rep["engine"] != want[0] \
                    or want[1] not in rep.get("fallback_reason", ""):
                raise AssertionError(f"{name}: engine {rep}, want {want}")
        sa, sb = states
        bad = [k for k in sa if sa[k] is not None
               and sa[k].tobytes() != sb[k].tobytes()]
        bad += [f for f in set(dats[0]) | set(dats[1])
                if dats[0].get(f) != dats[1].get(f)]
        births = int((sb["birth_update"] >= 0).sum())
        tasks = int((sb["task_exe_total"] > 0).any(axis=0).sum())
        if bad or births == 0 or (every and "dominant.dat" not in dats[0]) \
                or (name == "sex" and stored[0] == 0):
            raise AssertionError(f"{name}: cuda vs cpu differ in {bad} "
                                 f"(births {births}, files "
                                 f"{sorted(dats[0])}, boundaries with a "
                                 f"stored entry {stored})")
        res = {"case": name, "world": f"{side}x{side}",
               "updates": updates, "engine": sorted(engines),
               "births": births, "tasks_seen": tasks,
               "dat_files_equal": sorted(dats[0])}
        if name == "sex":
            res["boundaries_with_stored_entry"] = stored[0]
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


def mw_members(side, seeds, tmp, tag, device, sysm, every):
    """One World per seed, each seeded everywhere with the ancestor and
    printing every `every` updates into its own directory (dominant.dat
    with systematics)."""
    ev = ["u begin InjectAll"] + [f"u 0:{every}:end {a}" for a in PRINTS
                                  if sysm or a != "PrintDominantData"]
    return [make_world(side, os.path.join(tmp, f"{tag}_{k:03d}"), device, ev,
                       {"RANDOM_SEED": s, "TPU_SYSTEMATICS": sysm})
            for k, s in enumerate(seeds)]


def phase_multiworld(name, sysm, tmp, side, seeds, updates, device="cuda"):
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
    every = 10
    mw = MultiWorld(mw_members(side, seeds, tmp, name, device, sysm, every))
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


def phase_mw_cross_device(tmp, devices=("cuda", "cpu")):
    """A W = 3 batch of 8x8 worlds, 16 updates, on each engine, run on the
    card and on the CPU (the plain versions): every member must end in
    identical states and .dat bytes."""
    from avida_tpu_torch import convert
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    results = []
    for sysm in (1, 0):
        runs = []
        for dev in devices:
            tag = f"mwx{sysm}_{dev}"
            mw = MultiWorld(mw_members(8, MW_CROSS_SEEDS, tmp, tag, dev, sysm,
                                       4))
            if dev == "cpu":
                with one_thread():
                    mw.run(max_updates=16)
            else:
                mw.run(max_updates=16)
            _sync(dev)
            runs.append(([convert.state_to_arrays(w.state)
                          for w in mw.worlds],
                         [dat_bodies(w.data_dir) for w in mw.worlds],
                         mw.engine))
        (sa, da, ea), (sb, db, eb) = runs
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
    acc = {k: 0.0 for k in ("schedule", "cycles", "materialize", "bank",
                            "flush", "stats")}

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
        st = timed("materialize", update.materialize_offspring, p, st,
                   pending)
        st, _ = timed("bank", update.bank_phase, p, st, budgets, executed0)
        st = timed("flush", update.birth_phase, p, st, ks[2], ks[1], u)
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


def _check_xla_world(w, name, res, files=None):
    """The micro-step world's checks: routed off the kernel, no launch,
    live organisms with finite merits, the .dat files written."""
    import torch
    rep = w.engine_report()
    ok = (res["kernel_launches"] == 0 and rep["engine"] == "per-update"
          and "kernel off" in rep["fallback_reason"]
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


def phase_xla_cross_device(tmp, devices=("cuda", "cpu"), updates=9):
    """TPU_USE_PALLAS=2 on the card and on the CPU must end identical: a
    24x24 world with mutations on, mixed programs and the math
    environment, and a W = 3 batch of 8x8 worlds (the folded engine);
    states and .dat bytes."""
    from avida_tpu_torch import convert
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    cdir = math_config_dir(os.path.join(tmp, "cfg_xla_cross"))
    ev = ["u begin InjectAll"] + [f"u 0:4:end {a}" for a in XLA_PRINTS]
    extra = {"TPU_USE_PALLAS": 2, "AVE_TIME_SLICE": 60}
    solo, batch = [], []
    for dev in devices:
        w = make_world(24, os.path.join(tmp, f"xla_x_{dev}"), dev, ev, extra,
                       cdir)
        w.process_events()
        reseed_mixed(w)
        mw = MultiWorld([make_world(
            8, os.path.join(tmp, f"xla_mw_{dev}_{k}"), dev, ev,
            dict(extra, RANDOM_SEED=s)) for k, s in enumerate(
                XLA_CROSS_SEEDS)])
        if dev == "cpu":
            with one_thread():
                w.run(max_updates=updates)
                mw.run(max_updates=updates)
        else:
            w.run(max_updates=updates)
            mw.run(max_updates=updates)
        _sync(dev)
        solo.append((convert.state_to_arrays(w.state), dat_bodies(w.data_dir)))
        batch.append(([convert.state_to_arrays(x.state) for x in mw.worlds],
                      [dat_bodies(x.data_dir) for x in mw.worlds], mw.engine))
    (sa, da), (sb, db) = solo
    bad = [k for k in sa if sa[k] is not None
           and sa[k].tobytes() != sb[k].tobytes()]
    if da != db:
        bad.append(".dat files")
    (ma, mda, ea), (mb, mdb, eb) = batch
    bad += [(k, f) for k in range(len(ma)) for f in ma[k]
            if ma[k][f] is not None and ma[k][f].tobytes() != mb[k][f].tobytes()]
    bad += [(k, "dat") for k in range(len(mda)) if mda[k] != mdb[k]]
    births = int((sb["birth_update"] >= 0).sum())
    mw_births = sum(int((s["birth_update"] >= 0).sum()) for s in mb)
    if bad or births == 0 or mw_births == 0 or ea != "per-update":
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


def phase_multiworld_fold(tmp, side, seeds, updates, smi):
    """16 stock 60x60 worlds with TPU_USE_PALLAS=2: MultiWorld.run on the
    folded micro-step engine (one micro_step a cycle for the whole batch),
    no launch; members 0 and 15 equal their solo runs on the card."""
    import torch
    from avida_tpu_torch import convert
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    ev = ["u begin InjectAll"] + [f"u 0:{updates}:end {a}"
                                  for a in XLA_PRINTS]

    def member(k, tag):
        return make_world(side, os.path.join(tmp, f"{tag}_{k:03d}"), "cuda",
                          ev, {"RANDOM_SEED": seeds[k], "TPU_USE_PALLAS": 2})

    mw = MultiWorld([member(k, "fold") for k in range(len(seeds))])
    torch.cuda.synchronize()
    cycles.reset_launches()
    t0 = time.perf_counter()
    insts = mw.run(max_updates=updates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, stacked = cycles.LAUNCHES, cycles.STACKED_LAUNCHES
    checked = []
    for k in (0, len(seeds) - 1):
        sw = member(k, "fold_solo")
        sw.run(max_updates=updates)
        bad = _fields_equal(sw.state, mw.worlds[k].state, skip=())
        if dat_bodies(sw.data_dir) != dat_bodies(mw.worlds[k].data_dir):
            bad.append(".dat files")
        if bad:
            raise AssertionError(f"multiworld_fold: member {k} differs from "
                                 f"its solo run in {bad}")
        checked.append(k)
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


MW_SIDE, MW_UPDATES = 60, 30   # the fleet batch: 16 stock 60x60 worlds
MW_SEEDS = tuple(range(101, 117))  # TPU_FLEET_MAX_BATCH = 16 members

SIDE, UPDATES = 320, 50        # the main path's full-width world
DEFAULT_UPDATES = 30           # the default and sexual paths' depth
COSTS_UPDATES = 10             # the costs world's depth
XLA_UPDATES = 3                # the micro-step paths' depth at 320x320
AGREE_UPDATES = 6              # engines_agree: the first divides land
FOLD_UPDATES = 6               # the folded batch's depth


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

    with tempfile.TemporaryDirectory() as tmp:
        emit(phase_cross_device(tmp))
        emit(phase_mw_cross_device(tmp))
        emit(phase_geometry(tmp))
        w, main_res = phase_main(SIDE, UPDATES, os.path.join(tmp, "data"))
        emit(main_res)
        kern = phase_kernel(w)
        emit(phase_breakdown(w))
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
        mw_runs = []
        for path, sysm in (("multiworld_path", 1), ("multiworld_packed", 0)):
            mw, mw_res = phase_multiworld(path, sysm, tmp, MW_SIDE, MW_SEEDS,
                                          MW_UPDATES)
            emit(mw_res)
            mwk = phase_mw_kernel(mw, path)
            emit(dict(mwk, phase=f"{path}_kernel", nvidia_smi=smi))
            emit(phase_mw_breakdown(mw, mw_res, f"{path}_breakdown"))
            del mw
            mw_runs.append((mw_res, mwk))
        # the micro-step engine (no kernel launch on its paths)
        emit(phase_kernel_limits(tmp))
        emit(phase_xla_path(SIDE, XLA_UPDATES, os.path.join(tmp, "xla"),
                            smi))
        emit(phase_math_path(SIDE, XLA_UPDATES, tmp, smi))
        emit(phase_engines_agree(SIDE, AGREE_UPDATES, tmp))
        emit(phase_xla_cross_device(tmp))
        emit(phase_multiworld_fold(tmp, MW_SIDE, MW_SEEDS, FOLD_UPDATES,
                                   smi))
    timing = ("max_abs_err", "ms", "simple_ms", "turns_ms", "reached",
              "plain_ms", "bound_ms", "bytes_read", "bytes_written")
    per_path = [
        dict({k: kern[k] for k in timing}, path="main_path",
             launches=main_res["kernel_launches"]),
        dict(dkern, launches=def_res["kernel_launches"]),
        dict(skern, launches=sex_res["kernel_launches"]),
        {k: ckern[k] for k in ("path", "launches") + timing}]
    per_path += [dict({k: mwk[k] for k in ("path", "solo_ms_sum") + timing},
                      launches=mw_res["kernel_launches"], stacked=True)
                 for mw_res, mwk in mw_runs]
    emit({"phase": "kernel_paths", "nvidia_smi": smi, "paths": per_path})
    # the kernels line: K1 with its solo launches (the four solo paths),
    # the worst error of all, times and bound at the sexual path; K3b,
    # the stacked launch, with its launches over the two batch paths and
    # its times and bound at the default batch path (multiworld_path).
    # Each launch is counted once, under the wrapper that made it.
    kern.update(launches=sum(q["launches"] for q in per_path
                             if not q.get("stacked")),
                max_abs_err=max(q["max_abs_err"] for q in per_path),
                **{k: skern[k] for k in ("ms", "simple_ms", "reached",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "bytes_read", "bytes_written")})
    mwk = mw_runs[0][1]
    stacked = {"name": "cycles_stacked", "route": "cuda",
               "source": "avida_tpu_torch/csrc/cycles.cu",
               "replaces": "avida_tpu/ops/pallas_cycles.py:1729",
               "launches": sum(r["stacked_launches"] for r, _ in mw_runs),
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
