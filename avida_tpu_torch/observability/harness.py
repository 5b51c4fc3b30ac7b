"""Profiling harness: per-phase breakdown of one update's wall time.

Counterpart of avida_tpu/observability/harness.py.  It times each phase
of ops/update.update_step through the SAME StagedUpdate runner the
telemetry path uses, the packed-resident engines' own phases
(measure_packed_phases, measure_packed_worlds_phases), the packed chunk
and the multi-world batch end to end, and the folded batch's
pre/cycles/post split.  The live profiler's probes
(observability/profiler.py) and the port's bench call these.

Measurement rules (BASELINE.md): every rep runs on the previous rep's
evolved state with a fresh update number, so no phase sees the same
input twice; each phase is fenced (torch.cuda.synchronize on the card),
so the phase sum is an upper bound on the unfenced update.

The reference's analytics and trace-drain timings (measure_analytics,
measure_trace_drain) and its command line (`main`, built on the
reference's bench.py) wait for the port's bench (ROADMAP item 8).
"""

from __future__ import annotations

import time

import torch

from avida_tpu_torch.observability.staged import StagedUpdate
from avida_tpu_torch.observability.timeline import Timeline, fence
from avida_tpu_torch.utils import prng


def _device(st):
    return st.alive.device


def profile_phases(params, st, neighbors, key, reps=3, warmup=1,
                   update0=0, collect_dispatch=False):
    """Mean per-phase wall time over `reps` staged updates (ms), after
    `warmup` warm updates.  Each rep advances the state.  Returns
    ({phase: ms}, final_state, total_granted)."""
    staged = StagedUpdate(params, neighbors,
                          collect_dispatch=collect_dispatch)
    u = update0
    warm_tl = Timeline(_device(st))
    for _ in range(max(warmup, 1)):
        st, *_ = staged.run(st, prng.fold_in(key, u), u, warm_tl)
        u += 1
    tl = Timeline(_device(st))
    granted_total = 0
    for _ in range(reps):
        st, _, _, granted, _ = staged.run(st, prng.fold_in(key, u), u, tl)
        granted_total += int(granted.sum())
        u += 1
    acc = tl.drain()
    return {name: ms / reps for name, ms in acc.items()}, st, granted_total


def measure_packed_chunk(params, st, neighbors, key, updates=8, reps=3):
    """End-to-end ms/update of the packed-resident chunk (pack once,
    `updates` updates on the resident planes, unpack once) through
    update_scan.  Returns (ms_per_update, final_state), or (None, st)
    when the configuration does not qualify (packed_chunk.active)."""
    from avida_tpu_torch.ops import packed_chunk
    from avida_tpu_torch.ops.update import update_scan

    if not packed_chunk.active(params, st):
        return None, st
    dev = _device(st)
    u0 = 1 << 20              # clear of any real update numbers
    st, _ = update_scan(params, st, updates, key, u0, neighbors)   # warm
    fence(dev)
    t0 = time.perf_counter()
    for r in range(reps):
        st, _ = update_scan(params, st, updates, key,
                            u0 + (r + 1) * updates, neighbors)
        fence(dev)
    ms = (time.perf_counter() - t0) * 1e3 / (reps * updates)
    return ms, st


def measure_multiworld(params, sts, neighbors, keys, updates=8, reps=3):
    """End-to-end ms/update-per-world of the batched multi-world scan
    (parallel/multiworld.multiworld_scan).  Returns
    (ms_per_update_per_world, final_batched_state)."""
    from avida_tpu_torch.core.state import stack_states
    from avida_tpu_torch.parallel.multiworld import multiworld_scan

    W = len(keys)
    bstate = stack_states(list(sts))
    bkeys = torch.stack(list(keys))
    dev = _device(bstate)
    u0 = 1 << 20
    bstate, _ = multiworld_scan(params, bstate, updates, bkeys, u0,
                                neighbors)                      # warm
    fence(dev)
    t0 = time.perf_counter()
    for r in range(reps):
        bstate, _ = multiworld_scan(params, bstate, updates, bkeys,
                                    u0 + (r + 1) * updates, neighbors)
        fence(dev)
    ms = (time.perf_counter() - t0) * 1e3 / (reps * updates * W)
    return ms, bstate


def measure_batched_phases(params, bst, neighbors, bkeys, reps=3,
                           u0=1 << 21, warmup=True):
    """Fenced pre/cycles/post attribution of a stacked batched state on
    the folded micro-step engine (ops/update.batched_update_step's
    phases: mw_pre_phase per world, mw_fold_cycles_xla once, bank and
    birth per world).  With warmup=False rep 0 counts.  Returns
    {"pre_ms", "cycles_ms", "post_ms", "cycle_loop_share"}."""
    from avida_tpu_torch.core.state import unstack_states
    from avida_tpu_torch.ops import update as upd

    dev = _device(bst)
    sts = unstack_states(bst)
    t = {"pre": 0.0, "cycles": 0.0, "post": 0.0}
    counted = 0
    for r in range(reps + (1 if warmup else 0)):
        u = u0 + r
        keys = [prng.fold_in(rk, u) for rk in bkeys]
        fence(dev)
        t0 = time.perf_counter()
        pre = [upd.mw_pre_phase(params, st, k, u)
               for st, k in zip(sts, keys)]
        sts = [p[0] for p in pre]
        budgets, granted, max_k, k_steps, k_birth = zip(*[p[1] for p in pre])
        fence(dev)
        t1 = time.perf_counter()
        e0 = [st.insts_executed for st in sts]
        sts = upd.mw_fold_cycles_xla(params, sts, k_steps, granted, max_k)
        fence(dev)
        t2 = time.perf_counter()
        out = []
        for w, st in enumerate(sts):
            st, _ = upd.bank_phase(params, st, budgets[w], e0[w])
            out.append(upd.birth_phase(params, st, k_birth[w], k_steps[w],
                                       u, neighbors))
        sts = out
        fence(dev)
        t3 = time.perf_counter()
        if not warmup or r > 0:
            t["pre"] += t1 - t0
            t["cycles"] += t2 - t1
            t["post"] += t3 - t2
            counted += 1
    counted = counted or 1
    total = sum(t.values()) or 1e-9
    return {
        "pre_ms": round(t["pre"] * 1e3 / counted, 3),
        "cycles_ms": round(t["cycles"] * 1e3 / counted, 3),
        "post_ms": round(t["post"] * 1e3 / counted, 3),
        "cycle_loop_share": round(t["cycles"] / total, 4),
    }


def measure_multiworld_phases(params, sts, neighbors, keys, reps=3):
    """measure_batched_phases for a list of W states and their run keys
    (ms per update for the whole batch; the share in [0, 1])."""
    from avida_tpu_torch.core.state import stack_states
    return measure_batched_phases(params, stack_states(list(sts)),
                                  neighbors, torch.stack(list(keys)),
                                  reps=reps)


_PACKED_PHASES = ("pack", "scan.schedule", "scan.kernel", "scan.bank",
                  "scan.flush", "scan.stats", "unpack")


def _packed_chain(params, pack, step_fns, unpack, st, reps, u0, warmup,
                  dev):
    """Run pack -> the in-chunk phases -> unpack `reps` (+ warmup) times,
    each fenced; returns {phase_ms}."""
    t = {n: 0.0 for n in _PACKED_PHASES}
    counted = 0
    for r in range(reps + (1 if warmup else 0)):
        u = u0 + r
        fence(dev)
        marks = [time.perf_counter()]

        def mark(x):
            fence(dev)
            marks.append(time.perf_counter())
            return x

        pc = mark(pack(st))
        for fn in step_fns:
            pc = mark(fn(pc, u))
        st = mark(unpack(pc))
        if not warmup or r > 0:
            for i, n in enumerate(_PACKED_PHASES):
                t[n] += marks[i + 1] - marks[i]
            counted += 1
    counted = counted or 1
    return {f"{n}_ms": round(v * 1e3 / counted, 3) for n, v in t.items()}


def measure_packed_phases(params, st, neighbors, key, reps=3,
                          u0=1 << 22, warmup=True):
    """Fenced per-phase attribution of the packed-resident update
    (ops/packed_chunk.update_step_packed): boundary phases `pack` /
    `unpack` and in-chunk phases `scan.schedule` / `scan.kernel` /
    `scan.bank` / `scan.flush` / `scan.stats`, on whichever body (fused
    or row-space) the run takes.  Returns {phase_ms} or {} when the
    packed engine is not active (or the flight recorder is armed: the
    staged mirror does not reproduce the trace phases)."""
    from avida_tpu_torch.ops import packed_chunk as pch
    from avida_tpu_torch.ops import update as upd

    if not pch.active(params, st) or int(params.trace_cap):
        return {}
    ctx = {}

    def sched(pc, u):
        k = prng.fold_in(key, u)
        ks = prng.split(k, 3)
        ctx["alive_before"] = (pch.alive_rows(pc.ivec).sum().to(torch.int32)
                               if pch.fused_active(params)
                               else pc.st.alive.sum().to(torch.int32))
        pc, ctx["budgets"], _, ctx["e0"] = pch.schedule_phase(
            params, pc, ks[0], k, u)
        ctx["k_steps"], ctx["k_birth"] = ks[1], ks[2]
        return pc

    def kernel(pc, u):
        pch.kernel_phase(params, pc, ctx["k_steps"])
        return pc

    def bank(pc, u):
        return pch.bank_phase(params, pc, ctx["budgets"], ctx["e0"])[0]

    def flush(pc, u):
        return pch.flush_phase(params, pc, ctx["k_birth"], u)

    def stats(pc, u):
        if pch.fused_active(params):
            pch.stats_rows(pc, ctx["alive_before"], u)
        else:
            upd.update_stats(params, pc.st, ctx["alive_before"], u)
        return pc

    return _packed_chain(params, lambda s: pch.pack_chunk(params, s),
                         (sched, kernel, bank, flush, stats),
                         lambda pc: pch.unpack_chunk(params, pc), st, reps,
                         u0, warmup, _device(st))


def measure_packed_worlds_phases(params, bst, neighbors, bkeys, reps=3,
                                 u0=1 << 22, warmup=True):
    """measure_packed_phases for a stacked batch on the stacked packed
    engine (ops/packed_chunk.update_step_packed_worlds): whole-batch ms
    per phase.  Returns {} when that engine is not active."""
    from avida_tpu_torch.ops import packed_chunk as pch
    from avida_tpu_torch.ops import update as upd

    if not pch.batch_active(params, bst) or int(params.trace_cap):
        return {}
    W = bkeys.shape[0]
    ctx = {}

    def sched(pw, u):
        un = [u] * W
        keys = [prng.fold_in(rk, u) for rk in bkeys]
        ks = [prng.split(k, 3) for k in keys]
        if pch.fused_active(params):
            ctx["alive_before"] = pch.alive_rows(pw.ivec).sum(dim=1).to(
                torch.int32)
        else:
            ctx["alive_before"] = torch.stack(
                [st.alive.sum().to(torch.int32) for st in pw.sts])
        pw, ctx["budgets"], _, ctx["e0"], _ = pch.schedule_phase_worlds(
            params, pw, [k[0] for k in ks], keys, un)
        ctx["k_steps"] = [k[1] for k in ks]
        ctx["k_birth"] = [k[2] for k in ks]
        ctx["un"] = un
        return pw

    def kernel(pw, u):
        pch.kernel_phase_worlds(params, pw, ctx["k_steps"])
        return pw

    def bank(pw, u):
        return pch.bank_phase_worlds(params, pw, ctx["budgets"],
                                     ctx["e0"])[0]

    def flush(pw, u):
        return pch.flush_phase_worlds(params, pw, ctx["k_birth"], ctx["un"])

    def stats(pw, u):
        if pch.fused_active(params):
            pch.stats_rows_worlds(pw, ctx["alive_before"], ctx["un"])
        else:
            for st, ab in zip(pw.sts, ctx["alive_before"]):
                upd.update_stats(params, st, ab, u)
        return pw

    return _packed_chain(params, lambda b: pch.pack_worlds(params, b),
                         (sched, kernel, bank, flush, stats),
                         lambda pw: pch.unpack_worlds(params, pw), bst,
                         reps, u0, warmup, _device(bst))
