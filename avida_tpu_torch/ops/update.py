"""The update loop and its per-update statistics.

Counterpart of avida_tpu/ops/update.py.  `update_scan` runs a chunk of
updates as a Python loop, each update keyed fold_in(run_key, update_no)
exactly as the reference's lax.scan is, so a trajectory does not depend on
how the driver chunks the run.  It picks one of two bodies, as the
reference does:

  packed     the population stays in the kernel's plane layout for the
             whole chunk (ops/packed_chunk.py); kernel route only
  per-update `update_step` on the canonical PopulationState: resources ->
             schedule -> lane permutation -> cycles -> bank -> birth flush
             (+ point mutations); the engine behind systematics
             (TPU_SYSTEMATICS=1), whose newborn ring the canonical flush
             fills

The update's cycles run on one of two engines, routed as the reference
routes them (cycles.use_kernel): the cycle kernel (run_cycles: pack, one
launch, unpack) or the micro-step engine (xla_cycles: one micro-step a
cycle, up to the update's largest grant, then the offspring extraction)
-- TPU_USE_PALLAS=2, and every configuration the kernel gate refuses,
TransSMT hardware among them.  The micro-step is the hardware's
(cycle_step_fn): interpreter.micro_step for heads hardware,
interpreter_smt.micro_step_smt for TransSMT.

`update_scan_batched` is the same for W stacked worlds: one kernel launch
per update for the whole batch, or the micro-step engine over the worlds'
lanes folded onto one organism axis (mw_fold_cycles_xla).
"""

from __future__ import annotations

import torch

from avida_tpu_torch.core.state import (is_smt, stack_states,
                                        unstack_states)
from avida_tpu_torch.ops import birth as birth_ops
from avida_tpu_torch.ops import cycles
from avida_tpu_torch.ops import resources as res_ops
from avida_tpu_torch.ops import scheduler
from avida_tpu_torch.utils import prng


def static_cap(params) -> int:
    """The static per-update step cap (2^31-1 when uncapped)."""
    cap = int(params.max_steps_per_update)
    return cap if cap > 0 else 2**31 - 1


def schedule_grant(params, budgets, budget_carry):
    """Budget carry-over plus the optional burst cap: returns
    (budgets, granted, max_k)."""
    budgets = budgets + budget_carry
    cap = int(params.max_steps_per_update)
    if cap > 0:
        max_k = torch.clamp(budgets.max(), max=cap)
        granted = torch.minimum(budgets, max_k)
    else:
        max_k = budgets.max()
        granted = budgets
    return budgets, granted, max_k


def light_stats_vals(alive, gestation_time, generation, birth_update,
                     update_no):
    """(ave_gest, ave_gen, n_alive, births) over bare vectors."""
    has = alive & (gestation_time > 0)
    gd = has.sum().clamp(min=1).to(torch.float32)
    ave_gest = torch.where(has, gestation_time, 0).sum().to(
        torch.int32).to(torch.float32) / gd
    n_alive = alive.sum().to(torch.int32)
    n = n_alive.clamp(min=1).to(torch.float32)
    ave_gen = torch.where(alive, generation, 0).sum().to(
        torch.int32).to(torch.float32) / n
    births = (alive & (birth_update == update_no)).sum().to(torch.int32)
    return ave_gest, ave_gen, n_alive, births


def update_stats_from(vals, alive_before):
    """(births, deaths, dt, ave_gen, n_alive) from light_stats_vals."""
    ave_gest, ave_gen, n_alive, births = vals
    deaths = torch.clamp(alive_before + births - n_alive, min=0)
    dt = torch.where(ave_gest > 0, 1.0 / ave_gest.clamp(min=1e-9),
                     torch.zeros_like(ave_gest))
    return births, deaths, dt, ave_gen, n_alive


def light_stats(params, st, update_no):
    """(ave_gest, ave_gen, n_alive, births) of a canonical state."""
    return light_stats_vals(st.alive, st.gestation_time, st.generation,
                            st.birth_update, update_no)


def update_stats(params, st, alive_before, update_no):
    """(births, deaths, dt, ave_gen, n_alive) of a canonical state."""
    return update_stats_from(light_stats(params, st, update_no),
                             alive_before)


# ---- the per-update engine's phases, in update_step's order ----

def per_update_unported_reason(params) -> str | None:
    """Why the per-update engine cannot run `params` in this package
    (None = it can).  The cycle kernel's own gaps are
    cycles.unsupported_reason."""
    return birth_ops.canonical_unsupported_reason(params)


def resource_phase(params, st, key, update_no):
    """Resource dynamics, once an update (ops/resources.py): the global,
    spatial and deme pools' inflow and outflow, then the gradient pools
    under fold_in(key, 0x6AD) with the update's own key.  The identity
    for a world without pools."""
    if not res_ops.has_pools(params):
        return st
    st = st.replace(resources=res_ops.step_global(params, st.resources),
                    res_grid=res_ops.step_spatial(params, st.res_grid),
                    deme_resources=res_ops.step_deme(params,
                                                     st.deme_resources))
    return res_ops.step_gradient(params, st, prng.fold_in(key, 0x6AD),
                                 update_no)


def schedule_phase(params, st, k_budget):
    """Merit-proportional budgets plus carry and burst cap: returns
    (budgets, granted, max_k)."""
    budgets = scheduler.compute_budgets_from(params, st.alive, st.merit,
                                             k_budget)
    return schedule_grant(params, budgets, st.budget_carry)


def scheduler_probe(params, st, seed: int = 0):
    """The scheduler's grant re-sampled with a FIXED key, outside the run
    stream (the reference's scheduler_probe): read by the state
    auditor's dead-lane check (utils/audit.py), never by update_step."""
    return schedule_phase(params, st, prng.key(seed, st.device))


def perm_phase(params, st, granted, update_no):
    """Refresh the persistent lane permutation (st.lane_perm / lane_inv)
    that run_cycles packs by (kernel route only: on the micro-step engine
    the fields stay as they are, as in the reference).  K =
    TPU_LANE_PERM: K == 1 sorts by this update's granted budgets every
    update; K > 1 sorts by merit on
    update_no % K == 0, or earlier when the current permutation's block
    utilization falls under TPU_LANE_PERM_MIN_UTIL.  The sort is stable
    (budgets tie massively, and the order decides each organism's
    kernel lane, hence its random stream).  No host sync."""
    if not cycles.lane_perm_active(params, st):
        return st
    K = int(params.lane_perm_k)
    n = granted.shape[0]
    key_vec = granted if K == 1 else torch.where(st.alive, st.merit, -1.0)
    p = torch.argsort(key_vec, stable=True).to(torch.int32)
    inv = torch.empty_like(p)
    inv[p.long()] = torch.arange(n, dtype=torch.int32, device=p.device)
    if K > 1:
        block = cycles.dims(params, n, params.max_memory)[0]
        util = scheduler.block_utilization(granted[st.lane_perm.long()],
                                           block)
        refresh = (util < float(params.lane_perm_min_util)) \
            | bool(update_no % K == 0)
        p = torch.where(refresh, p, st.lane_perm)
        inv = torch.where(refresh, inv, st.lane_inv)
    return st.replace(lane_perm=p, lane_inv=inv)


def cycle_step_fn(params):
    """The hardware's micro-step and the derivation of its cycle draws:
    one dispatch shared by the solo cycle loop and the folded batch (the
    reference's _cycle_step_fn), so a hardware type routes both."""
    if is_smt(params):
        from avida_tpu_torch.ops import interpreter_smt as smt
        return smt.micro_step_smt, smt.draw_keys
    from avida_tpu_torch.ops import interpreter
    if params.max_cpu_threads > 1:
        return interpreter.micro_step_threads, interpreter.draw_keys_threads
    return interpreter.micro_step, interpreter.draw_keys


def materialize_offspring(params, st, pending_before):
    """End-of-update offspring extraction of the micro-step engine: each
    parent that divided this update gets its offspring's opcodes, from its
    split point on, in off_tape (the kernel writes them at the divide
    cycle).  A stalled parent's tape is frozen, so this reads the
    divide-time bytes."""
    from avida_tpu_torch.ops.interpreter import OP_MASK, barrel_shift_left
    new_div = st.divide_pending & ~pending_before
    L = st.tape.shape[1]
    ext = barrel_shift_left(st.tape & OP_MASK, st.off_start, L)
    cols = torch.arange(L, device=ext.device)[None, :]
    ext = torch.where(cols < st.off_len[:, None], ext, torch.zeros_like(ext))
    return st.replace(off_tape=torch.where(new_div[:, None], ext,
                                           st.off_tape))


def xla_cycles(params, st, k_steps, granted, max_k):
    """The micro-step engine's update (the reference's XLA while_loop):
    cycle s runs interpreter.micro_step on the organisms alive, granted
    more than s cycles and not waiting on a birth, keyed fold_in(k_steps,
    s), for s below max_k; then the offspring extraction.  `k_steps` is
    one key (int64[2]) or, for W worlds folded onto the organism axis,
    int64[W, 2] with max_k the largest of their trip counts (a world past
    its own grants runs masked, which is the identity).  The extraction
    is heads hardware's: TransSMT offspring wait in the host write
    buffer, and the experimental flush reads the tape itself."""
    pending_before = st.divide_pending
    st = run_micro_steps(params, st, k_steps, granted, max_k)
    if params.hw_type != 0:
        return st
    return materialize_offspring(params, st, pending_before)


# cycles whose bit draws are drawn together (bounds their memory: at
# 320x320, 32 cycles of four draws hold 105 MB)
_BITS_BLOCK = 32


def run_micro_steps(params, st, k_steps, granted, max_k):
    """xla_cycles' cycle loop, without the offspring extraction.  max_k
    is read to the host once, here; no cycle reads a value back.  Cycle
    s is keyed fold_in(k_steps, s); the draws of _BITS_BLOCK cycles are
    made at once."""
    from avida_tpu_torch.ops.interpreter import cycle_bits
    micro_step, draw_keys = cycle_step_fn(params)
    keys = k_steps.reshape(-1, 2)
    n = st.alive.shape[0]
    trips = int(max_k)
    for s0 in range(0, trips, _BITS_BLOCK):
        b = min(_BITS_BLOCK, trips - s0)
        # the block's cycle keys [b, W, 2] and their bit draws [D, b, n]
        ck = prng.fold_in_rows(keys, torch.arange(
            s0, s0 + b, device=keys.device)).transpose(0, 1)
        bits = cycle_bits(draw_keys, params, ck, n)
        for j in range(b):
            exec_mask = st.alive & (s0 + j < granted) & ~st.divide_pending
            st = micro_step(params, st, ck[j], exec_mask, bits[:, j])
    return st


def interpret_phase(params, st, k_steps, granted, cap, max_k=None):
    """The update's cycles on the routed engine: one kernel launch through
    run_cycles, or the micro-step engine (xla_cycles) for max_k cycles
    (by default the largest grant; granted is already capped)."""
    if cycles.use_kernel(params):
        return cycles.run_cycles(params, st, k_steps, granted, int(cap))
    if max_k is None:
        max_k = granted.max()
    return xla_cycles(params, st, k_steps, granted, max_k)


def bank_phase(params, st, budgets, executed0):
    """Bank unexecuted budget.  Returns (st, executed this update)."""
    executed_this = st.insts_executed - executed0
    carry = torch.clamp(budgets - executed_this, 0,
                        100 * params.ave_time_slice)
    st = st.replace(budget_carry=torch.where(st.alive, carry, 0).to(
        torch.int32))
    return st, executed_this.sum().to(torch.int32)


def point_mutation_sweep(params, st, key):
    """Per-site point mutations once per update (Avida2Driver.cc:146-155
    -> cHardwareBase::PointMutate cc:1087); flag bits are kept."""
    from avida_tpu_torch.ops.interpreter import random_inst
    n, L = st.tape.shape
    u = prng.uniform(key, (n, L))
    r = random_inst(params, prng.fold_in(key, 1), (n, L)).to(torch.uint8)
    in_genome = torch.arange(L, device=st.tape.device)[None, :] \
        < st.mem_len[:, None]
    hit = (u < torch.tensor(params.point_mut_prob, dtype=torch.float32)) \
        & in_genome & st.alive[:, None]
    mutated = (st.tape & 0xC0) | r
    return st.replace(tape=torch.where(hit, mutated, st.tape))


def birth_phase(params, st, k_birth, k_steps, update_no, neighbors=None):
    """The canonical birth flush (on the world's neighbor table), the
    demes' ageing (cDeme::IncAge), then the point-mutation sweep."""
    st = birth_ops.flush_births(params, st, k_birth, update_no, neighbors)
    if params.num_demes > 1:
        st = st.replace(deme_age=st.deme_age + 1)
    if params.point_mut_prob > 0:
        st = point_mutation_sweep(params, st,
                                  prng.fold_in(k_steps, 0x7FFFFFFF))
    return st


def update_step(params, st, key, update_no, neighbors=None):
    """One update of the per-update engine.  Returns (st',
    executed_this_update)."""
    ks = prng.split(key, 3)
    k_budget, k_steps, k_birth = ks[0], ks[1], ks[2]
    st = resource_phase(params, st, key, update_no)
    budgets, granted, max_k = schedule_phase(params, st, k_budget)
    st = perm_phase(params, st, granted, update_no)
    executed0 = st.insts_executed
    st = interpret_phase(params, st, k_steps, granted, static_cap(params),
                         max_k)
    st, executed = bank_phase(params, st, budgets, executed0)
    st = birth_phase(params, st, k_birth, k_steps, update_no, neighbors)
    return st, executed


def update_scan(params, st, chunk, run_key, u0, neighbors=None):
    """Run `chunk` consecutive updates from update u0.  The packed body
    (pack once, update, unpack once) when the configuration qualifies,
    else update_step per update; `neighbors` is the world's neighbor
    table (the per-update flush places through it; None builds the
    default-seed one).  Returns the new state and per-update
    vectors (executed, births, deaths, dt, ave_gen, n_alive), each of
    length `chunk`, on the state's device."""
    from avida_tpu_torch.ops import packed_chunk
    outs = []
    if not packed_chunk.active(params, st):
        for i in range(chunk):
            k = prng.fold_in(run_key, u0 + i)
            alive_before = st.alive.sum().to(torch.int32)
            st, executed = update_step(params, st, k, u0 + i, neighbors)
            outs.append((executed,) + update_stats(params, st, alive_before,
                                                   u0 + i))
        return st, tuple(torch.stack([o[j] for o in outs])
                         for j in range(6))
    pc = packed_chunk.pack_chunk(params, st)
    for i in range(chunk):
        k = prng.fold_in(run_key, u0 + i)
        alive_before = packed_chunk.alive_rows(pc.ivec).sum().to(torch.int32)
        pc, executed = packed_chunk.update_step_packed(params, pc, k, u0 + i)
        outs.append((executed,) + packed_chunk.stats_rows(
            pc, alive_before, u0 + i))
    cols = tuple(torch.stack([o[j] for o in outs]) for j in range(6))
    return packed_chunk.unpack_chunk(params, pc), cols


# ---- the multi-world batched update (parallel/multiworld.py) ----
#
# W static-equal worlds advance together.  The cheap phases (schedule,
# lane permutation, bank, birth flush, stats) run world by world on each
# world's own slice, keys and update number -- a loop over the members is
# this package's vmap -- and the update's cycles run once for the whole
# batch: ONE stacked kernel launch over all worlds' planes
# (cycles.run_packed_stacked), each world's blocks stopping at their own
# budgets, or the micro-step engine over the worlds' organisms folded onto
# one axis (mw_fold_cycles_xla), each world drawing from its own key.
# World w of a batch is its solo run with its own seed, bit for bit.


def mw_pre_phase(params, st, key, update_no):
    """One world's pre-cycle phases, exactly update_step's prologue: key
    split, resources, schedule, lane permutation.  Returns (st, (budgets,
    granted, max_k, k_steps, k_birth))."""
    ks = prng.split(key, 3)
    st = resource_phase(params, st, key, update_no)
    budgets, granted, max_k = schedule_phase(params, st, ks[0])
    st = perm_phase(params, st, granted, update_no)
    return st, (budgets, granted, max_k, ks[1], ks[2])


def mw_pack(params, sts, granted):
    """Each world packed in its own lane order with its own grant row,
    the W planes concatenated world-major on the lane axis: the stacked
    launch's planes ([rows, W * n_pad])."""
    quads = [cycles.pack_state(params, st, g, cycles.lane_order(params,
                                                                st)[0])
             for st, g in zip(sts, granted)]
    return tuple(torch.cat([q[j] for q in quads], dim=1) for j in range(4))


def mw_unpack(params, sts, flat):
    """Each world unpacked from its own slice of the stacked planes with
    its own inverse lane order.  Returns the W new states."""
    n_pad = flat[0].shape[1] // len(sts)
    return [cycles.unpack_state(
        params, st, tuple(p[:, w * n_pad:(w + 1) * n_pad] for p in flat),
        cycles.lane_order(params, st)[1]) for w, st in enumerate(sts)]


def mw_stack_kernel_cycles(params, sts, k_steps, granted, cap):
    """The update's cycles for W worlds in one launch: mw_pack, one
    stacked launch seeded per world, mw_unpack."""
    if not cycles.use_kernel(params):
        raise ValueError(
            "mw_stack_kernel_cycles: this configuration's cycles run on "
            "the micro-step engine (mw_fold_cycles_xla), not the kernel")
    flat = mw_pack(params, sts, granted)
    B = cycles.dims(params, sts[0].tape.shape[0], params.max_memory)[0]
    cycles.run_packed_stacked(params, flat, cycles.world_seed_bases(k_steps),
                              cap, B)
    return mw_unpack(params, sts, flat)


def fold_lanes(sts):
    """W same-shaped worlds -> one state whose per-organism fields hold
    the worlds' organisms world-major on the organism axis (world-level
    fields are world 0's; the micro-step engine reads none of them)."""
    from avida_tpu_torch.core.state import LANE_FIELDS
    if len(sts) == 1:
        return sts[0]
    return sts[0].replace(**{name: torch.cat([getattr(st, name)
                                              for st in sts])
                             for name in LANE_FIELDS})


def unfold_lanes(sts, folded):
    """fold_lanes' inverse: each world's organisms back into its own
    state (views of the folded fields)."""
    from avida_tpu_torch.core.state import LANE_FIELDS
    if len(sts) == 1:
        return [folded]
    n = sts[0].alive.shape[0]
    return [st.replace(**{name: getattr(folded, name)[w * n:(w + 1) * n]
                          for name in LANE_FIELDS})
            for w, st in enumerate(sts)]


def mw_fold_cycles_xla(params, sts, k_steps, granted, max_k):
    """The update's cycles for W worlds on the micro-step engine (the
    reference's _mw_fold_cycles_xla): the worlds' organisms folded onto
    one axis, one micro_step a cycle for the whole batch with each
    world's draws from fold_in(its k_steps, s), up to the batch's largest
    trip count.  A world past its own trip count runs masked, the
    identity, so each world computes its solo update."""
    folded = xla_cycles(params, fold_lanes(sts),
                        torch.stack(list(k_steps)), torch.cat(list(granted)),
                        torch.stack(list(max_k)).max())
    return unfold_lanes(sts, folded)


def batched_update_step(params, sts, keys, update_no, neighbors=None):
    """One update of W worlds (update_step's phase order, the cycles run
    once for the batch on the routed engine); `sts`, `keys` and `update_no` hold one entry per
    world.  Returns (sts', executed[W], trips[W]), trips being each
    world's own trip count max_k."""
    pre = [mw_pre_phase(params, st, k, u)
           for st, k, u in zip(sts, keys, update_no)]
    sts = [p[0] for p in pre]
    budgets, granted, max_k, k_steps, k_birth = zip(*[p[1] for p in pre])
    executed0 = [st.insts_executed for st in sts]
    if cycles.use_kernel(params):
        sts = mw_stack_kernel_cycles(params, sts, k_steps, granted,
                                     static_cap(params))
    else:
        sts = mw_fold_cycles_xla(params, sts, k_steps, granted, max_k)
    out, executed = [], []
    for w, st in enumerate(sts):
        st, ex = bank_phase(params, st, budgets[w], executed0[w])
        out.append(birth_phase(params, st, k_birth[w], k_steps[w],
                               update_no[w], neighbors))
        executed.append(ex)
    trips = torch.stack([m.to(torch.int32) for m in max_k])
    return out, torch.stack(executed), trips


def world_updates(u0, W: int) -> list:
    """A scalar update number (an aligned batch) or W of them (one per
    world) -> W Python ints."""
    if isinstance(u0, int) or torch.as_tensor(u0).dim() == 0:
        return [int(u0)] * W
    u = [int(x) for x in u0]
    if len(u) != W:
        raise ValueError(f"{len(u)} update numbers for {W} worlds")
    return u


def update_scan_batched(params, bst, chunk, run_keys, u0, neighbors=None):
    """Run `chunk` updates of W stacked worlds (the engine behind
    parallel/multiworld.multiworld_scan).  `bst` is a batched state
    (core/state.stack_states), `run_keys` the [W, 2] stacked run keys, u0
    a scalar update number or a [W] vector of them; each world's update
    keys are fold_in(run_key_w, own update).  Routing mirrors update_scan:
    the stacked packed-resident chunk (pack once, one stacked launch per
    update, unpack once) when the configuration qualifies, else
    batched_update_step per update.  Returns (bst', outs): update_scan's
    six per-update vectors plus trips, each [W, chunk]."""
    from avida_tpu_torch.ops import packed_chunk
    W = bst.alive.shape[0]
    u0 = world_updates(u0, W)
    outs = []
    if packed_chunk.batch_active(params, bst):
        pw = packed_chunk.pack_worlds(params, bst)
        for i in range(chunk):
            un = [u + i for u in u0]
            keys = [prng.fold_in(run_keys[w], un[w]) for w in range(W)]
            alive_before = packed_chunk.alive_rows(pw.ivec).sum(dim=1).to(
                torch.int32)
            pw, executed, trips = packed_chunk.update_step_packed_worlds(
                params, pw, keys, un)
            outs.append((executed,) + packed_chunk.stats_rows_worlds(
                pw, alive_before, un) + (trips,))
        bst = packed_chunk.unpack_worlds(params, pw)
    else:
        sts = unstack_states(bst)
        for i in range(chunk):
            un = [u + i for u in u0]
            keys = [prng.fold_in(run_keys[w], un[w]) for w in range(W)]
            alive_before = [st.alive.sum().to(torch.int32) for st in sts]
            sts, executed, trips = batched_update_step(params, sts, keys, un,
                                                       neighbors)
            cols = [update_stats(params, st, ab, u)
                    for st, ab, u in zip(sts, alive_before, un)]
            outs.append((executed,) + tuple(
                torch.stack([c[j] for c in cols]) for j in range(5))
                + (trips,))
        bst = stack_states(sts)
    return bst, tuple(torch.stack([o[j] for o in outs], dim=1)
                      for j in range(7))


def summarize(params, st, update_no=-1):
    """The population reductions the .dat writers read (ref
    cPopulation::UpdateOrganismStats cc:5847); `update_no` is the most
    recently completed update."""
    alive = st.alive
    n_alive = alive.sum()
    denom = n_alive.clamp(min=1).to(torch.float32)

    def avg(x):
        return prng.xla_f32_sum(
            torch.where(alive, x.to(torch.float32), 0.0)) / denom

    gest = torch.where(alive, st.gestation_time, 0)
    has_gest = alive & (st.gestation_time > 0)
    gest_denom = has_gest.sum().clamp(min=1).to(torch.float32)
    repro = torch.where(
        has_gest,
        1.0 / st.gestation_time.clamp(min=1).to(torch.float32), 0.0)
    return {
        "num_organisms": n_alive,
        "ave_merit": avg(st.merit),
        "ave_fitness": avg(st.fitness),
        "ave_gestation": torch.where(has_gest, gest, 0).sum().to(
            torch.int32).to(torch.float32) / gest_denom,
        "ave_repro_rate": prng.xla_f32_sum(repro) / gest_denom,
        "ave_genome_len": avg(st.genome_len),
        "ave_copied_size": avg(st.copied_size),
        "ave_executed_size": avg(st.executed_size),
        "ave_generation": avg(st.generation),
        "ave_age": avg(st.time_used),
        "max_fitness": torch.where(alive, st.fitness, 0.0).max(),
        "births_this_update": (alive & (update_no >= 0)
                               & (st.birth_update == update_no)).sum(),
        "num_breed_true": (alive & st.breed_true).sum(),
        "num_no_birth": (alive & (st.num_divides == 0)).sum(),
        "task_counts": (alive[:, None] & (st.last_task_count > 0)).sum(dim=0),
        # lifetime per-cell totals, dead cells included: tasks_exe.dat
        # diffs consecutive rows on the host
        "task_exe_totals": st.task_exe_total.sum(dim=0),
    }
