"""The update loop and its per-update statistics.

Counterpart of avida_tpu/ops/update.py.  `update_scan` runs a chunk of
updates as a Python loop, each update keyed fold_in(run_key, update_no)
exactly as the reference's lax.scan is, so a trajectory does not depend on
how the driver chunks the run.  It picks one of two bodies, as the
reference does:

  packed     the population stays in the kernel's plane layout for the
             whole chunk (ops/packed_chunk.py)
  per-update `update_step` on the canonical PopulationState: resources ->
             schedule -> lane permutation -> run_cycles (pack, kernel,
             unpack) -> bank -> birth flush (+ point mutations); the
             engine behind systematics (TPU_SYSTEMATICS=1), whose newborn
             ring the canonical flush fills

`update_scan_batched` is the same for W stacked worlds, with one kernel
launch per update for the whole batch.
"""

from __future__ import annotations

import torch

from avida_tpu_torch.core.state import stack_states, unstack_states
from avida_tpu_torch.ops import birth as birth_ops
from avida_tpu_torch.ops import cycles
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

_RESOURCES_UNPORTED = "resource pools (ROADMAP.md Queue 1 item 12)"


def _has_resource_pools(params) -> bool:
    return bool(params.num_global_res or params.num_spatial_res
                or params.num_deme_res or any(params.sres_grad_height))


def per_update_unported_reason(params) -> str | None:
    """Why the per-update engine cannot run `params` in this package
    (None = it can).  The cycle kernel's own gaps are
    cycles.unsupported_reason."""
    if _has_resource_pools(params):
        return _RESOURCES_UNPORTED
    return birth_ops.canonical_unsupported_reason(params)


def resource_phase(params, st, key, update_no):
    """Resource dynamics: the identity for a world without resource
    pools, the only kind this package runs."""
    if _has_resource_pools(params):
        raise NotImplementedError(
            f"resource_phase: {_RESOURCES_UNPORTED} are not ported to "
            f"avida_tpu_torch")
    return st


def schedule_phase(params, st, k_budget):
    """Merit-proportional budgets plus carry and burst cap: returns
    (budgets, granted, max_k)."""
    budgets = scheduler.compute_budgets_from(params, st.alive, st.merit,
                                             k_budget)
    return schedule_grant(params, budgets, st.budget_carry)


def perm_phase(params, st, granted, update_no):
    """Refresh the persistent lane permutation (st.lane_perm / lane_inv)
    that run_cycles packs by.  K = TPU_LANE_PERM: K == 1 sorts by this
    update's granted budgets every update; K > 1 sorts by merit on
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


def interpret_phase(params, st, k_steps, granted, cap):
    """The update's cycles: one kernel launch through run_cycles."""
    return cycles.run_cycles(params, st, k_steps, granted, int(cap))


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


def birth_phase(params, st, k_birth, k_steps, update_no):
    """The canonical birth flush, then the point-mutation sweep."""
    st = birth_ops.flush_births(params, st, k_birth, update_no)
    if params.point_mut_prob > 0:
        st = point_mutation_sweep(params, st,
                                  prng.fold_in(k_steps, 0x7FFFFFFF))
    return st


def update_step(params, st, key, update_no):
    """One update of the per-update engine.  Returns (st',
    executed_this_update)."""
    ks = prng.split(key, 3)
    k_budget, k_steps, k_birth = ks[0], ks[1], ks[2]
    st = resource_phase(params, st, key, update_no)
    budgets, granted, _ = schedule_phase(params, st, k_budget)
    st = perm_phase(params, st, granted, update_no)
    executed0 = st.insts_executed
    st = interpret_phase(params, st, k_steps, granted, static_cap(params))
    st, executed = bank_phase(params, st, budgets, executed0)
    st = birth_phase(params, st, k_birth, k_steps, update_no)
    return st, executed


def update_scan(params, st, chunk, run_key, u0):
    """Run `chunk` consecutive updates from update u0.  The packed body
    (pack once, update, unpack once) when the configuration qualifies,
    else update_step per update.  Returns the new state and per-update
    vectors (executed, births, deaths, dt, ave_gen, n_alive), each of
    length `chunk`, on the state's device."""
    from avida_tpu_torch.ops import packed_chunk
    outs = []
    if not packed_chunk.active(params, st):
        for i in range(chunk):
            k = prng.fold_in(run_key, u0 + i)
            alive_before = st.alive.sum().to(torch.int32)
            st, executed = update_step(params, st, k, u0 + i)
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
# this package's vmap -- and the update's cycles run as ONE stacked
# kernel launch over all worlds' planes (cycles.run_packed_stacked), so
# each world's blocks stop at their own budgets.  World w of a batch is
# its solo run with its own seed, bit for bit.

_XLA_FOLD_UNPORTED = ("the XLA fold engine (update._mw_fold_cycles_xla, "
                      "TPU_USE_PALLAS=2; ROADMAP.md Queue 1 item 10)")


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
    if int(params.use_pallas) == 2:
        raise NotImplementedError(
            f"{_XLA_FOLD_UNPORTED} is not ported to avida_tpu_torch")
    flat = mw_pack(params, sts, granted)
    B = cycles.dims(params, sts[0].tape.shape[0], params.max_memory)[0]
    cycles.run_packed_stacked(params, flat, cycles.world_seed_bases(k_steps),
                              cap, B)
    return mw_unpack(params, sts, flat)


def batched_update_step(params, sts, keys, update_no):
    """One update of W worlds (update_step's phase order, the cycles as
    one stacked launch); `sts`, `keys` and `update_no` hold one entry per
    world.  Returns (sts', executed[W], trips[W]), trips being each
    world's own trip count max_k."""
    pre = [mw_pre_phase(params, st, k, u)
           for st, k, u in zip(sts, keys, update_no)]
    sts = [p[0] for p in pre]
    budgets, granted, max_k, k_steps, k_birth = zip(*[p[1] for p in pre])
    executed0 = [st.insts_executed for st in sts]
    sts = mw_stack_kernel_cycles(params, sts, k_steps, granted,
                                 static_cap(params))
    out, executed = [], []
    for w, st in enumerate(sts):
        st, ex = bank_phase(params, st, budgets[w], executed0[w])
        out.append(birth_phase(params, st, k_birth[w], k_steps[w],
                               update_no[w]))
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


def update_scan_batched(params, bst, chunk, run_keys, u0):
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
            sts, executed, trips = batched_update_step(params, sts, keys, un)
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
        "births_this_update": (alive & (update_no >= 0)
                               & (st.birth_update == update_no)).sum(),
        "num_breed_true": (alive & st.breed_true).sum(),
        "num_no_birth": (alive & (st.num_divides == 0)).sum(),
        "task_counts": (alive[:, None] & (st.last_task_count > 0)).sum(dim=0),
    }
