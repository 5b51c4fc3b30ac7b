"""Demes: group structure, competition, replication, germlines.

Counterpart of avida_tpu/ops/demes.py (cDeme, cDeme.h:52;
cPopulation::CompeteDemes, ReplicateDemes / ReplaceDeme; germlines,
cGermline.h:31).  Demes are contiguous cell bands -- deme d owns cells
[d*C, (d+1)*C) with C = num_cells // num_demes -- so a per-deme reduction
is a reshape to [D, C] and a reduction over the band, and replacing a
deme is a gather of whole bands.  Organisms copied into a deme follow
InjectClone (cPopulation.cc:7377): same genome and merit, fresh hardware
and lifetime state.

The actions run between updates, outside the update's program, so their
float arithmetic is the reference's op-by-op (eager) arithmetic: band
totals in prng.xla_f32_sum's order, `jnp.cumsum` as prng.xla_cumsum,
`jax.random.choice` as prng.choice.
"""

from __future__ import annotations

import torch

from avida_tpu_torch.core.state import (is_smt, make_cell_inputs,
                                        smt_base_spaces)
from avida_tpu_torch.utils import prng

# ReplicateDemes triggers (cPopulation::ReplicateDemes switch order)
(TRIGGER_ALL, TRIGGER_FULL, TRIGGER_CORNERS, TRIGGER_AGE, TRIGGER_BIRTHS,
 TRIGGER_PREDICATE) = range(6)

# The per-cell fields a freshly (re)seeded organism zeroes or clears:
# deme replacement, germline seeding and InjectAll share these lists.
ZERO_FIELDS = (
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
FALSE_FIELDS = ("mal_active", "breed_true", "divide_pending", "off_sex",
                "parasite_active", "inject_pending", "sterile")


def cells_per_deme(params) -> int:
    n, d = params.num_cells, params.num_demes
    if n % d:
        raise ValueError(f"num_cells {n} not divisible by NUM_DEMES {d}")
    return n // d


def deme_of_cells(params, device) -> torch.Tensor:
    """int64[N]: the deme of every cell."""
    return torch.arange(params.num_cells, device=device) \
        // cells_per_deme(params)


def _deme_mean(params, alive, x):
    """Per-deme mean of x over the living organisms -> (f32[D], count)."""
    D, C = params.num_demes, cells_per_deme(params)
    xa = torch.where(alive, x.to(torch.float32), 0.0).reshape(D, C)
    cnt = alive.reshape(D, C).sum(dim=1)
    return prng.xla_f32_sum(xa.T) / cnt.clamp(min=1).to(torch.float32), cnt


def deme_fitness(params, st, competition_type):
    """f32[D] deme fitness (cPopulation::CompeteDemes, competition_type
    0-6: 0 and 3 constant, 1 births, 2 and 5 mean fitness, 4 and 6 the
    rank's 2^-rank)."""
    D = params.num_demes
    dev = st.alive.device
    if competition_type in (0, 3):
        return torch.ones(D, dtype=torch.float32, device=dev)
    if competition_type == 1:
        return st.deme_birth_count.to(torch.float32)
    if competition_type in (2, 4, 5, 6):
        mean, _ = _deme_mean(params, st.alive, st.fitness)
        if competition_type in (2, 5):
            return mean
        rank = 1 + (mean[:, None] < mean[None, :]).sum(dim=1)
        return prng.xla_exp2(-rank.to(torch.float32))
    raise NotImplementedError(
        f"CompeteDemes competition_type {competition_type}")


def _sel(mask, ndim):
    """mask [N] shaped to broadcast over a field of `ndim` dimensions."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def clone_reset(params, st, sel_cells, genome, genome_len, alive, merit,
                key):
    """Field updates installing genome / merit at sel_cells with fresh
    hardware and lifetime state (InjectClone / SetupClone,
    cPopulation.cc:7377).  Returns the updates for st.replace."""
    n = st.tape.shape[0]
    if params.death_method == 2:
        max_exec = params.age_limit * genome_len
    elif params.death_method == 1:
        max_exec = torch.full_like(genome_len, params.age_limit)
    else:
        max_exec = torch.full_like(genome_len, 2**30)
    fresh = {
        "genome": genome, "genome_len": genome_len, "alive": alive,
        "merit": merit, "tape": genome.to(torch.uint8) & 0x3F,
        "mem_len": genome_len, "executed_size": genome_len,
        "copied_size": genome_len, "max_executed": max_exec,
    }
    updates = {}
    for name, val in fresh.items():
        dst = getattr(st, name)
        updates[name] = torch.where(_sel(sel_cells, dst.dim()),
                                    val.to(dst.dtype), dst)
    for name in ZERO_FIELDS:
        dst = getattr(st, name)
        updates[name] = torch.where(_sel(sel_cells, dst.dim()),
                                    torch.zeros_like(dst), dst)
    for name in FALSE_FIELDS:
        updates[name] = torch.where(sel_cells, False, getattr(st, name))
    updates["cur_bonus"] = torch.where(
        sel_cells, prng.round_f32(params.default_bonus), st.cur_bonus)
    for name in ("genotype_id", "parent_id", "birth_update"):
        updates[name] = torch.where(sel_cells, -1, getattr(st, name))
    updates["inputs"] = torch.where(sel_cells[:, None],
                                    make_cell_inputs(key, n), st.inputs)
    if is_smt(params):
        # fresh SMT threads: host heads in space 0, parasite heads in 2
        updates["smt_head_space"] = torch.where(
            _sel(sel_cells, 3), smt_base_spaces(st.device)[None],
            st.smt_head_space)
    return updates


def _replace_blocks(params, st, src, replaced, key):
    """Deme d's band becomes an InjectClone copy of deme src[d]'s band
    where replaced[d]; the other demes keep their state.  Genome and
    merit are copied, hardware and lifetime state start fresh, the
    last-gestation history (gestation time, fitness, generation) comes
    along."""
    D, C = params.num_demes, cells_per_deme(params)
    srcl = src.long()

    def blk_gather(x):
        b = x.reshape((D, C) + x.shape[1:])
        g = b[srcl]
        return torch.where(_sel(replaced, g.dim()), g, b).reshape(x.shape)

    rep_cells = replaced[deme_of_cells(params, st.alive.device)]
    updates = clone_reset(params, st, rep_cells, blk_gather(st.genome),
                          blk_gather(st.genome_len), blk_gather(st.alive),
                          blk_gather(st.merit), key)
    for name in ("gestation_time", "fitness", "generation"):
        updates[name] = torch.where(rep_cells, blk_gather(getattr(st, name)),
                                    getattr(st, name))
    return st.replace(**updates)


def compete_demes(params, st, key, competition_type):
    """Fitness-proportional deme selection and wholesale replacement
    (cPopulation::CompeteDemes: a roulette draw per deme slot, then the
    copy); germlines follow their deme, and every deme's counters
    reset."""
    D = params.num_demes
    dev = st.alive.device
    ks = prng.split(key)
    k_pick, k_inputs = ks[0], ks[1]
    fit = deme_fitness(params, st, competition_type)
    total = prng.xla_f32_sum(fit)
    p = torch.where(total > 0, fit / total.clamp(min=1e-30),
                    prng.round_f32(1.0 / D))
    src = prng.choice(k_pick, D, (D,), p)
    replaced = src != torch.arange(D, dtype=torch.int32, device=dev)
    st = _replace_blocks(params, st, src, replaced, k_inputs)
    if params.demes_use_germline:
        srcl = src.long()
        st = st.replace(
            germ_mem=torch.where(replaced[:, None], st.germ_mem[srcl],
                                 st.germ_mem),
            germ_len=torch.where(replaced, st.germ_len[srcl], st.germ_len))
    zeros = torch.zeros(D, dtype=torch.int32, device=dev)
    return st.replace(deme_birth_count=zeros, deme_age=zeros.clone())


def _mutate_germline(params, germ_mem, germ_len, key):
    """Per-site germline copy mutations (GERMLINE_COPY_MUT, ReplaceDeme's
    germline mutation step)."""
    from avida_tpu_torch.ops.interpreter import random_inst
    D, L = germ_mem.shape
    u = prng.uniform(key, (D, L))
    r = random_inst(params, prng.fold_in(key, 1), (D, L)).to(torch.int8)
    in_g = torch.arange(L, device=germ_mem.device)[None, :] \
        < germ_len[:, None]
    hit = (u < prng.round_f32(params.germline_copy_mut)) & in_g
    return torch.where(hit, r, germ_mem)


def replicate_triggers(params, st, rep_trigger, predicates=()):
    """bool[D]: the demes ReplicateDemes `rep_trigger` fires for: 0 every
    non-empty deme, 1 full, 2 both corner cells occupied, 3 age >=
    DEMES_MAX_AGE, 4 births >= DEMES_MAX_BIRTHS, 5 a non-empty deme one
    of whose (resource, op, value) predicates holds
    (cDemeResourceThresholdPredicate, evaluated at event time)."""
    D, C = params.num_demes, cells_per_deme(params)
    occ = st.alive.reshape(D, C)
    cnt = occ.sum(dim=1)
    if rep_trigger == TRIGGER_ALL:
        return cnt > 0
    if rep_trigger == TRIGGER_FULL:
        return cnt == C
    if rep_trigger == TRIGGER_CORNERS:
        return occ[:, 0] & occ[:, C - 1]
    if rep_trigger == TRIGGER_AGE:
        return st.deme_age >= params.demes_max_age
    if rep_trigger == TRIGGER_BIRTHS:
        return st.deme_birth_count >= params.demes_max_births
    if rep_trigger == TRIGGER_PREDICATE:
        if not predicates:
            raise ValueError(
                "ReplicateDemes sat-deme-predicate needs at least one "
                "Pred_DemeResourceThresholdPredicate event first")
        trig = torch.zeros(D, dtype=torch.bool, device=occ.device)
        for res_idx, op, value in predicates:
            lvl = st.deme_resources[:, res_idx]
            if op == ">=":
                trig = trig | (lvl >= prng.round_f32(value))
            elif op == "<=":
                trig = trig | (lvl <= prng.round_f32(value))
            else:
                raise ValueError(f"predicate operator {op!r} (>=, <=)")
        return trig & (cnt > 0)
    raise NotImplementedError(f"ReplicateDemes trigger {rep_trigger}")


def replicate_demes(params, st, key, rep_trigger, predicates=()):
    """Replicate the triggered demes into random other demes
    (cPopulation::ReplicateDemes -> ReplicateDeme -> ReplaceDeme).  Each
    triggered source picks a random other deme; where several claim one
    target the lowest source wins.  With germlines the target is cleared
    and seeded at its center cell with a mutated copy of the source's
    germline, which becomes both demes' germline; without, the target
    becomes an InjectClone copy of the source.  The counters of every
    deme that fired or was replaced reset."""
    D = params.num_demes
    dev = st.alive.device
    ks = prng.split(key, 4)
    k_t, k_m, k_inputs = ks[0], ks[1], ks[2]
    trig = replicate_triggers(params, st, rep_trigger, predicates)
    demes = torch.arange(D, dtype=torch.int32, device=dev)
    off = prng.randint(k_t, (D,), 1, max(D, 2))
    tgt = (demes + off) % D
    BIG = 2**30
    # scatter-min of each triggered source onto its target; untriggered
    # sources scatter to slot D, which is dropped
    claim = torch.full((D + 1,), BIG, dtype=torch.int32, device=dev)
    claim = claim.scatter_reduce(0, torch.where(trig, tgt, D).long(),
                                 torch.where(trig, demes, BIG), "amin")[:D]
    replaced = claim < BIG
    src = claim.clamp(0, D - 1)
    srcl = src.long()

    if params.demes_use_germline:
        germ = _mutate_germline(params, st.germ_mem[srcl],
                                st.germ_len[srcl], k_m)
        st = _clear_and_seed(params, st, replaced, germ, st.germ_len[srcl],
                             k_inputs)
        # the mutated germline goes to the source too: back[s] = the
        # target s replicated into (each source claims at most one)
        src_updated = torch.zeros(D, dtype=torch.bool, device=dev)
        back = torch.zeros(D, dtype=torch.int64, device=dev)
        src_updated[srcl[replaced]] = True
        back[srcl[replaced]] = demes.long()[replaced]
        germ_of = torch.where(replaced[:, None], germ,
                              torch.where(src_updated[:, None], germ[back],
                                          st.germ_mem))
        len_src = st.germ_len[srcl]
        len_of = torch.where(replaced, len_src,
                             torch.where(src_updated, len_src[back],
                                         st.germ_len))
        st = st.replace(germ_mem=germ_of, germ_len=len_of)
    else:
        st = _replace_blocks(params, st, src, replaced, k_inputs)

    fired = trig | replaced
    return st.replace(
        deme_birth_count=torch.where(fired, 0, st.deme_birth_count),
        deme_age=torch.where(fired, 0, st.deme_age))


def _clear_and_seed(params, st, replaced, seed_mem, seed_len, key):
    """Kill every organism of the replaced demes and inject each one's
    seed genome at its center cell (germline seeding: ReplaceDeme +
    SeedDeme); the band's gestation history starts at zero."""
    n = st.tape.shape[0]
    C = cells_per_deme(params)
    dev = st.alive.device
    d_of = deme_of_cells(params, dev)
    rep_cells = replaced[d_of]
    seed_cell = rep_cells & ((torch.arange(n, device=dev) % C) == C // 2)
    seed_length = seed_len[d_of]
    updates = clone_reset(params, st, rep_cells, seed_mem[d_of],
                          seed_length, seed_cell,
                          seed_length.to(st.merit.dtype), key)
    for name in ("gestation_time", "fitness", "generation"):
        dst = getattr(st, name)
        updates[name] = torch.where(rep_cells, torch.zeros_like(dst), dst)
    return st.replace(**updates)
