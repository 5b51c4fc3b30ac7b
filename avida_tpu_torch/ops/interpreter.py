"""The lockstep micro-step interpreter and its helpers.

Counterpart of avida_tpu/ops/interpreter.py: `random_inst`, `pack_tape`,
the canonical `extract_offspring` (the deferred half of h-divide plus the
divide mutations), and `micro_step`, the XLA cycle engine's one CPU cycle
for every organism at once (heads hardware, one thread).  Every opcode's
effect is computed as masked tensor operations over the whole population
and merged; organisms at different opcodes are lanes of the same program.
ops/update.py drives it cycle by cycle when the cycle kernel
(ops/cycles.py) is not the configuration's route.

The reference reads single tape sites with masked [N, L] reductions (a TPU
has no cheap per-lane gather); here they are gathers, with the same edge
cases: the byte after IP reads 0 past the tape's end, the next opcode wraps
to column 0 at the last memory site, the search takes the first match.
The blocks the reference runs under an any-lane `lax.cond` (the label
search, the IO and task pipeline) run unconditionally: their results on
lanes that do not want them are unused or the identity, so no cycle reads
a flag back to the host.  Integer state stays int32 with the reference's
wraparound.

The IO block carries the resource pools (global, spatial, deme) through
tasks.apply_reactions when a reaction binds or produces into one.

Experimental spatial hardware (hw_type 3: 8 registers, facing, movement,
look-ahead, predation) runs through the same micro_step, its spatial
instructions in _exp_spatial and the kills and moves applied after the
cycle's state merge (_apply_attacks, _apply_moves).
"""

from __future__ import annotations

import torch

from avida_tpu_torch.core.state import is_smt
from avida_tpu_torch.models.heads import (
    HEAD_FLOW, HEAD_IP, HEAD_READ, HEAD_WRITE, MAX_LABEL_SIZE,
    MOD_HEAD, MOD_LABEL, MOD_NONE, MOD_REG,
    SEM_ADD, SEM_DEC, SEM_GET_HEAD, SEM_H_ALLOC, SEM_H_COPY, SEM_H_DIVIDE,
    SEM_FORK_TH, SEM_H_DIVIDE_SEX, SEM_H_SEARCH, SEM_ID_TH, SEM_IF_LABEL,
    SEM_IF_LESS, SEM_IF_MATE_FEMALE, SEM_IF_MATE_MALE, SEM_IF_N_EQU,
    SEM_INC, SEM_IO, SEM_JMP_HEAD, SEM_KILL_TH, SEM_MOV_HEAD, SEM_NAND,
    SEM_POP, SEM_PUSH, SEM_SET_FLOW, SEM_SET_MATE_FEMALE, SEM_SET_MATE_JUV,
    SEM_SET_MATE_MALE, SEM_SHIFT_L, SEM_SHIFT_R, SEM_SUB, SEM_SWAP,
    SEM_SWAP_STK,
)
from avida_tpu_torch.models.experimental import SEM_IF_EQU_0, SEM_IF_NOT_0
from avida_tpu_torch.ops import resources as res_ops
from avida_tpu_torch.ops import tasks as tasks_ops
from avida_tpu_torch.ops.cycles import params_cached, uniform_mutation
from avida_tpu_torch.utils import prng

OP_MASK = 0x3F                 # bits 0-5 of a tape byte: the opcode
EXEC_BIT = 0x40                # bit 6: executed flag
COPIED_BIT = 0x80              # bit 7: copied flag


def random_inst(params, key, shape):
    """Redundancy-weighted random instruction draw (cInstSet::GetRandomInst,
    cpu/cInstSet.h:52): inverse-CDF over the per-opcode mutation weights;
    uniform sets short-circuit to randint."""
    if uniform_mutation(params):
        return prng.randint(key, shape, 0, params.num_insts)
    return _inverse_cdf(prng.uniform(key, shape),
                        _cdf_thresholds(params))


def _cdf_thresholds(params):
    """The cumulative mutation weights below the last opcode, as float32
    scalars (the draws are compared with them in float32)."""
    return [torch.tensor(c, dtype=torch.float32)
            for c in params.mut_cdf[:params.num_insts - 1]]


def _inverse_cdf(u, thresholds):
    """The opcode of each uniform draw: how many thresholds it reaches."""
    op = torch.zeros_like(u, dtype=torch.int32)
    for c in thresholds:
        op = op + (u >= c).to(torch.int32)
    return op


def draw_keys(params, keys):
    """The keys of a cycle's draws, for cycle keys int64[K, 2]: int64[D, K,
    2], in order the copy-mutation uniform, the random instruction's draws
    (randint's two bit draws, or one uniform for a weighted set) and the
    prob-fail uniform -- those the configuration reads (D may be 0).  The
    derivations are the reference's: split(key) -> (k_mut, k_in1), randint
    splits k_in1 again, prob-fail draws from fold_in(key, 0xFA11)."""
    parts = []
    if params.copy_mut_prob > 0:
        ks = prng.split_rows(keys)
        parts.append(ks[:, 0])
        if uniform_mutation(params):
            k12 = prng.split_rows(ks[:, 1])
            parts += [k12[:, 0], k12[:, 1]]
        else:
            parts.append(ks[:, 1])
    if params.inst_prob_fail:
        parts.append(prng.fold_in_rows(keys, 0xFA11))
    if not parts:
        return keys.new_zeros((0,) + tuple(keys.shape))
    return torch.stack(parts)


def pack_tape(ops):
    """Opcode array (int8) -> packed tape (uint8, flags clear)."""
    return ops.to(torch.uint8) & OP_MASK


def tape_ops(tape):
    return (tape & OP_MASK).to(torch.int32)


def _adjust(pos, mlen):
    """Head adjustment (cHeadCPU::fullAdjust, cHeadCPU.cc:28): negative
    positions clamp to 0, positions past memory wrap modulo its size."""
    mlen = mlen.clamp(min=1)
    return torch.where(pos < 0, 0, pos % mlen)


def _at(plane, idx):
    """plane[n, idx[n]] for every row n."""
    return plane.gather(1, idx.long()[:, None])[:, 0]


def _put(plane, idx, val):
    """plane[n, idx[n]] = val[n] for every row n, in place."""
    plane.scatter_(1, idx.long()[:, None], val[:, None])


def barrel_shift_left(plane, shift, L):
    """Per-row shift: out[n, q] = plane[n, q + shift[n]], zero past the end.
    The reference composes log2(L) static zero-filling shifts, one per bit
    of `shift` below that width; the same bits give the same result."""
    nbits = max(int(L - 1).bit_length(), 0) if L > 1 else 0
    s = (shift & ((1 << nbits) - 1)).long() if nbits else \
        torch.zeros_like(shift, dtype=torch.int64)
    q = torch.arange(plane.shape[1], device=plane.device)[None, :]
    src = q + s[:, None]
    inside = src < plane.shape[1]
    out = plane.gather(1, torch.where(inside, src, 0))
    return torch.where(inside, out, torch.zeros_like(out))


def fetch_opcode(params, st):
    """Opcode under every organism's IP, as micro_step fetches it."""
    mlen = st.mem_len.clamp(min=1)
    ip = _adjust(st.heads[:, HEAD_IP], mlen)
    return (_at(st.tape, ip) & OP_MASK).to(torch.int32).clamp(
        0, params.num_insts - 1)


def _calc_size_merit(params, genome_len, copied_size, executed_size):
    """cPhenotype::CalcSizeMerit (BASE_MERIT_METHOD switch)."""
    m = params.base_merit_method
    f32 = torch.float32
    if m == 0:
        return torch.full_like(genome_len, params.base_const_merit).to(f32)
    if m == 1:
        return copied_size.to(f32)
    if m == 2:
        return executed_size.to(f32)
    if m == 3:
        return genome_len.to(f32)
    least = torch.minimum(torch.minimum(genome_len, copied_size),
                          executed_size)
    if m == 4:
        return least.to(f32)
    if m == 5:
        return prng.sqrt_f32(least.to(f32))
    raise NotImplementedError(f"BASE_MERIT_METHOD {m}")


# ---- the energy model's arithmetic.  XLA's CPU simplifier folds the
# constants of each product into one float32 constant and the code
# generator fuses the child's share into one multiply-add; these repeat
# it (tests/test_torch_energy.py holds them at the rounding edges) ----

def _f32c(x) -> float:
    return prng.round_f32(x)


def convert_energy_to_merit(params, energy):
    """cPhenotype::ConvertEnergyToMerit (cPhenotype.cc:2403): 100 x energy
    / NUM_CYCLES_EXC_BEFORE_0_ENERGY, or 100 x FIX_METABOLIC_RATE: energy
    times the folded constant float32(100) * float32(1 / n)."""
    if params.fix_metabolic_rate > 0.0:
        return torch.full_like(energy, 100.0 * params.fix_metabolic_rate)
    c = _f32c(_f32c(100.0) * prng.f32_reciprocal(max(params.num_cycles_exc,
                                                      1)))
    return energy * c


def child_energy(params, energy):
    """The newborn's energy (cPhenotype::SetupOffspring energy branch):
    the parent's energy times (1 - FRAC_ENERGY_DECAY_AT_ORG_BIRTH) times
    FRAC_PARENT_ENERGY_GIVEN_TO_ORG_AT_BIRTH, plus ENERGY_GIVEN_AT_BIRTH,
    at most ENERGY_CAP -- one fused multiply-add by the folded
    constant."""
    keep = _f32c(1.0 - params.frac_energy_decay_birth)
    c = _f32c(keep * _f32c(params.frac_parent_energy))
    e = prng.fma_f32(energy, c, params.energy_given_at_birth)
    if params.energy_cap > 0:
        e = torch.clamp(e, max=_f32c(params.energy_cap))
    return e


def parent_energy_after(params, energy):
    """The winning parent's remaining energy (cPhenotype::DivideReset
    energy branch): energy times the folded constant (1 - decay)(1 -
    frac)."""
    keep = _f32c(1.0 - params.frac_energy_decay_birth)
    return energy * _f32c(keep * _f32c(1.0 - params.frac_parent_energy))


_TABLES = {}           # (id(params), device) -> (params, tables)


def _tables(params, device) -> dict:
    """The instruction set's tables as tensors on `device`
    (cycles.params_cached)."""
    return params_cached(_TABLES, params, device, _build_tables)


def _build_tables(params, device) -> dict:
    ni = params.num_insts

    def t(vals, dtype=torch.int32):
        return torch.tensor(list(vals), dtype=dtype, device=device)

    tab = {
        "sem": t(params.sem), "mod_kind": t(params.mod_kind),
        "default_op": t(params.default_op),
        "is_nop": t([bool(x) for x in params.is_nop], torch.bool),
        "nop_mod": t(params.nop_mod),
        "nops": [k for k in range(ni) if params.is_nop[k]],
        "uniform": uniform_mutation(params),
        "cdf": _cdf_thresholds(params),
    }
    if params.inst_cost or params.inst_ft_cost:
        tab["cost"] = t(params.inst_cost or (0,) * ni)
        tab["ft_cost"] = t(params.inst_ft_cost or (0,) * ni)
    if params.inst_prob_fail:
        tab["prob_fail"] = t(params.inst_prob_fail, torch.float32)
    if params.inst_addl_time_cost:
        tab["addl"] = t(params.inst_addl_time_cost)
    if params.inst_energy_cost:
        tab["energy_cost"] = t(params.inst_energy_cost, torch.float32)
    return tab


def cycle_bits(draw_keys_fn, params, keys, n):
    """The bit draws of one or more cycles: keys int64[..., W, 2] (the
    cycle keys of W worlds, world-major lanes) -> int64[D, ..., n], one
    bit draw per draw key over every lane of its world, as the reference
    draws them.  D = 0 when the configuration reads no draw."""
    lead = keys.shape[:-2]
    W = keys.shape[-2]
    dk = draw_keys_fn(params, keys.reshape(-1, 2))
    if not dk.shape[0]:
        return dk.new_zeros((0,) + tuple(lead) + (n,))
    return prng.bits_rows(dk.reshape(-1, 2), n // W).reshape(
        (dk.shape[0],) + tuple(lead) + (n,))


def micro_step(params, st, key, exec_mask, bits=None, return_signals=False,
               charge_time=True):
    """Execute one CPU cycle for every organism where exec_mask is set
    (one pass of the reference hot loop, Avida2Driver.cc:111-116, over
    every scheduled organism at once).  Returns the new state; a lane
    outside exec_mask comes back unchanged.

    `key` is the cycle's key (int64[2]), or int64[W, 2] for W worlds whose
    lanes are stacked world-major on the state's organism axis: each
    world's draws then come from its own key over its own lanes, as the
    reference's vmap over worlds draws them.  `bits` is
    cycle_bits(draw_keys, params, keys, n) when the caller drew it
    already (the engine draws blocks of cycles at once).

    Under MAX_CPU_THREADS > 1 this is the per-thread core of
    micro_step_threads, which hands it the active thread's view and asks
    for `return_signals` -- (new state, {fork, kill, div, child_ip}) --
    to do the slot bookkeeping itself; `charge_time=False` skips the
    cycle's time_used / cpu_cycles / insts_executed charge (slicing
    method 1 charges once a slice)."""
    i32, u8 = torch.int32, torch.uint8
    n, L = st.tape.shape
    dev = st.tape.device
    T = _tables(params, dev)
    keys = key[None] if key.dim() == 1 else key
    ni = params.num_insts
    cols = torch.arange(L, device=dev)[None, :]
    f32 = torch.float32

    fconst = prng.round_f32       # float32 constants as scalars

    mlen = st.mem_len.clamp(min=1)
    ip = _adjust(st.heads[:, HEAD_IP], mlen)
    rp = _adjust(st.heads[:, HEAD_READ], mlen)
    wp = _adjust(st.heads[:, HEAD_WRITE], mlen)

    # ---- reads (the reference's packed reductions, as gathers) ----
    tape0 = st.tape
    s_ip = _at(tape0, ip).to(i32)
    s_ip1 = torch.where(ip + 1 < L, _at(tape0, (ip + 1).clamp(max=L - 1)),
                        0).to(i32)
    s_rp = (_at(tape0, rp) & OP_MASK).to(i32)
    parent_size = rp
    child_end = torch.where(wp == 0, mlen, wp)
    child_size = child_end - parent_size
    exec_count0 = (((tape0 & EXEC_BIT) != 0) & (cols < parent_size[:, None])
                   ).sum(dim=1, dtype=i32)
    copied_count = (((tape0 & COPIED_BIT) != 0)
                    & (cols >= parent_size[:, None])
                    & (cols < child_end[:, None])).sum(dim=1, dtype=i32)

    cur_op = (s_ip & OP_MASK).clamp(0, ni - 1)
    ip_exec_already = ((s_ip >> 6) & 1) != 0

    # ---- instruction cost engine (SingleProcess_PayPreCosts,
    # cHardwareBase.cc:1241): a cost-c instruction waits c - 1 cycles and
    # executes on the last; ft_cost is a one-time surcharge per opcode ----
    has_costs = bool(params.inst_cost) or bool(params.inst_ft_cost)
    if has_costs:
        one = torch.ones_like(cur_op)
        ft_bit = torch.where(
            cur_op < 32, (st.ft_paid_lo >> cur_op.clamp(0, 31)) & 1,
            (st.ft_paid_hi >> (cur_op - 32).clamp(0, 31)) & 1)
        total_cost = T["cost"][cur_op].clamp(min=1) + torch.where(
            ft_bit == 0, T["ft_cost"][cur_op], 0)
        cw = st.cost_wait
        eff_exec = exec_mask & ((cw == 1) | ((cw == 0) & (total_cost <= 1)))
        cost_wait = torch.where(exec_mask, torch.where(
            cw > 0, cw - 1, torch.where(total_cost > 1, total_cost - 1, 0)),
            cw)
        pay_ft = eff_exec & (ft_bit == 0)
        ft_paid_lo = torch.where(pay_ft & (cur_op < 32),
                                 st.ft_paid_lo | (one << cur_op.clamp(0, 31)),
                                 st.ft_paid_lo)
        ft_paid_hi = torch.where(
            pay_ft & (cur_op >= 32),
            st.ft_paid_hi | (one << (cur_op - 32).clamp(0, 31)),
            st.ft_paid_hi)
    else:
        eff_exec = exec_mask
        cost_wait = st.cost_wait
        ft_paid_lo, ft_paid_hi = st.ft_paid_lo, st.ft_paid_hi

    # ---- the cycle's draws: one bit draw per key over every lane of its
    # world, as the reference draws them ----
    if bits is None:
        bits = cycle_bits(draw_keys, params, keys, n)
    if params.copy_mut_prob > 0:
        u_copy_mut = prng.bits_to_unit(bits[0])
        if T["uniform"]:
            rand_inst = prng.randint_from_bits(bits[1], bits[2], 0, ni)
        else:
            rand_inst = _inverse_cdf(prng.bits_to_unit(bits[1]), T["cdf"])
    else:                       # no copy mutation reads them
        u_copy_mut = torch.ones(n, dtype=f32, device=dev)
        rand_inst = torch.zeros(n, dtype=i32, device=dev)

    # ---- probabilistic execution failure (cHardwareCPU.cc:988-990): the
    # costs are paid and IP advances, the effect is suppressed ----
    if params.inst_prob_fail:
        u_fail = prng.bits_to_unit(bits[-1])
        inst_failed = eff_exec & (u_fail < T["prob_fail"][cur_op])
    else:
        inst_failed = torch.zeros_like(exec_mask)
    sem = torch.where(eff_exec & ~inst_failed, T["sem"][cur_op], -1)

    def is_op(s):
        return sem == s

    # ---- operand resolution (FindModifiedRegister/Head, cc:1622,1663) ----
    next_pos = _adjust(ip + 1, mlen)
    op0 = (tape0[:, 0] & OP_MASK).to(i32)
    next_op = torch.where(ip == mlen - 1, op0, s_ip1 & OP_MASK).clamp(
        0, ni - 1)
    next_is_nop = T["is_nop"][next_op]
    mod_kind = torch.where(exec_mask & ~inst_failed, T["mod_kind"][cur_op],
                           MOD_NONE)
    wants_mod = (mod_kind == MOD_REG) | (mod_kind == MOD_HEAD)
    has_mod = wants_mod & next_is_nop
    operand = torch.where(has_mod, T["nop_mod"][next_op],
                          T["default_op"][cur_op])
    consumed = has_mod.to(i32)

    # ---- label decode (ReadLabel, cc:1484: nop run after IP, max 10);
    # offset k reads (ip + 1 + k) mod mlen, and 0 where k >= mlen ----
    loff = torch.arange(MAX_LABEL_SIZE, device=dev)[None, :]
    lpos = (ip[:, None] + 1 + loff) % mlen[:, None]
    lab_ops = torch.where(loff < mlen[:, None],
                          (tape0.gather(1, lpos.long()) & OP_MASK).to(i32),
                          0).clamp(0, ni - 1)
    in_range = (loff + 1) <= (mlen - 1)[:, None]
    lab_run = torch.cumprod((T["is_nop"][lab_ops] & in_range).to(i32), dim=1)
    has_label = mod_kind == MOD_LABEL
    label_len = torch.where(has_label, lab_run.sum(dim=1).to(i32), 0)
    label = T["nop_mod"][lab_ops]                       # [N, 10]
    consumed = torch.where(has_label, label_len, consumed)

    # ---- executed flags (SetFlagExecuted) ----
    nop_exec = has_mod | (has_label & (label_len > 0))
    tape = tape0.clone()
    _put(tape, ip, _at(tape, ip) | torch.where(eff_exec, EXEC_BIT, 0).to(u8))
    _put(tape, next_pos,
         _at(tape, next_pos) | torch.where(nop_exec, EXEC_BIT, 0).to(u8))

    # ---- register reads (pre-update values) ----
    NR = params.num_registers
    regs0 = st.regs
    val = torch.where((operand >= 0) & (operand < NR),
                      _at(regs0, operand.clamp(0, NR - 1)), 0)
    next_reg = (operand + 1) % NR
    val2 = _at(regs0, next_reg)
    bx, cx = regs0[:, 1], regs0[:, 2]

    # ---- stacks (cCPUStack.h:59-77: push decrements sp, pop reads+zeros) ----
    a_stk = st.active_stack
    spa = torch.where(a_stk == 0, st.sp[:, 0],
                      torch.where(a_stk == 1, st.sp[:, 1], 0))
    push_m, pop_m = is_op(SEM_PUSH), is_op(SEM_POP)
    sp_push = (spa + 9) % 10
    flat = st.stacks.reshape(n, 20).clone()
    cur_idx = (a_stk * 10 + spa).clamp(0, 19)
    push_idx = (a_stk * 10 + sp_push).clamp(0, 19)
    pop_val = _at(flat, cur_idx)
    _put(flat, push_idx, torch.where(push_m, val, _at(flat, push_idx)))
    _put(flat, cur_idx, torch.where(pop_m, 0, _at(flat, cur_idx)))
    stacks = flat.reshape(n, 2, 10)
    new_spa = torch.where(push_m, sp_push,
                          torch.where(pop_m, (spa + 1) % 10, spa))
    sp = torch.where(torch.arange(2, device=dev)[None, :] == a_stk[:, None],
                     new_spa[:, None], st.sp)
    active_stack = torch.where(is_op(SEM_SWAP_STK), 1 - a_stk, a_stk)

    # ---- h-search (cc:7245: complement label, find forward from 0) ----
    lbl_c = (label + 1) % params.num_nops
    srch = is_op(SEM_H_SEARCH)
    ops_c = (tape0 & OP_MASK).clamp(max=ni - 1)
    code = torch.full((n, L + MAX_LABEL_SIZE), -2, dtype=torch.int8,
                      device=dev)
    code[:, :L] = -1
    for k in T["nops"]:
        code[:, :L] = torch.where(ops_c == k, int(params.nop_mod[k]),
                                  code[:, :L])
    match = (cols + label_len[:, None] <= mlen[:, None]) \
        & (label_len[:, None] > 0)
    for k in range(MAX_LABEL_SIZE):
        mk = code[:, k:k + L] == lbl_c[:, k:k + 1]
        match = match & (mk | (k >= label_len)[:, None])
    found = match.any(dim=1)
    q_found = match.to(u8).argmax(dim=1).to(i32)
    ip_after_label = _adjust(ip + label_len, mlen)
    search_head = torch.where(found, q_found + label_len - 1, ip_after_label)
    search_bx = search_head - ip_after_label
    new_flow_srch = _adjust(search_head + 1, mlen)

    # ---- if-label (cc:6914: complement label vs recently copied label) ----
    rl_match = (st.read_label_len == label_len) & (
        (st.read_label.to(i32) == lbl_c) | (loff >= label_len[:, None])
    ).all(dim=1)
    skip = ((is_op(SEM_IF_N_EQU) & (val == val2))
            | (is_op(SEM_IF_LESS) & (val >= val2))
            | (is_op(SEM_IF_LABEL) & ~rl_match)
            | (is_op(SEM_IF_MATE_MALE) & (st.mating_type != 1))
            | (is_op(SEM_IF_MATE_FEMALE) & (st.mating_type != 0)))
    if params.hw_type == 3:
        skip = (skip | (is_op(SEM_IF_NOT_0) & (val == 0))
                | (is_op(SEM_IF_EQU_0) & (val != 0)))

    # ---- h-alloc (Inst_MaxAlloc cc:3294 + Allocate_Main cc:1707) ----
    osr = fconst(params.offspring_size_range)
    old_len = mlen
    alloc_size = torch.minimum((osr * old_len.to(f32)).to(i32), L - old_len)
    alloc_ok = alloc_size >= 1
    if params.require_allocate:
        alloc_ok = alloc_ok & ~st.mal_active
    alloc_ok = alloc_ok & (old_len <= (alloc_size.to(f32) * osr).to(i32))
    alloc_ok = alloc_ok & ~st.divide_pending
    alloc_m = is_op(SEM_H_ALLOC) & alloc_ok
    new_len_alloc = old_len + alloc_size
    fill = alloc_m[:, None] & (cols >= old_len[:, None]) \
        & (cols < new_len_alloc[:, None])
    tape = torch.where(fill, torch.zeros((), dtype=u8, device=dev), tape)
    mem_len = torch.where(alloc_m, new_len_alloc, st.mem_len)
    mal_active = st.mal_active | alloc_m

    # ---- h-copy (cc:7130: read -> write with copy mutation) ----
    copy_m = is_op(SEM_H_COPY)
    read_inst = s_rp.clamp(0, ni - 1)
    do_mut = copy_m & (u_copy_mut < fconst(params.copy_mut_prob))
    written = torch.where(do_mut, rand_inst, read_inst)
    w_old = _at(tape, wp)
    _put(tape, wp, torch.where(copy_m, written.to(u8) | COPIED_BIT
                               | (w_old & EXEC_BIT), w_old))
    # read-label tracking uses the pre-mutation instruction (cc:1459)
    ri_isnop = T["is_nop"][read_inst]
    rl_len = st.read_label_len
    can_append = ri_isnop & copy_m & (rl_len < MAX_LABEL_SIZE)
    read_label = st.read_label.clone()
    rl_idx = rl_len.clamp(0, MAX_LABEL_SIZE - 1)
    _put(read_label, rl_idx, torch.where(
        can_append, T["nop_mod"][read_inst].to(torch.int8),
        _at(read_label, rl_idx)))
    read_label_len = torch.where(~ri_isnop & copy_m, 0,
                                 torch.where(can_append, rl_len + 1, rl_len))

    # ---- h-divide (Inst_HeadDivide cc:6961 -> Divide_Main cc:1775) ----
    div_sex_try = is_op(SEM_H_DIVIDE_SEX)
    div_try = is_op(SEM_H_DIVIDE) | div_sex_try
    gsize = st.genome_len
    fsize = gsize.to(f32)
    # XLA rewrites the division by a constant as a product with its
    # float32 reciprocal
    min_sz = (fsize * prng.f32_reciprocal(osr)).to(i32).clamp(
        min=params.min_genome_len)
    max_sz = (fsize * osr).to(i32).clamp(max=L)
    exec_count = exec_count0 + (div_try & ~ip_exec_already
                                & (ip < parent_size)).to(i32)
    viable = ((child_size >= min_sz) & (child_size <= max_sz)
              & (parent_size >= min_sz) & (parent_size <= max_sz)
              & (exec_count >= (parent_size.to(f32)
                                * fconst(params.min_exe_lines)).to(i32))
              & (copied_count >= (child_size.to(f32)
                                  * fconst(params.min_copied_lines)).to(i32))
              & ~st.divide_pending & ~st.sterile)
    div_m = div_try & viable
    off_start = torch.where(div_m, rp, st.off_start)
    off_len = torch.where(div_m, child_size, st.off_len)

    # ---- IO + task evaluation (Inst_TaskIO cc:4188) ----
    io_m = is_op(SEM_IO)
    value_in = _at(st.inputs, st.input_ptr % 3)
    logic_id = tasks_ops.compute_logic_id(st.input_buf, st.input_buf_n, val)
    new_bonus, new_tc, new_rc, _, *new_pools = tasks_ops.apply_reactions(
        params, tasks_ops.env_tables_to_device(params, dev), io_m, logic_id,
        st.cur_bonus, st.cur_task_count, st.cur_reaction_count,
        st.input_buf, st.input_buf_n, val, st.resources, st.res_grid,
        st.deme_resources)
    pools = {}
    if res_ops.binds_pools(params):
        # the reference runs this block under lax.cond(io_m.any()): with
        # no lane doing IO the pools stay as they were (not max(x - 0, 0),
        # which is not the identity on -0.0, NaN or a negative deme
        # level) -- selected on the device, no host read
        any_io = io_m.any()
        pools = {name: torch.where(any_io, new, getattr(st, name))
                 for name, new in zip(("resources", "res_grid",
                                       "deme_resources"), new_pools)}
    task_exe_total = st.task_exe_total + (new_tc - st.cur_task_count)
    input_ptr = torch.where(io_m, st.input_ptr + 1, st.input_ptr)
    input_buf = torch.where(io_m[:, None], torch.stack(
        [value_in, st.input_buf[:, 0], st.input_buf[:, 1]], dim=1),
        st.input_buf)
    input_buf_n = torch.where(io_m, (st.input_buf_n + 1).clamp(max=3),
                              st.input_buf_n)
    output_buf = torch.where(io_m, val, st.output_buf)
    cur_bonus = torch.where(io_m, new_bonus, st.cur_bonus)
    cur_task_count = torch.where(io_m[:, None], new_tc, st.cur_task_count)
    cur_reaction_count = torch.where(io_m[:, None], new_rc,
                                     st.cur_reaction_count)

    # ---- register writes ----
    res = val
    wrote = torch.zeros_like(exec_mask)
    # experimental hardware's math reads ?BX? and the register after it
    a1m, a2m = (val, val2) if params.hw_type == 3 else (bx, cx)
    for s, v in ((SEM_SHIFT_R, val >> 1), (SEM_SHIFT_L, val << 1),
                 (SEM_INC, val + 1), (SEM_DEC, val - 1),
                 (SEM_ADD, a1m + a2m), (SEM_SUB, a1m - a2m),
                 (SEM_NAND, ~(a1m & a2m)), (SEM_POP, pop_val),
                 (SEM_IO, value_in), (SEM_SWAP, val2),
                 (SEM_ID_TH, st.main_tid)):
        res = torch.where(is_op(s), v, res)
        wrote = wrote | is_op(s)
    rsel = torch.arange(NR, device=dev)[None, :]
    regs = torch.where((rsel == operand[:, None]) & wrote[:, None],
                       res[:, None], regs0)
    regs = torch.where((rsel == next_reg[:, None]) & is_op(SEM_SWAP)[:, None],
                       val[:, None], regs)
    # get-head: CX <- position of ?head? (cc:6907); IP reads past the
    # consumed modifier nop
    hsel0 = torch.where(mod_kind == MOD_HEAD, operand, HEAD_IP)
    h_onehot = torch.arange(4, device=dev)[None, :] == hsel0[:, None]
    head_sel = torch.where((hsel0 >= 0) & (hsel0 < 4),
                           _at(st.heads, hsel0.clamp(0, 3)), 0)
    eff_head_pos = torch.where(hsel0 == HEAD_IP, _adjust(ip + consumed, mlen),
                               _adjust(head_sel, mlen))

    def setreg_c(regs, idx, v, m):
        return torch.where((rsel == idx) & m[:, None], v[:, None], regs)

    regs = setreg_c(regs, 2, eff_head_pos, is_op(SEM_GET_HEAD))
    regs = setreg_c(regs, 0, old_len, alloc_m)
    regs = setreg_c(regs, 1, search_bx, srch)
    regs = setreg_c(regs, 2, label_len, srch)
    regs = torch.where(div_m[:, None], 0, regs)
    facing, forage_target = st.facing, st.forage_target
    if params.hw_type == 3:
        (regs, facing, forage_target, move_won, move_tgt, atk_ok,
         atk_tgt) = _exp_spatial(params, st, sem, operand, val, regs)

    # ---- head writes ----
    heads = st.heads
    mov_m, jmp_m = is_op(SEM_MOV_HEAD), is_op(SEM_JMP_HEAD)
    flow0 = _adjust(heads[:, HEAD_FLOW], mlen)
    new_hpos = torch.where(mov_m, flow0, _adjust(eff_head_pos + cx, mlen))
    heads = torch.where(h_onehot & (mov_m | jmp_m)[:, None],
                        new_hpos[:, None], heads)
    new_flow = torch.where(is_op(SEM_SET_FLOW), _adjust(val, mlen),
                           torch.where(srch, new_flow_srch,
                                       heads[:, HEAD_FLOW]))
    new_read = torch.where(copy_m, _adjust(rp + 1, mlen), heads[:, HEAD_READ])
    new_write = torch.where(copy_m, _adjust(wp + 1, mlen),
                            heads[:, HEAD_WRITE])
    # mov-head on IP suppresses the advance (cc:6809); a divide resets IP;
    # fork-th steps over the child's first instruction
    fork_try = is_op(SEM_FORK_TH)
    ip_seq = _adjust(ip + consumed + skip.to(i32) + 1 + fork_try.to(i32),
                     mlen)
    jmp_tgt = _adjust(_adjust(ip + consumed + cx, mlen) + 1, mlen)
    ip_new = torch.where(jmp_m & (hsel0 == HEAD_IP), jmp_tgt, ip_seq)
    ip_new = torch.where(mov_m & (hsel0 == HEAD_IP), flow0, ip_new)
    ip_new = torch.where(div_m, 0, ip_new)
    ip_new = torch.where(eff_exec, ip_new, st.heads[:, HEAD_IP])
    heads = torch.stack([ip_new, new_read, new_write, new_flow], dim=1)

    # ---- divide: parent reset, pending offspring ----
    mem_len = torch.where(div_m, rp, mem_len)
    tape = torch.where(div_m[:, None], tape & OP_MASK, tape)
    heads = torch.where(div_m[:, None], 0, heads)
    stacks = torch.where(div_m[:, None, None], 0, stacks)
    sp = torch.where(div_m[:, None], 0, sp)
    active_stack = torch.where(div_m, 0, active_stack)
    read_label_len = torch.where(div_m, 0, read_label_len)
    mal_active = mal_active & ~div_m
    if has_costs:
        cost_wait = torch.where(div_m, 0, cost_wait)
        ft_paid_lo = torch.where(div_m, 0, ft_paid_lo)
        ft_paid_hi = torch.where(div_m, 0, ft_paid_hi)

    # ---- the energy model: the instruction's energy cost, as far as
    # the store holds (SingleProcess_PayPreCosts energy branch,
    # cHardwareBase.cc:1241; cPhenotype::ReduceEnergy cc:1974) ----
    energy, energy_spent = st.energy, st.energy_spent
    if params.energy_enabled and params.inst_energy_cost:
        cost = torch.where(exec_mask, T["energy_cost"][cur_op], 0.0)
        spent = torch.minimum(cost, energy)
        energy = energy - spent
        energy_spent = energy_spent + spent

    # ---- phenotype DivideReset (cPhenotype.cc:824) ----
    merit_base = _calc_size_merit(params, gsize, st.copied_size, exec_count)
    new_merit = merit_base * cur_bonus if params.inherit_merit else merit_base
    if params.energy_enabled:
        # merit = ConvertEnergyToMerit(energy) (cPhenotype.cc:2403); the
        # parent's share goes to the child at the birth flush
        new_merit = convert_energy_to_merit(params, energy)
    gestation = st.time_used + 1 - st.gestation_start
    new_fitness = new_merit / gestation.clamp(min=1).to(f32)
    merit = torch.where(div_m, new_merit, st.merit)
    fitness = torch.where(div_m, new_fitness, st.fitness)
    gestation_time = torch.where(div_m, gestation, st.gestation_time)
    last_bonus = torch.where(div_m, cur_bonus, st.last_bonus)
    last_merit_base = torch.where(div_m, merit_base, st.last_merit_base)
    last_task_count = torch.where(div_m[:, None], cur_task_count,
                                  st.last_task_count)
    executed_size = torch.where(div_m, exec_count, st.executed_size)
    child_copied_size = torch.where(div_m, copied_count,
                                    st.child_copied_size)
    cur_bonus = torch.where(div_m, fconst(params.default_bonus), cur_bonus)
    cur_task_count = torch.where(div_m[:, None], 0, cur_task_count)
    cur_reaction_count = torch.where(div_m[:, None], 0, cur_reaction_count)
    generation = st.generation + (
        div_m & (params.generation_inc_method == 1)).to(i32)
    num_divides = st.num_divides + div_m.to(i32)

    # ---- time accounting + death (SingleProcess tail, cc:1047-1051) ----
    charge = (exec_mask if charge_time else torch.zeros_like(exec_mask)
              ).to(i32)
    time_used = st.time_used + charge
    if params.inst_addl_time_cost:
        time_used = time_used + torch.where(eff_exec, T["addl"][cur_op], 0)
    cpu_cycles = st.cpu_cycles + charge
    if params.divide_method != 0:
        time_used = torch.where(div_m, 0, time_used)
        cpu_cycles = torch.where(div_m, 0, cpu_cycles)
        gestation_start = torch.where(div_m, 0, st.gestation_start)
    else:
        gestation_start = torch.where(div_m, time_used, st.gestation_start)
    # mating-type transitions (Inst_SetMatingType*, cc:10896-10946):
    # male <-> female fails, juvenile is always settable
    mating_type = st.mating_type
    mating_type = torch.where(is_op(SEM_SET_MATE_MALE) & (mating_type != 0),
                              1, mating_type)
    mating_type = torch.where(
        is_op(SEM_SET_MATE_FEMALE) & (mating_type != 1), 0, mating_type)
    mating_type = torch.where(is_op(SEM_SET_MATE_JUV), -1, mating_type)
    died = exec_mask & (st.max_executed > 0) & (time_used >= st.max_executed)

    new_st = st.replace(
        tape=tape, mem_len=mem_len, regs=regs, heads=heads, stacks=stacks,
        sp=sp, active_stack=active_stack, read_label=read_label,
        read_label_len=read_label_len, mal_active=mal_active,
        alive=st.alive & ~died, input_ptr=input_ptr, input_buf=input_buf,
        input_buf_n=input_buf_n, output_buf=output_buf, merit=merit,
        cur_bonus=cur_bonus, cur_task_count=cur_task_count,
        cur_reaction_count=cur_reaction_count,
        task_exe_total=task_exe_total, last_task_count=last_task_count,
        time_used=time_used, cpu_cycles=cpu_cycles,
        gestation_start=gestation_start, gestation_time=gestation_time,
        fitness=fitness, last_bonus=last_bonus,
        last_merit_base=last_merit_base, executed_size=executed_size,
        child_copied_size=child_copied_size, generation=generation,
        num_divides=num_divides,
        divide_pending=st.divide_pending | div_m, off_start=off_start,
        off_len=off_len,
        off_copied_size=torch.where(div_m, copied_count, st.off_copied_size),
        off_sex=torch.where(div_m, div_sex_try, st.off_sex),
        insts_executed=st.insts_executed + charge, cost_wait=cost_wait,
        ft_paid_lo=ft_paid_lo, ft_paid_hi=ft_paid_hi, energy=energy,
        energy_spent=energy_spent, mating_type=mating_type,
        facing=facing, forage_target=forage_target, **pools)
    if params.hw_type == 3:
        if params.pred_prey_switch >= 0:
            new_st = _apply_attacks(params, new_st, st, atk_ok, atk_tgt)
        new_st = _apply_moves(new_st, move_won, move_tgt)
    if return_signals:
        # the forked thread resumes at fork + 1 (the parent stepped to
        # fork + 2)
        return new_st, {"fork": fork_try, "kill": is_op(SEM_KILL_TH),
                        "div": div_m, "child_ip": _adjust(ip + 1, mlen)}
    return new_st


# ---- experimental spatial hardware (hw_type 3) ----

# ring of facing directions, clockwise from north (the reference's
# cPopulationCell connection-list rotation order)
_RING = ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1),
         (-1, -1))


def facing_step(params, rows, facing, dist):
    """The cell `dist` steps from each row's cell in its facing direction
    (the reference's _facing_step).  Returns (cell int32, valid bool): a
    torus wraps; a bounded grid clips the cell and invalidates a ray that
    leaves the world."""
    wx, wy = params.world_x, params.world_y
    y0 = rows // wx
    x0 = rows % wx
    dy = torch.zeros_like(facing)
    dx = torch.zeros_like(facing)
    for k, (ky, kx) in enumerate(_RING):
        dy = torch.where(facing == k, ky, dy)
        dx = torch.where(facing == k, kx, dx)
    y = y0 + dy * dist
    x = x0 + dx * dist
    if params.geometry == 2:
        return (y % wy) * wx + (x % wx), torch.ones_like(y, dtype=torch.bool)
    valid = (y >= 0) & (y < wy) & (x >= 0) & (x < wx)
    return y.clamp(0, wy - 1) * wx + x.clamp(0, wx - 1), valid


def _exp_spatial(params, st, sem, operand, val, regs):
    """Experimental hardware's spatial instructions (the reference's
    _exp_spatial, from cHardwareExperimental.cc): rotate-x (cc:3441:
    facing += ?BX? mod 8, echoed to the register), rotate-org-id
    (cc:3489: face the neighbour whose cell index is ?BX?),
    set-forage-target, zero, look-ahead (GoLook cc:3895: the first
    organism on the facing ray, eight sensor fields into ?BX?..?BX?+7),
    the move intents (cc:3138: the lowest mover index claims the faced
    empty cell) and attack-prey's targets (cc:5407).  The ray and the
    claims run for every lane: the reference's any-lane conds select the
    same values, and no cycle reads a flag back to the host.  Returns
    (regs, facing, forage_target, move_won, move_tgt, atk_ok, atk_tgt)."""
    from avida_tpu_torch.models.experimental import (
        SEM_ATTACK_PREY, SEM_LOOK_AHEAD, SEM_MOVE, SEM_ROTATE_ORG_ID,
        SEM_ROTATE_X, SEM_SET_FORAGE, SEM_ZERO)
    n = st.alive.shape[0]
    dev = st.alive.device
    i32 = torch.int32
    rows = torch.arange(n, dtype=i32, device=dev)
    NR = params.num_registers
    rsel = torch.arange(NR, device=dev)[None, :]
    one = torch.ones_like(rows)

    def setreg(regs, idx, v, m):
        return torch.where((rsel == idx[:, None]) & m[:, None], v[:, None],
                           regs)

    def is_op(x):
        return sem == x

    rotx = is_op(SEM_ROTATE_X)
    facing = torch.where(rotx, (st.facing + val) % 8, st.facing)
    regs = setreg(regs, operand, torch.where(rotx, val % 8, 0), rotx)

    rotid = is_op(SEM_ROTATE_ORG_ID)
    for k in range(8):
        nb, valid = facing_step(params, rows, torch.full_like(rows, k), one)
        hit = rotid & valid & st.alive[nb.long()] & (nb == val)
        facing = torch.where(hit, k, facing)

    forage_target = torch.where(is_op(SEM_SET_FORAGE), val,
                                st.forage_target)
    regs = setreg(regs, operand, torch.zeros_like(rows), is_op(SEM_ZERO))

    # look-ahead: the [N, D] ray along the (new) facing
    look = is_op(SEM_LOOK_AHEAD)
    D = max(params.world_x, params.world_y)
    dists = torch.arange(1, D + 1, dtype=i32, device=dev)[None, :]
    cells, valid = facing_step(params, rows[:, None], facing[:, None], dists)
    occ = st.alive[cells.long()] & valid & (cells != rows[:, None])
    found = occ.any(dim=1)
    first = occ.to(torch.uint8).argmax(dim=1)       # the first organism
    tgt_cell = cells.gather(1, first[:, None]).squeeze(1)
    dist = torch.where(found, first.to(i32) + 1, -1)
    tgt_ft = torch.where(found, st.forage_target[tgt_cell.long()], -9)
    look_out = (torch.full_like(rows, -2), dist, torch.zeros_like(rows),
                torch.where(found, tgt_cell, -1), found.to(i32),
                torch.zeros_like(rows), torch.full_like(rows, -9), tgt_ft)
    for j, ov in enumerate(look_out):
        regs = setreg(regs, (operand + j) % NR, ov, look)

    # move: the lowest mover index claims the faced empty cell
    move = is_op(SEM_MOVE)
    mtgt, mvalid = facing_step(params, rows, facing, one)
    intend = move & mvalid & ~st.alive[mtgt.long()] & st.alive
    BIG = 2**30
    claim = torch.full((n,), BIG, dtype=i32, device=dev).scatter_reduce(
        0, torch.where(intend, mtgt, rows).long(),
        torch.where(intend, rows, BIG), "amin", include_self=True)
    won = intend & (claim[mtgt.long()] == rows)
    regs = setreg(regs, operand, won.to(i32), move)

    # attack-prey: the faced living prey (forage target > -2)
    atk = is_op(SEM_ATTACK_PREY)
    if params.pred_prey_switch >= 0:
        atgt, avalid = facing_step(params, rows, facing, one)
        atk_ok = (atk & avalid & st.alive[atgt.long()]
                  & (st.forage_target[atgt.long()] > -2) & (atgt != rows))
    else:
        atgt, atk_ok = rows, torch.zeros_like(atk)
    regs = setreg(regs, operand, atk_ok.to(i32), atk)
    return regs, facing, forage_target, won, mtgt, atk_ok, atgt


def _apply_attacks(params, st, pre, atk_ok, atk_tgt):
    """This cycle's kills (ExecuteAttack cc:7001): prey stats from the
    pre-cycle state `pre`; the prey dies; every successful attacker gains
    PRED_EFFICIENCY x the prey's merit and bonus and turns predator
    (forage target -2)."""
    n = st.alive.shape[0]
    eff = float(params.pred_efficiency)
    t = atk_tgt.long()
    killed = torch.zeros(n + 1, dtype=torch.bool, device=st.alive.device)
    killed[torch.where(atk_ok, t, n)] = True
    # XLA's CPU backend contracts the gain into a fused multiply-add
    return st.replace(
        merit=torch.where(atk_ok, prng.fma_f32(pre.merit[t], eff, st.merit),
                          st.merit),
        cur_bonus=torch.where(atk_ok, prng.fma_f32(pre.cur_bonus[t], eff,
                                                   st.cur_bonus),
                              st.cur_bonus),
        forage_target=torch.where(atk_ok, -2, st.forage_target),
        alive=st.alive & ~killed[:n])


def _apply_moves(st, won, target):
    """Move winners into their target cells: one permutation gather over
    every organism-bound field.  The cell's input stream and every
    world-level field (pools, deme state, the lane permutation, the
    rings) stay where they are."""
    from avida_tpu_torch.core.state import WORLD_LEVEL_FIELDS
    n = st.alive.shape[0]
    rows = torch.arange(n, dtype=torch.long, device=st.alive.device)
    t = target.long()
    # a winner and its (empty) target swap rows; slot n takes the rest
    ext = torch.arange(n + 1, dtype=torch.long, device=rows.device)
    ext[torch.where(won, t, n)] = rows
    ext[torch.where(won, rows, n)] = torch.where(won, t, rows)
    perm = ext[:n]
    updates = {}
    for name in st.__dataclass_fields__:
        if name == "inputs" or name in WORLD_LEVEL_FIELDS:
            continue
        v = getattr(st, name)
        if v is None or v.dim() == 0 or v.shape[0] != n:
            continue
        updates[name] = v[perm]
    return st.replace(**updates)


# ---- threads (MAX_CPU_THREADS > 1) ----

def thread_reps(params) -> int:
    """Thread sub-steps a cycle: 1 under THREAD_SLICING_METHOD 0, every
    slot under method 1 (cAvidaConfig.h:561)."""
    return params.max_cpu_threads if params.thread_slicing_method == 1 \
        else 1


def draw_keys_threads(params, keys):
    """micro_step_threads' draw keys: sub-step r's micro_step draws from
    fold_in(cycle key, r), so its draw keys are draw_keys of those,
    sub-step after sub-step -> int64[reps * D, K, 2]."""
    return torch.cat([draw_keys(params, prng.fold_in_rows(keys, r))
                      for r in range(thread_reps(params))])


def micro_step_threads(params, st, key, exec_mask, bits=None):
    """One scheduler cycle under MAX_CPU_THREADS > 1 (cHardwareCPU
    SingleProcess thread loop, cc:930-1060): 1 (slicing method 0) or
    MAX_CPU_THREADS (method 1) thread sub-steps, sub-step r keyed
    fold_in(key, r).  Each advances cur_thread to the next live slot,
    runs micro_step on that thread's view of the per-thread state, then
    writes the results back and applies the fork-th / kill-th / divide
    slot bookkeeping.  The live-thread count and the schedulable slots
    are fixed at the top of the cycle (the reference fixes num_inst_exec
    before its loop, cc:936): a thread forked this cycle first runs the
    next one.

    The reference's documented deviations from the dense thread array
    are kept: slots do not move on a kill (except that killing slot 0
    moves the last live extra thread into it), so the round-robin order
    after a mid-stack kill can differ, and after any kill scheduling
    resumes from slot 0.  No value is read back to the host."""
    reps = thread_reps(params)
    if bits is None:
        keys = key[None] if key.dim() == 1 else key
        bits = cycle_bits(draw_keys_threads, params, keys,
                          st.alive.shape[0])
    d = bits.shape[0] // reps
    keys = key[None] if key.dim() == 1 else key
    n_live = 1 + st.t_alive.sum(dim=1)
    sched_alive = st.t_alive
    for r in range(reps):
        st = _thread_substep(params, st, prng.fold_in_rows(keys, r),
                             exec_mask, bits[r * d:(r + 1) * d],
                             charge_time=(r == 0), rep=r, n_live=n_live,
                             sched_alive=sched_alive)
    return st


def _expand(mask, like):
    """bool[N, Te] mask broadcast over `like`'s trailing axes."""
    return mask.reshape(tuple(mask.shape) + (1,) * (like.ndim - 2))


def _thread_substep(params, st, keys, exec_mask, bits, charge_time, rep,
                    n_live, sched_alive):
    from avida_tpu_torch.ops.birth import _where_rows
    T = params.max_cpu_threads
    Te = T - 1
    dev = exec_mask.device
    cols = torch.arange(Te, device=dev)[None, :]
    # under slicing method 1, sub-step r runs only the lanes that had more
    # than r threads at the top of the cycle
    sub_mask = exec_mask & (n_live > rep) if rep else exec_mask

    def slot_alive(cand):
        extra = ((cols == (cand - 1)[:, None]) & st.t_alive
                 & sched_alive).any(dim=1)
        return (cand == 0) | extra

    # advance cur_thread to the next live slot (m_cur_thread++ with wrap,
    # cc:946-948; dead slots are skipped)
    cur0 = st.cur_thread
    cur = cur0
    found = torch.zeros_like(exec_mask)
    for k in range(1, T + 1):
        cand = (cur0 + k) % T
        al = slot_alive(cand)
        cur = torch.where(~found & al, cand, cur)
        found = found | al
    cur = torch.where(sub_mask, cur, cur0)
    onehot = (cols == (cur - 1)[:, None]) & (cur[:, None] > 0)
    is_extra = cur > 0

    def pick(main, extra):
        """The active thread's view of a per-thread field (slot 0 is the
        primary fields)."""
        v = torch.where(_expand(onehot, extra), extra,
                        torch.zeros_like(extra)).sum(dim=1)
        return _where_rows(is_extra, v.to(main.dtype), main)

    view = st.replace(
        regs=pick(st.regs, st.t_regs), heads=pick(st.heads, st.t_heads),
        stacks=torch.stack([pick(st.stacks[:, 0], st.t_stack),
                            st.stacks[:, 1]], dim=1),
        sp=torch.stack([pick(st.sp[:, 0], st.t_sp), st.sp[:, 1]], dim=1),
        active_stack=pick(st.active_stack, st.t_active_stack),
        read_label=pick(st.read_label, st.t_rlabel),
        read_label_len=pick(st.read_label_len, st.t_rlabel_len),
        main_tid=pick(st.main_tid, st.t_ids), cur_thread=cur)
    nv, sig = micro_step(params, view, keys, sub_mask, bits,
                         return_signals=True, charge_time=charge_time)

    # ---- write the view's per-thread results back into slot `cur`; a
    # divide from an extra slot resets the ORGANISM, so the reset view
    # lands in slot 0 ----
    div = sig["div"]
    wrote_main = sub_mask & (~is_extra | div)
    oh_w = onehot & (sub_mask & is_extra & ~div)[:, None]

    def put_main(old, new):
        return _where_rows(wrote_main, new.to(old.dtype), old)

    def put_extra(old, new, mask=oh_w):
        return torch.where(_expand(mask, old), new.unsqueeze(1).to(old.dtype),
                           old)

    st2 = nv.replace(
        regs=put_main(st.regs, nv.regs), heads=put_main(st.heads, nv.heads),
        stacks=torch.stack([put_main(st.stacks[:, 0], nv.stacks[:, 0]),
                            nv.stacks[:, 1]], dim=1),
        sp=torch.stack([put_main(st.sp[:, 0], nv.sp[:, 0]), nv.sp[:, 1]],
                       dim=1),
        active_stack=put_main(st.active_stack, nv.active_stack),
        read_label=put_main(st.read_label, nv.read_label),
        read_label_len=put_main(st.read_label_len, nv.read_label_len),
        main_tid=st.main_tid, cur_thread=cur,
        t_regs=put_extra(st.t_regs, nv.regs),
        t_heads=put_extra(st.t_heads, nv.heads),
        t_stack=put_extra(st.t_stack, nv.stacks[:, 0]),
        t_sp=put_extra(st.t_sp, nv.sp[:, 0]),
        t_active_stack=put_extra(st.t_active_stack, nv.active_stack),
        t_rlabel=put_extra(st.t_rlabel, nv.read_label),
        t_rlabel_len=put_extra(st.t_rlabel_len, nv.read_label_len),
        t_alive=st.t_alive, t_ids=st.t_ids)

    # ---- fork-th: the post-instruction active thread is copied into the
    # lowest free slot under the lowest unused thread id (ForkThread
    # cc:1505-1524); it fails silently at the cap ----
    free = ~st2.t_alive
    first_free = free & (torch.cumsum(free.to(torch.int32), dim=1) == 1)
    put = first_free & (sig["fork"] & free.any(dim=1))[:, None]
    new_id = torch.zeros_like(cur)
    taken = torch.zeros_like(exec_mask)
    for v in range(T):
        used_v = (st2.main_tid == v) | ((st2.t_ids == v)
                                        & st2.t_alive).any(dim=1)
        new_id = torch.where(~taken & ~used_v, v, new_id)
        taken = taken | ~used_v
    child_heads = nv.heads.clone()
    child_heads[:, HEAD_IP] = sig["child_ip"]
    st2 = st2.replace(
        t_alive=st2.t_alive | put,
        t_ids=torch.where(put, new_id[:, None], st2.t_ids),
        t_regs=put_extra(st2.t_regs, nv.regs, put),
        t_heads=put_extra(st2.t_heads, child_heads, put),
        t_stack=put_extra(st2.t_stack, nv.stacks[:, 0], put),
        t_sp=put_extra(st2.t_sp, nv.sp[:, 0], put),
        t_active_stack=put_extra(st2.t_active_stack, nv.active_stack, put),
        t_rlabel=put_extra(st2.t_rlabel, nv.read_label, put),
        t_rlabel_len=put_extra(st2.t_rlabel_len, nv.read_label_len, put))

    # ---- kill-th: fails with one thread (cc:1595); killing slot 0 moves
    # the last live extra thread into the primary fields, killing an
    # extra slot frees it ----
    can_kill = sig["kill"] & (1 + st2.t_alive.sum(dim=1) > 1)
    kill_extra = can_kill & is_extra
    kill0 = can_kill & ~is_extra
    last = st2.t_alive & (torch.cumsum(
        st2.t_alive.flip(1).to(torch.int32), dim=1).flip(1) == 1)

    def move0(main, extra):
        v = torch.where(_expand(last, extra), extra,
                        torch.zeros_like(extra)).sum(dim=1)
        return _where_rows(kill0, v.to(main.dtype), main)

    dead = torch.where(kill_extra[:, None], onehot,
                       torch.where(kill0[:, None], last,
                                   torch.zeros_like(st2.t_alive)))
    st2 = st2.replace(
        regs=move0(st2.regs, st2.t_regs), heads=move0(st2.heads, st2.t_heads),
        stacks=torch.stack([move0(st2.stacks[:, 0], st2.t_stack),
                            st2.stacks[:, 1]], dim=1),
        sp=torch.stack([move0(st2.sp[:, 0], st2.t_sp), st2.sp[:, 1]], dim=1),
        active_stack=move0(st2.active_stack, st2.t_active_stack),
        read_label=move0(st2.read_label, st2.t_rlabel),
        read_label_len=move0(st2.read_label_len, st2.t_rlabel_len),
        main_tid=move0(st2.main_tid, st2.t_ids),
        t_alive=st2.t_alive & ~dead,
        cur_thread=torch.where(can_kill, 0, st2.cur_thread))

    # ---- divide: the parent resets to one thread (Divide_Main -> Reset:
    # the extra slots die, the id chart resets) ----
    return st2.replace(
        t_alive=torch.where(div[:, None], False, st2.t_alive),
        cur_thread=torch.where(div, 0, st2.cur_thread),
        main_tid=torch.where(div, 0, st2.main_tid))


def roll_right(plane, r, L):
    """Per-row circular roll: out[n, q] = plane[n, (q - r[n]) mod L]."""
    q = torch.arange(L, device=plane.device)[None, :]
    return plane.gather(1, (q - r.long()[:, None]) % L)


def _shift_right1(off):
    """out[:, q] = off[:, q - 1] (column 0 gets 0)."""
    return torch.cat([torch.zeros_like(off[:, :1]), off[:, :-1]], dim=1)


def _shift_left1(off):
    """out[:, q] = off[:, q + 1] (the last column gets 0)."""
    return torch.cat([off[:, 1:], torch.zeros_like(off[:, :1])], dim=1)


def extract_offspring(params, st, key):
    """Pending offspring genomes with divide mutations applied
    (Divide_DoMutations, cHardwareBase.cc:296): the reference's
    extract_offspring with use_off_tape=True, draw for draw.  The cycle
    kernel has already written every fresh offspring to st.off_tape;
    TransSMT hardware divides off the host write buffer, smt_aux[:, 0]
    (Divide_Main, cHardwareTransSMT.cc:438); experimental hardware, whose
    engine keeps no off_tape, off its tape from off_start on (the
    reference's use_off_tape=False).  Returns (off int8[N, L], off_len
    int32[N])."""
    n, L = st.tape.shape
    dev = st.tape.device
    cols = torch.arange(L, device=dev)[None, :]
    off_len = st.off_len
    if is_smt(params):
        src = st.smt_aux[:, 0]
    elif params.hw_type == 3:
        src = barrel_shift_left(tape_ops(st.tape), st.off_start, L)
    else:
        src = st.off_tape
    off = torch.where(cols < off_len[:, None], src.to(torch.int8),
                      torch.zeros((), dtype=torch.int8, device=dev))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    osr = f32(params.offspring_size_range)
    gsize = st.genome_len.to(torch.float32)
    max_sz = (gsize * osr).to(torch.int32).clamp(max=L)
    div_m = st.divide_pending

    ks = prng.split(key, 5)
    k_u, k_mpos, k_ipos, k_dpos, k_iinst = (ks[i] for i in range(5))
    u_mut = prng.uniform(k_u, (n, 3))
    r_inst2 = random_inst(params, k_iinst, (n, 2))
    len1 = off_len.clamp(min=1)

    def put(off, pos, val, do):
        hit = (cols == pos[:, None]) & do[:, None]
        return torch.where(hit, val.to(torch.int8)[:, None], off)

    def ins1(off, off_len, ipos, iv, do):
        shifted = torch.where(cols > ipos[:, None], _shift_right1(off), off)
        ins = torch.where(cols == ipos[:, None], iv.to(torch.int8)[:, None],
                          shifted)
        return (torch.where(do[:, None], ins, off),
                torch.where(do, off_len + 1, off_len))

    def del1(off, off_len, dpos, do):
        deleted = torch.where(cols >= dpos[:, None], _shift_left1(off), off)
        deleted = torch.where(cols >= (off_len - 1)[:, None],
                              torch.zeros_like(deleted), deleted)
        return (torch.where(do[:, None], deleted, off),
                torch.where(do, off_len - 1, off_len))

    # DIV_MUT_PROB: Binomial(len, p) site substitutions, capped at 8
    if params.div_mut_prob > 0:
        k_dm = prng.fold_in(key, 0xD1)
        n_sub = prng.binomial(k_dm, len1.to(torch.float32),
                              params.div_mut_prob).clamp(0, 8).to(torch.int32)
        for k in range(8):
            kk = prng.fold_in(k_dm, k + 1)
            site = prng.randint(kk, (n,), 0, len1)
            rv = random_inst(params, prng.fold_in(kk, 3), (n,))
            off = put(off, site, rv, div_m & (k < n_sub) & (off_len > 0))
    if params.divide_mut_prob > 0:
        mpos = prng.randint(k_mpos, (n,), 0, len1)
        do_sub = div_m & (u_mut[:, 0] < f32(params.divide_mut_prob)) \
            & (off_len > 0)
        off = put(off, mpos, r_inst2[:, 0], do_sub)
    if params.divide_ins_prob > 0:
        ipos = prng.randint(k_ipos, (n,), 0, off_len.clamp(min=1) + 1)
        do_ins = div_m & (u_mut[:, 1] < f32(params.divide_ins_prob)) \
            & (off_len + 1 <= max_sz)
        off, off_len = ins1(off, off_len, ipos, r_inst2[:, 1], do_ins)
    if params.divide_del_prob > 0:
        dpos = prng.randint(k_dpos, (n,), 0, off_len.clamp(min=1))
        do_del = div_m & (u_mut[:, 2] < f32(params.divide_del_prob)) \
            & (off_len - 1 >= params.min_genome_len)
        off, off_len = del1(off, off_len, dpos, do_del)

    # COPY_INS_PROB / COPY_DEL_PROB: Binomial(len, p) single-site
    # insertions / deletions at divide time, capped at 4 each
    KMAX = 4
    if params.copy_ins_prob > 0 or params.copy_del_prob > 0:
        kcc = prng.split(prng.fold_in(key, 0xC0), 2)
        k_ci, k_cd = kcc[0], kcc[1]
        cl = off_len.clamp(min=1).to(torch.float32)
        if params.copy_ins_prob > 0:
            n_ins = prng.binomial(k_ci, cl, params.copy_ins_prob).clamp(
                0, KMAX).to(torch.int32)
            for k in range(KMAX):
                kk = prng.fold_in(k_ci, k + 1)
                ipos2 = prng.randint(kk, (n,), 0, off_len.clamp(min=1) + 1)
                iv = random_inst(params, prng.fold_in(kk, 7), (n,))
                do = div_m & (k < n_ins) & (off_len + 1 <= max_sz)
                off, off_len = ins1(off, off_len, ipos2, iv, do)
        if params.copy_del_prob > 0:
            n_del = prng.binomial(k_cd, cl, params.copy_del_prob).clamp(
                0, KMAX).to(torch.int32)
            for k in range(KMAX):
                kk = prng.fold_in(k_cd, k + 1)
                dpos2 = prng.randint(kk, (n,), 0, off_len.clamp(min=1))
                do = div_m & (k < n_del) \
                    & (off_len - 1 >= params.min_genome_len)
                off, off_len = del1(off, off_len, dpos2, do)

    # DIVIDE_SLIP_PROB (cHardwareBase::doSlipMutation cc:621): duplicate
    # or delete a random region [p1, p2), direction random
    if params.divide_slip_prob > 0:
        k_s = prng.fold_in(key, 0x51)
        u_s = prng.uniform(k_s, (n,))
        u_dir = prng.uniform(prng.fold_in(k_s, 1), (n,))
        pa = prng.randint(prng.fold_in(k_s, 2), (n,), 0, off_len.clamp(min=1))
        pb = prng.randint(prng.fold_in(k_s, 3), (n,), 0, off_len.clamp(min=1))
        p1, p2 = torch.minimum(pa, pb), torch.maximum(pa, pb)
        size = p2 - p1
        want = div_m & (u_s < f32(params.divide_slip_prob)) & (size > 0)
        dup = want & (u_dir < 0.5) & (off_len + size <= max_sz)
        dele = want & (u_dir >= 0.5) \
            & (off_len - size >= params.min_genome_len)
        dup_plane = torch.where(cols < p2[:, None], off,
                                roll_right(off, size, L))
        del_plane = torch.where(cols < p1[:, None], off,
                                roll_right(off, -size, L))
        off = torch.where(dup[:, None], dup_plane,
                          torch.where(dele[:, None], del_plane, off))
        off_len = torch.where(dup, off_len + size,
                              torch.where(dele, off_len - size, off_len))
        off = torch.where(cols < off_len[:, None], off,
                          torch.zeros_like(off))
    return off, off_len


def anomaly_masks(params, st):
    """Per-cell anomaly masks (the flight recorder's audit-adjacent
    invariants): a living organism with non-finite or negative merit, and
    an instruction pointer outside [0, mem_len).  Returns (bad_merit,
    bad_head, ip)."""
    mlen = st.mem_len.clamp(min=1)
    bad_merit = st.alive & (~torch.isfinite(st.merit) | (st.merit < 0))
    ip = st.heads[:, 0]
    bad_head = st.alive & ((ip < 0) | (ip >= mlen))
    return bad_merit, bad_head, ip
