"""Lockstep interpreter for the TransSMT hardware (models/transsmt.py).

Counterpart of avida_tpu/ops/interpreter_smt.py: `micro_step_smt`, one
TransSMT CPU cycle for the whole population as masked tensor operations
(cHardwareTransSMT::SingleProcess): pick the executing thread (host or
parasite, by virulence), fetch from the thread IP's (memory space,
position), resolve the nop modifier, dispatch on the semantic opcode.

Memory spaces per organism (see models/transsmt.py):
  0: the genome tape (PopulationState.tape, opcode bits)
  1: the host write buffer      (smt_aux[:, 0])
  2: the parasite code          (pmem)
  3: the parasite write buffer  (smt_aux[:, 1])
Thread 0 (host) starts at (0, 0), thread 1 (parasite) at (2, 0).

Where the reference reads one site with a masked sum over [N, L] for each
space, this reads it with one gather per space, giving the same value: the
opcode at (space, pos) when 0 <= pos < min(L, size), else 0.  The two
blocks the reference runs under an any-lane `lax.cond` run
unconditionally, so no cycle reads a flag back to the host:

  * the label search: its result `found` is read only under `srch_hit`,
    which implies the lane searches, so lanes outside the predicate
    cannot see it;
  * the IO block: its bonus and task counts are selected per lane under
    `io_host`; the pools it returns are selected on the device by
    `io_host.any()`, as the reference's cond selects them.

The search scans only the plane of the IP's space (the reference masks
the other three planes' matches away) and takes the first match at or
after IP, else the first before it: the first minimum of the reference's
circular distance, which is distinct for every position of the space.

Integer semantics are int32 with the reference's wraparound; Val-Div and
Val-Mod are floor division and floor remainder, computed in int64 and
wrapped back, so INT_MIN // -1 is INT_MIN on every device.
"""

from __future__ import annotations

import torch

from avida_tpu_torch.models.transsmt import (
    HEAD_FLOW, HEAD_IP, HEAD_READ, HEAD_WRITE, MAX_LABEL_SIZE, SEM_ADD,
    SEM_DEC, SEM_DIV, SEM_DIVIDE, SEM_HEAD_MOVE, SEM_HEAD_POP, SEM_HEAD_PUSH,
    SEM_IF_EQU, SEM_IF_GTR, SEM_IF_LESS, SEM_IF_NEQU, SEM_INC, SEM_INJECT,
    SEM_IO, SEM_MOD, SEM_MULT, SEM_NAND, SEM_PUSH_COMP, SEM_PUSH_NEXT,
    SEM_PUSH_PREV, SEM_READ, SEM_SEARCH, SEM_SET_MEMORY, SEM_SHIFT_L,
    SEM_SHIFT_R, SEM_SUB, SEM_VAL_COPY, SEM_VAL_DELETE, SEM_WRITE, STACK_AX,
    STACK_BX)
from avida_tpu_torch.core.state import smt_base_spaces
from avida_tpu_torch.ops import resources as res_ops
from avida_tpu_torch.ops import tasks as tasks_ops
from avida_tpu_torch.ops.cycles import params_cached, uniform_mutation
from avida_tpu_torch.ops.interpreter import (_cdf_thresholds, _inverse_cdf,
                                             cycle_bits)
from avida_tpu_torch.utils import prng

MIN_INJECT_SIZE = 8      # nHardwareTransSMT MIN_INJECT_SIZE
STACK_DEPTH = 10
OP_MASK = 0x3F

_TABLES = {}             # (id(params), device) -> (params, tables)


def _tables(params, device) -> dict:
    return params_cached(_TABLES, params, device, _build_tables)


def _build_tables(params, device) -> dict:
    def t(vals, dtype=torch.int32):
        return torch.tensor(list(vals), dtype=dtype, device=device)

    ni = params.num_insts
    return {
        "sem": t(params.sem),
        "is_nop": t([bool(x) for x in params.is_nop], torch.bool),
        "nop_mod": t(params.nop_mod),
        "nops": [(k, int(params.nop_mod[k])) for k in range(ni)
                 if params.is_nop[k]],
        "uniform": uniform_mutation(params),
        "cdf": _cdf_thresholds(params),
    }


def draw_keys(params, keys):
    """The keys of a cycle's draws, for cycle keys int64[K, 2]: int64[D, K,
    2], in order the thread-selection uniform, the copy-mutation uniform
    and the random instruction's draws (randint's two bit draws, or one
    uniform for a weighted set).  The derivations are the reference's:
    split(key, 3) -> (k_thr, k_mut, k_inst), randint splits k_inst."""
    ks = prng.split_rows(keys, 3)
    parts = [ks[:, 0], ks[:, 1]]
    if uniform_mutation(params):
        k12 = prng.split_rows(ks[:, 2])
        parts += [k12[:, 0], k12[:, 1]]
    else:
        parts.append(ks[:, 2])
    return torch.stack(parts)


def _space_planes(st):
    """The four memory spaces' byte planes and sizes (the tape's bytes
    carry flag bits above the opcode)."""
    planes = (st.tape, st.smt_aux[:, 0], st.pmem, st.smt_aux[:, 1])
    sizes = (st.mem_len, st.smt_aux_len[:, 0], st.pmem_len,
             st.smt_aux_len[:, 1])
    return planes, sizes


def _read_at(planes, sizes, space, pos):
    """int32 opcode at (space, pos) of every organism -- pos [N] or [N, P]
    -- and 0 outside the space (pos < 0, pos >= L or pos >= its size)."""
    L = planes[0].shape[1]
    sq = pos.dim() == 1
    if sq:
        pos = pos[:, None]
    idx = pos.clamp(0, L - 1).long()
    ok = (pos >= 0) & (pos < L)
    out = torch.zeros_like(pos, dtype=torch.int32)
    for k, (pl, sz) in enumerate(zip(planes, sizes)):
        v = pl.gather(1, idx)
        if k == 0:
            v = v & OP_MASK
        out = torch.where(ok & (space == k)[:, None] & (pos < sz[:, None]),
                          v.to(torch.int32), out)
    return out[:, 0] if sq else out


def _space_size(sizes, space):
    out = torch.zeros_like(space)
    for k, sz in enumerate(sizes):
        out = torch.where(space == k, sz, out)
    return out


def _pick(x, idx):
    """x[n, idx[n]] for idx in range (x [N, K])."""
    return x.gather(1, idx.long()[:, None])[:, 0]


def _sp_of(sps, stk):
    """The stack pointer of stack `stk` (0 for an id outside 0-3)."""
    ok = (stk >= 0) & (stk < 4)
    return torch.where(ok, _pick(sps, stk.clamp(0, 3)), 0)


def _top(stacks, sps, stk):
    """The top of stack `stk` of every organism (stacks [N, 4, 10])."""
    sp = _sp_of(sps, stk)
    ok = (stk >= 0) & (stk < 4) & (sp >= 0) & (sp < STACK_DEPTH)
    flat = stacks.reshape(stacks.shape[0], 4 * STACK_DEPTH)
    v = _pick(flat, stk.clamp(0, 3) * STACK_DEPTH
              + sp.clamp(0, STACK_DEPTH - 1))
    return torch.where(ok, v, 0)


def _floor_div_mod(a, b):
    """int32 floor quotient and remainder of a by b (b != 0), computed in
    int64 and wrapped: INT_MIN // -1 is INT_MIN and INT_MIN % -1 is 0,
    as in the reference, with no signed overflow on any device."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    q = torch.div(a64, b64, rounding_mode="floor")
    r = torch.remainder(a64, b64)
    q = torch.where(q >= 2**31, q - 2**32, q)
    return q.to(torch.int32), r.to(torch.int32)


def _label_search(planes, sizes, ip_s, ip_p, lbl_c, lab_len, T, ni):
    """Complement-label search in the IP's space (Inst_Search): the
    position where the label starts, first at or after IP, else first
    before it; -1 where it is absent.  A label may run past the space's
    size into the plane's stale bytes, as in the reference."""
    n, L = planes[0].shape
    dev = planes[0].device
    plane = torch.where((ip_s == 3)[:, None], planes[3], planes[2])
    plane = torch.where((ip_s == 1)[:, None], planes[1], plane)
    plane = torch.where((ip_s == 0)[:, None], planes[0] & OP_MASK, plane)
    code = torch.full((n, L + MAX_LABEL_SIZE), -4, dtype=torch.int8,
                      device=dev)
    code[:, :L] = -3
    for k, mod in T["nops"]:
        # opcodes past the set clip to its last one
        hit = plane == k if k < ni - 1 else plane >= k
        code[:, :L] = torch.where(hit, mod, code[:, :L])
    cols = torch.arange(L, device=dev)[None, :]
    sz = _space_size(sizes, ip_s)
    match = (cols < sz[:, None]) & (lab_len > 0)[:, None] \
        & ((ip_s >= 0) & (ip_s < 4))[:, None]
    for q in range(MAX_LABEL_SIZE):
        match = match & ((code[:, q:q + L] == lbl_c[q][:, None])
                         | (q >= lab_len)[:, None])
    after = match & (cols >= ip_p[:, None])
    first_after = after.to(torch.uint8).argmax(dim=1).to(torch.int32)
    first_any = match.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(after.any(dim=1), first_after,
                       torch.where(match.any(dim=1), first_any, -1))


def _push2(stacks, sps, mask, stack_id, val):
    """Push val onto the fixed stack `stack_id` where mask (Search's
    pushes)."""
    new_sp = (sps[:, stack_id] + STACK_DEPTH - 1) % STACK_DEPTH
    dev = stacks.device
    slot = ((torch.arange(4, device=dev) == stack_id)[None, :, None]
            & (torch.arange(STACK_DEPTH, device=dev)[None, None, :]
               == new_sp[:, None, None]) & mask[:, None, None])
    stacks = torch.where(slot, val[:, None, None], stacks)
    sps = torch.where((torch.arange(4, device=dev)[None, :] == stack_id)
                      & mask[:, None], new_sp[:, None], sps)
    return stacks, sps


def micro_step_smt(params, st, key, exec_mask, bits=None):
    """One TransSMT CPU cycle for every organism where exec_mask is set.
    A lane outside exec_mask comes back unchanged.

    `key` is the cycle's key (int64[2]), or int64[W, 2] for W worlds whose
    lanes are stacked world-major on the organism axis (each world draws
    from its own key over its own lanes).  `bits` is
    interpreter.cycle_bits(draw_keys, params, keys, n) when the caller
    drew it already."""
    i32, u8, f32 = torch.int32, torch.uint8, torch.float32
    n, L = st.tape.shape
    dev = st.tape.device
    T = _tables(params, dev)
    keys = key[None] if key.dim() == 1 else key
    ni = params.num_insts
    cols = torch.arange(L, device=dev)[None, :]
    fconst = prng.round_f32
    ar4 = torch.arange(4, device=dev)[None, :]

    # ---- the cycle's draws (thread, copy mutation, random instruction) ----
    if bits is None:
        bits = cycle_bits(draw_keys, params, keys, n)
    u_thr = prng.bits_to_unit(bits[0])
    u_mut = prng.bits_to_unit(bits[1])
    if T["uniform"]:
        rand_inst = prng.randint_from_bits(bits[2], bits[3], 0, ni)
    else:
        rand_inst = _inverse_cdf(prng.bits_to_unit(bits[2]), T["cdf"])

    # ---- thread selection (virulence; cc:242-249) ----
    v = params.parasite_virulence if params.parasite_virulence >= 0 else 0.5
    t = st.parasite_active & (u_thr < fconst(v)) & exec_mask
    ti = t.to(i32)

    def thr(x):
        """The active thread's row of an [N, 2, ...] field."""
        return torch.where(t.reshape((n,) + (1,) * (x.dim() - 2)),
                           x[:, 1], x[:, 0])

    planes, sizes = _space_planes(st)
    head_pos = thr(st.smt_head_pos)                  # [N, 4]
    head_space = thr(st.smt_head_space)              # [N, 4]
    ip_s = head_space[:, HEAD_IP]
    ip_sz = _space_size(sizes, ip_s).clamp(min=1)
    ip_p = head_pos[:, HEAD_IP] % ip_sz

    # ---- fetch: the opcode under IP and the three after it (the nop
    # modifier and the label, ReadLabel cc:1521) ----
    offs = torch.arange(MAX_LABEL_SIZE + 1, dtype=i32, device=dev)[None, :]
    ops4 = _read_at(planes, sizes, ip_s,
                    (ip_p[:, None] + offs) % ip_sz[:, None]).clamp(0, ni - 1)
    ops4l = ops4.long()
    cur_op = ops4[:, 0]
    sem = torch.where(exec_mask, T["sem"][ops4l[:, 0]], -1)

    def is_op(s):
        return sem == s

    has_mod = T["is_nop"][ops4l[:, 1]]
    mod_val = T["nop_mod"][ops4l[:, 1]]
    consumed = has_mod.to(i32)

    dflt = torch.full_like(cur_op, STACK_BX)
    for s in (SEM_IF_EQU, SEM_IF_NEQU, SEM_IF_LESS, SEM_IF_GTR,
              SEM_PUSH_NEXT):
        dflt = torch.where(is_op(s), STACK_AX, dflt)
    operand = torch.where(has_mod, mod_val, dflt)
    head_dflt = torch.full_like(cur_op, HEAD_IP)
    head_dflt = torch.where(is_op(SEM_READ), HEAD_READ, head_dflt)
    head_dflt = torch.where(is_op(SEM_WRITE), HEAD_WRITE, head_dflt)
    head_op = torch.where(has_mod & (mod_val < 4), mod_val, head_dflt)

    lab_len = torch.zeros_like(cur_op)
    running = torch.ones_like(exec_mask)
    lab_vals = []
    for k in range(MAX_LABEL_SIZE):
        isn_k = T["is_nop"][ops4l[:, k + 1]]
        isn = isn_k & running
        lab_vals.append(torch.where(isn, T["nop_mod"][ops4l[:, k + 1]], -1))
        lab_len = lab_len + isn.to(i32)
        running = running & isn_k
    has_label_sem = is_op(SEM_SEARCH) | is_op(SEM_SET_MEMORY) \
        | is_op(SEM_INJECT)
    consumed = torch.where(has_label_sem, lab_len, consumed)

    # ---- stacks: [N, 4, 10], the active thread's three local ones and
    # the global one ----
    stacks = torch.cat([thr(st.smt_stacks), st.gstack[:, None, :]], dim=1)
    sps = torch.cat([thr(st.smt_sp), st.gsp[:, None]], dim=1)
    src1 = operand
    nxt_stack = (operand + 1) % 4
    prv_stack = (operand + 3) % 4
    op2 = torch.where(has_mod, nxt_stack, (dflt + 1) % 4)
    v1 = _top(stacks, sps, src1)
    v2 = _top(stacks, sps, op2)

    # ---- the push/pop plan: at most one pop from pop_stack and one push
    # of push_val onto push_stack (-1 = none) ----
    pop_stack = torch.full_like(cur_op, -1)
    push_stack = torch.full_like(cur_op, -1)
    push_val = torch.zeros_like(cur_op)

    def plan(mask, pops, pushes, val=None):
        nonlocal pop_stack, push_stack, push_val
        if pops is not None:
            pop_stack = torch.where(mask, pops, pop_stack)
        if pushes is not None:
            push_stack = torch.where(mask, pushes, push_stack)
            push_val = torch.where(mask, val, push_val)

    for s, f in ((SEM_SHIFT_R, v1 >> 1), (SEM_SHIFT_L, v1 << 1),
                 (SEM_INC, v1 + 1), (SEM_DEC, v1 - 1)):
        plan(is_op(s), src1, src1, f)
    z2 = torch.where(v2 == 0, 1, v2)
    quot, rem = _floor_div_mod(v1, z2)
    for s, val in ((SEM_NAND, ~(v1 & v2)), (SEM_ADD, v1 + v2),
                   (SEM_SUB, v1 - v2), (SEM_MULT, v1 * v2),
                   (SEM_DIV, quot), (SEM_MOD, rem)):
        m = is_op(s)
        if s in (SEM_DIV, SEM_MOD):
            m = m & (v2 != 0)
        plan(m, None, src1, val)
    plan(is_op(SEM_VAL_COPY), None, src1, v1)
    plan(is_op(SEM_VAL_DELETE), src1, None)
    # Push-Comp's fallback is the previous stack in the reference too
    plan(is_op(SEM_PUSH_NEXT), src1, nxt_stack, v1)
    plan(is_op(SEM_PUSH_PREV), src1, prv_stack, v1)
    plan(is_op(SEM_PUSH_COMP), src1, prv_stack, v1)
    hsel = _pick(head_pos, head_op)
    plan(is_op(SEM_HEAD_PUSH), None, torch.full_like(cur_op, STACK_BX), hsel)
    headpop_val = v1
    plan(is_op(SEM_HEAD_POP), src1, None)

    # ---- Search (cc:1172): the complement label in the IP's space ----
    srch = is_op(SEM_SEARCH)
    lbl_c = [torch.where(x >= 0, (x + 2) % 4, -2) for x in lab_vals]
    found_pos = _label_search(planes, sizes, ip_s, ip_p, lbl_c, lab_len,
                              T, ni)
    srch_hit = srch & (found_pos >= 0) & (found_pos != ip_p)
    srch_miss = srch & ~srch_hit

    # ---- SetMemory (cc:1567): FLOW <- (the thread's write buffer, 0);
    # an empty label -> (its base space, 0) ----
    setmem = is_op(SEM_SET_MEMORY)
    aux_space = torch.where(t, 3, 1).to(i32)
    base_space = torch.where(t, 2, 0).to(i32)
    setmem_space = torch.where(lab_len > 0, aux_space, base_space)

    # ---- Inst-Read (cc:1304): the nop selects the head ----
    read_m = is_op(SEM_READ)
    r_space = _pick(head_space, head_op)
    r_sz = _space_size(sizes, r_space).clamp(min=1)
    r_pos = _pick(head_pos, head_op) % r_sz
    read_inst = _read_at(planes, sizes, r_space, r_pos)
    do_mut = read_m & (u_mut < fconst(params.copy_mut_prob)) & (ti == 0)
    read_val = torch.where(do_mut, rand_inst, read_inst)
    plan(read_m, None, torch.full_like(cur_op, STACK_AX), read_val)

    # ---- Inst-Write (cc:1341): grow the space by one, then adjust ----
    write_m = is_op(SEM_WRITE)
    w_space = torch.where(write_m, _pick(head_space, head_op), 0)
    w_sz0 = _space_size(sizes, w_space)
    w_pos = _pick(head_pos, head_op)
    grow = write_m & (w_pos >= w_sz0 - 1) & (w_sz0 < L)
    w_sz = torch.where(grow, w_sz0 + 1, w_sz0.clamp(min=1))
    w_pos = w_pos % w_sz.clamp(min=1)
    w_stack = torch.full_like(cur_op, STACK_AX)
    w_val0 = _top(stacks, sps, w_stack)
    w_val = torch.where((w_val0 < 0) | (w_val0 >= ni), 0, w_val0)
    plan(write_m, w_stack, None)

    # ---- IO (cc:1231): the host thread alone earns rewards ----
    io_m = is_op(SEM_IO)
    io_stack = torch.where(has_mod, mod_val, STACK_BX)
    value_out = _top(stacks, sps, io_stack)
    value_in = _pick(st.inputs, st.input_ptr % 3)
    plan(io_m, None, io_stack, value_in)
    io_host = io_m & (ti == 0)
    logic_id = tasks_ops.compute_logic_id(st.input_buf, st.input_buf_n,
                                          value_out)
    new_bonus, new_tc, new_rc, _, *new_pools = tasks_ops.apply_reactions(
        params, tasks_ops.env_tables_to_device(params, dev), io_host,
        logic_id, st.cur_bonus, st.cur_task_count, st.cur_reaction_count,
        st.input_buf, st.input_buf_n, value_out, st.resources, st.res_grid,
        st.deme_resources)
    pools = {}
    if res_ops.binds_pools(params):
        any_io = io_host.any()
        pools = {name: torch.where(any_io, new, getattr(st, name))
                 for name, new in zip(("resources", "res_grid",
                                       "deme_resources"), new_pools)}
    input_ptr = torch.where(io_m, st.input_ptr + 1, st.input_ptr)
    input_buf = torch.where(io_m[:, None], torch.stack(
        [value_in, st.input_buf[:, 0], st.input_buf[:, 1]], dim=1),
        st.input_buf)
    input_buf_n = torch.where(io_m, (st.input_buf_n + 1).clamp(max=3),
                              st.input_buf_n)
    cur_bonus = torch.where(io_host, new_bonus, st.cur_bonus)
    cur_task_count = torch.where(io_host[:, None], new_tc,
                                 st.cur_task_count)
    cur_reaction_count = torch.where(io_host[:, None], new_rc,
                                     st.cur_reaction_count)
    task_exe_total = st.task_exe_total + torch.where(
        io_host[:, None], new_tc - st.cur_task_count, 0)

    # ---- conditionals: skip the next instruction when false ----
    skip = ((is_op(SEM_IF_EQU) & (v1 != v2))
            | (is_op(SEM_IF_NEQU) & (v1 == v2))
            | (is_op(SEM_IF_LESS) & (v1 >= v2))
            | (is_op(SEM_IF_GTR) & (v1 <= v2)))

    # ---- Divide (host thread; Divide_Main cc:438) ----
    div_try = is_op(SEM_DIVIDE) & (ti == 0)
    wh_space = head_space[:, HEAD_WRITE]
    wh_pos = head_pos[:, HEAD_WRITE]
    child_size = wh_pos
    fsize = st.mem_len.clamp(min=1).to(f32)
    osr = fconst(params.offspring_size_range)
    # XLA rewrites the division by a constant as a product with its
    # float32 reciprocal
    min_sz = (fsize * prng.f32_reciprocal(osr)).to(i32).clamp(
        min=params.min_genome_len)
    max_sz = (fsize * osr).to(i32).clamp(max=L)
    div_m = (div_try & (wh_space == 1)
             & (child_size >= min_sz) & (child_size <= max_sz)
             & ~st.divide_pending & ~st.sterile)

    # ---- Inject (either thread; cc:1657) ----
    inj_space_ok = torch.where(t, wh_space == 3, wh_space == 1)
    inj_m = (is_op(SEM_INJECT) & inj_space_ok
             & (wh_pos >= MIN_INJECT_SIZE) & ~st.inject_pending)
    inj_src = torch.where(t[:, None], st.smt_aux[:, 1], st.smt_aux[:, 0])
    inj_mem = torch.where(inj_m[:, None], inj_src, st.inj_mem)
    inj_len = torch.where(inj_m, wh_pos, st.inj_len)

    # ---- apply the stack plan: pop first, then push ----
    slot_idx = torch.arange(STACK_DEPTH, device=dev)[None, None, :]
    stk_idx = torch.arange(4, device=dev)[None, :, None]
    do_pop = exec_mask & (pop_stack >= 0)
    pop_sp = _sp_of(sps, pop_stack.clamp(0, 3))
    pop_slot = ((stk_idx == pop_stack[:, None, None])
                & (slot_idx == pop_sp[:, None, None]) & do_pop[:, None, None])
    stacks = torch.where(pop_slot, 0, stacks)
    sps = torch.where((ar4 == pop_stack[:, None]) & do_pop[:, None],
                      (sps + 1) % STACK_DEPTH, sps)
    do_push = exec_mask & (push_stack >= 0)
    push_sp = (_sp_of(sps, push_stack.clamp(0, 3)) + STACK_DEPTH - 1) \
        % STACK_DEPTH
    push_slot = ((stk_idx == push_stack[:, None, None])
                 & (slot_idx == push_sp[:, None, None])
                 & do_push[:, None, None])
    stacks = torch.where(push_slot, push_val[:, None, None], stacks)
    sps = torch.where((ar4 == push_stack[:, None]) & do_push[:, None],
                      push_sp[:, None], sps)

    # ---- head updates ----
    onehot_h = ar4 == head_op[:, None]
    flow_pos = head_pos[:, HEAD_FLOW]
    flow_space = head_space[:, HEAD_FLOW]
    mv = is_op(SEM_HEAD_MOVE)
    mv_flow = mv & (head_op == HEAD_FLOW)
    mv_other = mv & ~mv_flow
    new_pos = torch.where(onehot_h & mv_other[:, None], flow_pos[:, None],
                          head_pos)
    new_space = torch.where(onehot_h & mv_other[:, None],
                            flow_space[:, None], head_space)
    nf_pos = torch.where(mv_flow, flow_pos + 1, new_pos[:, HEAD_FLOW])
    new_pos = torch.cat([new_pos[:, :HEAD_FLOW], nf_pos[:, None]], dim=1)
    new_pos = torch.where(onehot_h & is_op(SEM_HEAD_POP)[:, None],
                          headpop_val[:, None], new_pos)
    nf_pos = torch.where(srch_hit, found_pos,
                         torch.where(srch_miss, ip_p + 1,
                                     new_pos[:, HEAD_FLOW]))
    nf_space = torch.where(srch, ip_s, new_space[:, HEAD_FLOW])
    srch_size = (found_pos - ip_p) % ip_sz + lab_len + 1
    stacks, sps = _push2(stacks, sps, srch_hit & exec_mask, STACK_BX,
                         srch_size)
    stacks, sps = _push2(stacks, sps, srch_hit & exec_mask, STACK_AX,
                         lab_len)
    stacks, sps = _push2(stacks, sps, srch_miss & exec_mask, STACK_BX,
                         torch.zeros_like(lab_len))
    nf_pos = torch.where(setmem, 0, nf_pos)
    nf_space = torch.where(setmem, setmem_space, nf_space)
    new_pos = torch.cat([new_pos[:, :HEAD_FLOW], nf_pos[:, None]], dim=1)
    new_space = torch.cat([new_space[:, :HEAD_FLOW], nf_space[:, None]],
                          dim=1)
    adv = read_m | write_m
    new_pos = torch.where(onehot_h & adv[:, None], new_pos + 1, new_pos)

    # ---- memory-space writes (Inst-Write): one site per writing lane ----
    wm_any = write_m & exec_mask & (w_pos < L)
    w_idx = w_pos.clamp(0, L - 1).long()[:, None]
    w_byte = w_val.to(u8)

    def write(plane, k, byte):
        wm = wm_any & (w_space == k)
        old = plane.gather(1, w_idx)
        out = plane.clone()
        out.scatter_(1, w_idx, torch.where(wm[:, None], byte[:, None], old))
        return out

    def grown(size, k):
        wm = write_m & exec_mask & (w_space == k)
        return torch.where(wm, torch.maximum(size, w_sz), size)

    tape = write(st.tape, 0, w_byte | 0x80)
    mem_len = grown(st.mem_len, 0)
    pmem = write(st.pmem, 2, w_byte)
    pmem_len = grown(st.pmem_len, 2)
    aux0 = write(st.smt_aux[:, 0], 1, w_byte)
    aux1 = write(st.smt_aux[:, 1], 3, w_byte)
    len0 = grown(st.smt_aux_len[:, 0], 1)
    len1 = grown(st.smt_aux_len[:, 1], 3)
    # an injection resets the injecting thread's write buffer (cc:1693)
    reset0 = inj_m & (ti == 0)
    reset1 = inj_m & (ti == 1)
    aux0 = torch.where(reset0[:, None], 0, aux0).to(u8)
    aux1 = torch.where(reset1[:, None], 0, aux1).to(u8)
    smt_aux = torch.stack([aux0, aux1], dim=1)
    aux_len = torch.stack([torch.where(reset0, 1, len0),
                           torch.where(reset1, 1, len1)], dim=1)

    # ---- divide bookkeeping (the birth itself waits for the flush) ----
    off_len = torch.where(div_m, child_size, st.off_len)
    gestation = st.time_used + 1 - st.gestation_start
    merit_base = torch.minimum(st.mem_len, child_size).to(f32)
    new_merit = torch.where(div_m, merit_base * cur_bonus
                            if params.inherit_merit else merit_base,
                            st.merit)
    fitness = torch.where(div_m, new_merit / gestation.clamp(min=1).to(f32),
                          st.fitness)
    gestation_time = torch.where(div_m, gestation, st.gestation_time)
    generation = st.generation + div_m.to(i32)
    num_divides = st.num_divides + div_m.to(i32)
    last_task_count = torch.where(div_m[:, None], cur_task_count,
                                  st.last_task_count)
    cur_task_count = torch.where(div_m[:, None], 0, cur_task_count)
    cur_reaction_count = torch.where(div_m[:, None], 0, cur_reaction_count)
    last_bonus = torch.where(div_m, cur_bonus, st.last_bonus)
    cur_bonus = torch.where(div_m, fconst(params.default_bonus), cur_bonus)

    # ---- IP advance (Head-Move onto IP does not advance) ----
    mv_ip = mv_other & (head_op == HEAD_IP)
    ip_next = (ip_p + consumed + skip.to(i32) + 1) % ip_sz
    n_ip = torch.where(mv_ip, new_pos[:, HEAD_IP],
                       torch.where(exec_mask, ip_next, new_pos[:, HEAD_IP]))
    new_pos = torch.cat([n_ip[:, None], new_pos[:, HEAD_IP + 1:]], dim=1)
    new_pos = torch.where(div_m[:, None], 0, new_pos)
    new_space = torch.where(div_m[:, None], base_space[:, None], new_space)

    # ---- the active thread's state back into its slot ----
    t1 = (t & exec_mask)
    t0 = (~t & exec_mask)

    def scatter_thread(field, val):
        sel = [t0, t1]
        return torch.stack([
            torch.where(sel[j].reshape((n,) + (1,) * (val.dim() - 1)), val,
                        field[:, j]) for j in range(2)], dim=1)

    smt_head_pos = scatter_thread(st.smt_head_pos, new_pos)
    smt_head_space = scatter_thread(st.smt_head_space, new_space)
    smt_stacks = scatter_thread(st.smt_stacks, stacks[:, :3])
    smt_sp = scatter_thread(st.smt_sp, sps[:, :3])
    gstack = torch.where(exec_mask[:, None], stacks[:, 3], st.gstack)
    gsp = torch.where(exec_mask, sps[:, 3], st.gsp)

    # a divide resets the whole CPU (DIVIDE_METHOD 1 SPLIT, cc:492-496):
    # both threads' heads and stacks; the parasite is wiped
    smt_head_pos = torch.where(div_m[:, None, None], 0, smt_head_pos)
    smt_head_space = torch.where(div_m[:, None, None],
                                 smt_base_spaces(dev)[None], smt_head_space)
    smt_stacks = torch.where(div_m[:, None, None, None], 0, smt_stacks)
    smt_sp = torch.where(div_m[:, None, None], 0, smt_sp)
    gstack = torch.where(div_m[:, None], 0, gstack)
    gsp = torch.where(div_m, 0, gsp)
    parasite_active = st.parasite_active & ~div_m
    pmem_len = torch.where(div_m, 0, pmem_len)

    # ---- time and death ----
    charge = exec_mask.to(i32)
    time_used = st.time_used + charge
    died = exec_mask & (st.max_executed > 0) & (time_used >= st.max_executed)
    gestation_start = torch.where(div_m, time_used, st.gestation_start)

    return st.replace(
        tape=tape, mem_len=mem_len,
        smt_aux=smt_aux, smt_aux_len=aux_len, pmem=pmem, pmem_len=pmem_len,
        parasite_active=parasite_active,
        smt_stacks=smt_stacks, smt_sp=smt_sp, gstack=gstack, gsp=gsp,
        smt_head_pos=smt_head_pos, smt_head_space=smt_head_space,
        inject_pending=st.inject_pending | inj_m,
        inj_mem=inj_mem, inj_len=inj_len,
        divide_pending=st.divide_pending | div_m,
        off_start=torch.zeros_like(st.off_start), off_len=off_len,
        off_copied_size=torch.where(div_m, off_len, st.off_copied_size),
        merit=new_merit, fitness=fitness, gestation_time=gestation_time,
        generation=generation, num_divides=num_divides,
        gestation_start=gestation_start,
        last_task_count=last_task_count, cur_task_count=cur_task_count,
        cur_reaction_count=cur_reaction_count, cur_bonus=cur_bonus,
        task_exe_total=task_exe_total, last_bonus=last_bonus,
        input_ptr=input_ptr, input_buf=input_buf, input_buf_n=input_buf_n,
        time_used=time_used, cpu_cycles=st.cpu_cycles + charge,
        alive=st.alive & ~died, insts_executed=st.insts_executed + charge,
        **pools)
