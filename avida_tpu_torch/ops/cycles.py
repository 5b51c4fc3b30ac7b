"""The cycle interpreter: every CPU cycle of one update, one launch.

Counterpart of avida_tpu/ops/pallas_cycles.py.  The population lives in
the kernel's plane layout (organisms on the last axis):

  tape_t : int32[LP, N]  opcode words, byte j of word w = position 4w+j
  off_t  : int32[LP, N]  extracted-offspring words, same packing
  ivec   : int32[NI, N]  every int32 per-organism scalar, one row each
                         (site-flag bitplanes and task counters included)
  fvec   : f32[NF, N]    float phenotype scalars

This module keeps that layout byte for byte (pack_state / unpack_state and
the codecs equal the reference's), the launch wrapper `cycles`, its
hand-written CUDA kernel for Hopper (csrc/cycles.cu), the kernel's plain
PyTorch version `cycles_reference`, and `run_cycles`, the per-update
engine's pack -> launch -> unpack over a lane-permuted canonical state.
The first port of the kernel (csrc/cycles_simple.cu, `cycles_simple`) is
built into the same library as the yardstick chip_smoke.py times beside
it; no path launches it.

Kernel source note.  `cycles` replaces the Pallas kernel built by
pallas_cycles._make_kernel (launched by _launch_packed / run_packed).  One
launch must read tape_t, ivec and the phenotype rows of fvec (~97 MB at
320x320, L=384, ~0.03 ms on an H100) and write only the words it changes
(counted per run by chip_smoke.py); its real cost is the per-lane cycle
loop, which is integer work with data-dependent control flow and
per-lane tape indexing.  The Hopper design (csrc/cycles.cu's note): one
thread per organism; a CTA of `cta_lanes` lanes stages its tape tile,
site flags, stacks, read label and reaction counters in shared memory
with bulk copies; the CTAs of one reference block form a cluster that
reduces the block's maxima; h-search is a shift-and matcher.  The TPU's
masked-sum traversals, row-tile skipping, label window and select chains
(workarounds for missing per-lane gathers) are not carried over; the
results stay bit-identical.

Random stream: the reference's interpret-mode counter hash of (block
seed, cycle, tag, lane offset inside the B-lane block), with every block
of a launch sharing the launch seed (run_packed's interpret schedule).
Lane j of every block therefore draws the same bits -- a property of the
reference stream kept for exact equivalence.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

from avida_tpu_torch.models.heads import (
    HEAD_FLOW, HEAD_IP, HEAD_READ, HEAD_WRITE, MAX_LABEL_SIZE,
    MOD_HEAD, MOD_LABEL, MOD_NONE, MOD_REG,
    SEM_ADD, SEM_DEC, SEM_GET_HEAD, SEM_H_ALLOC, SEM_H_COPY, SEM_H_DIVIDE,
    SEM_H_DIVIDE_SEX, SEM_H_SEARCH, SEM_IF_LABEL, SEM_IF_LESS, SEM_IF_N_EQU,
    SEM_INC, SEM_IO, SEM_JMP_HEAD, SEM_MOV_HEAD, SEM_NAND, SEM_POP, SEM_PUSH,
    SEM_SET_FLOW, SEM_SHIFT_L, SEM_SHIFT_R, SEM_SUB, SEM_SWAP, SEM_SWAP_STK,
)
from avida_tpu_torch.utils import prng

# ---- ivec row layout (the reference's, pallas_cycles.py:104-156) ----
IV_MEM_LEN = 0
IV_ACTIVE_STACK = 1
IV_READ_LABEL_LEN = 2
IV_INPUT_PTR = 3
IV_INPUT_BUF_N = 4
IV_OUTPUT_BUF = 5
IV_TIME_USED = 6
IV_CPU_CYCLES = 7
IV_GEST_START = 8
IV_GEST_TIME = 9
IV_EXEC_SIZE = 10
IV_CHILD_COPIED = 11
IV_GENERATION = 12
IV_NUM_DIVIDES = 13
IV_OFF_START = 14
IV_OFF_LEN = 15
IV_OFF_COPIED = 16
IV_INSTS_EXEC = 17
IV_FLAGS = 18
IV_GENOME_LEN = 19
IV_MAX_EXEC = 20
IV_GRANTED = 21
IV_COPIED_SIZE = 22
IV_REGS = 23
IV_HEADS = 26
IV_SP = 30
IV_INPUT_BUF = 32
IV_INPUTS = 35
IV_READ_LABEL = 38
IV_STACKS = 48
IV_PW_POS = 68
IV_PW_VAL = 69
IV_PZ_START = 70
IV_PZ_END = 71
IV_COST_WAIT = 72
IV_FT_LO = 73
IV_FT_HI = 74
IV_OFF_SEX = 75
IV_EXEC_BM = 76

FV_MERIT = 0
FV_CUR_BONUS = 1
FV_FITNESS = 2
FV_LAST_BONUS = 3
FV_LAST_MERIT_BASE = 4
NF = 8

FLAG_MAL, FLAG_ALIVE, FLAG_DIVPEND, FLAG_STERILE = 1, 2, 4, 8
FLAG_NEWDIV = 16       # divided during this launch (cleared by the flush)

DEFAULT_BLOCK = 512
CHUNK = 64
# csrc/cycles.cu's capacity: tape words (32 sites each) and reactions
MAX_LW = 32
MAX_R = 32


def unsupported_reason(params) -> str | None:
    """Why the cycle kernel cannot run `params` (None = it can): the
    reference's kernel gate, gate for gate -- heads hardware
    (update.use_pallas_path) and pallas_cycles.eligible; the micro-step
    engine runs the rest."""
    if params.hw_type != 0:
        return "non-heads hardware"
    if params.max_cpu_threads > 1:
        return "MAX_CPU_THREADS > 1"
    if any(int(s) > SEM_H_DIVIDE_SEX for s in params.sem):
        return "thread or mating-type instructions"
    if params.energy_enabled:
        return "the energy model"
    if any(pi >= 0 for pi in params.proc_product_idx):
        return "reaction by-products"
    if any(params.task_math_name):
        return "math-family tasks"
    if any(r >= 0 for r in params.proc_res_idx):
        return "resource-bound reactions"
    return None


def use_kernel(params) -> bool:
    """The routing rule (the reference's update.use_pallas_path): does
    this configuration's update run its cycles in the kernel (True) or on
    the micro-step engine?  TPU_USE_PALLAS=2 always takes the micro-step
    engine; 1 demands the kernel and raises the reference's ValueError on
    a configuration the gate refuses; 0 takes the kernel wherever the gate
    admits the configuration -- on the card, and on the CPU as its plain
    version, where the reference's 0 takes its XLA engine (tests pick the
    reference engine they compare against explicitly)."""
    if params.hw_type != 0 or int(params.use_pallas) == 2:
        return False
    ok = unsupported_reason(params) is None
    if int(params.use_pallas) == 1 and not ok:
        raise ValueError(
            "TPU_USE_PALLAS=1 but this configuration disqualifies the "
            "Pallas cycle kernel (ops/pallas_cycles.eligible): a "
            "resource-bound reaction, by-products, math tasks, the "
            "energy model, MAX_CPU_THREADS > 1, or an instruction set "
            "with thread/mating-type instructions; use TPU_USE_PALLAS="
            "0 or 2")
    return ok


def kernel_limit_reason(params, device_type: str) -> str | None:
    """The CUDA kernel's own limits (csrc/cycles.cu: MAX_LW, MAX_R, the
    64-slot opcode tables, a CTA width that fits shared memory), checked
    before a run on a `device_type` device routed to the kernel (None =
    within them).  The CPU's plain version has none of them."""
    if device_type != "cuda" or not use_kernel(params):
        return None
    L = dims(params, 1, params.max_memory)[2]
    R = params.num_reactions
    hint = "; TPU_USE_PALLAS=2 runs this configuration on the micro-step " \
        "engine"
    if L > 32 * MAX_LW:
        return (f"the CUDA cycle kernel holds a tape of at most "
                f"{32 * MAX_LW} sites (TPU_MAX_MEMORY {params.max_memory} "
                f"pads to {L}){hint}")
    if R > MAX_R:
        return (f"the CUDA cycle kernel holds at most {MAX_R} reactions "
                f"(this environment has {R}){hint}")
    if params.num_insts > TAB_INSTS:
        return (f"the CUDA cycle kernel holds at most {TAB_INSTS} "
                f"instructions (this set has {params.num_insts}){hint}")
    B = dims(params, params.num_cells, params.max_memory)[0]
    try:
        cta_lanes(L, R, B)
    except ValueError as e:
        return f"the CUDA cycle kernel: {e}{hint}"
    return None


def has_costs(params) -> bool:
    """Does the instruction set carry costs or first-time costs (the
    kernel's cost engine)?"""
    return bool(params.inst_cost) or bool(params.inst_ft_cost)


def uniform_mutation(params) -> bool:
    """Are random-instruction draws uniform (every redundancy equal)?"""
    n = params.num_insts
    return not params.mut_cdf or all(
        abs(params.mut_cdf[k] - (k + 1) / n) < 1e-12 for k in range(n))


def _f32_bits(x) -> int:
    """The int32 bit pattern of float32(x)."""
    return int(torch.tensor(float(x), dtype=torch.float32).view(torch.int32))


def check_supported(params):
    reason = unsupported_reason(params)
    if reason is not None:
        raise NotImplementedError(
            f"the cycle interpreter does not port {reason} yet")


def layout(params, L):
    """(NI, LW, iv_copied_bm, iv_dyn) for a CHUNK-padded tape height L."""
    LW = L // 32
    iv_copied = IV_EXEC_BM + LW
    iv_dyn = IV_EXEC_BM + 2 * LW
    ni = iv_dyn + 4 * params.num_reactions
    return (ni + 7) & ~7, LW, iv_copied, iv_dyn


def dims(params, n, L0):
    """(B, n_pad, L): block width, padded lane count, padded tape height
    (one launch, the reference's single-shard dims)."""
    B = min(DEFAULT_BLOCK, max(128, 1 << (n - 1).bit_length()))
    n_pad = ((n + B - 1) // B) * B
    L = ((L0 + CHUNK - 1) // CHUNK) * CHUNK
    return B, n_pad, L


# ---- codecs (pallas_cycles.py:1413-1487) ----

def pack_words(tape, L):
    """uint8[N, L] -> int32[N, L//4], byte j of word w = position 4w+j."""
    return tape.contiguous().view(torch.int32).reshape(tape.shape[0], L // 4)


def unpack_words(words, L):
    """int32[N, L//4] -> uint8[N, L] (inverse of pack_words)."""
    return words.contiguous().view(torch.uint8).reshape(words.shape[0], L)


BITS5_PER_WORD = 6


def words5(L: int) -> int:
    return -(-L // BITS5_PER_WORD)


def pack_words5(tape, L):
    """uint8[N, L] opcodes (< 32) -> int32[N, ceil(L/6)], 5-bit field f of
    word w = position 6w+f."""
    n = tape.shape[0]
    w5 = words5(L)
    t = torch.zeros((n, w5 * BITS5_PER_WORD), dtype=torch.int32,
                    device=tape.device)
    t[:, :L] = tape.to(torch.int32) & 0x1F
    sh = torch.arange(BITS5_PER_WORD, dtype=torch.int32,
                      device=tape.device) * 5
    return (t.reshape(n, w5, BITS5_PER_WORD) << sh).sum(
        dim=2, dtype=torch.int32)


def unpack_words5(words, L):
    n = words.shape[0]
    sh = torch.arange(BITS5_PER_WORD, dtype=torch.int32,
                      device=words.device) * 5
    g = (words[:, :, None] >> sh) & 0x1F
    return g.reshape(n, -1)[:, :L].to(torch.uint8)


def _to_i32(x):
    """int64 holding a uint32 bit pattern -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def flag_to_words(tape, bit, L):
    """Site flag `bit` of uint8[N, L] -> int32[N, L//32] (bit j of word w
    = flag of site 32w+j)."""
    n = tape.shape[0]
    f = ((tape.to(torch.int64) >> bit) & 1).reshape(n, L // 32, 32)
    sh = torch.arange(32, dtype=torch.int64, device=tape.device)
    return _to_i32((f << sh).sum(dim=2))


def words_to_flag(words, bit, L):
    """int32[N, L//32] -> uint8[N, L] with the flag at `bit`."""
    n = words.shape[0]
    sh = torch.arange(32, dtype=torch.int64, device=words.device)
    f = (words.to(torch.int64)[:, :, None] >> sh) & 1
    return (f << bit).reshape(n, L).to(torch.uint8)


def pack_state(params, st, granted, perm=None):
    """PopulationState -> (tape_t, off_t, ivec, fvec), lanes padded to the
    block quantum (padded lanes are dead).  perm (int32[N], lane ->
    organism) packs organism perm[s] into kernel lane s (the budget-aware
    lane permutation, ops/update.perm_phase); None = identity."""
    n, L0 = st.tape.shape
    R = params.num_reactions
    B, n_pad, L = dims(params, n, L0)
    NI, LW, IV_COPIED_BM, IV_DYN = layout(params, L)
    dev = st.tape.device
    idx = None if perm is None else perm.long()

    def rows(x):
        """x with organism perm[s] in row s: a major-axis gather."""
        return x if idx is None else x[idx]

    def padl(x):
        out = torch.zeros((n_pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[:n] = x
        return out

    tape_p = torch.zeros((n, L), dtype=torch.uint8, device=dev)
    tape_p[:, :L0] = rows(st.tape)
    opc_t = padl(pack_words(tape_p & 63, L)).T.contiguous()
    exec_w = flag_to_words(tape_p, 6, L)
    cop_w = flag_to_words(tape_p, 7, L)
    off_p = torch.zeros((n, L), dtype=torch.uint8, device=dev)
    off_p[:, :L0] = rows(st.off_tape)
    off_t = padl(pack_words(off_p, L)).T.contiguous()

    ivec = torch.zeros((NI, n_pad), dtype=torch.int32, device=dev)

    def setrow(i, x):
        ivec[i, :n] = rows(x).to(torch.int32)

    setrow(IV_MEM_LEN, st.mem_len)
    setrow(IV_ACTIVE_STACK, st.active_stack)
    setrow(IV_READ_LABEL_LEN, st.read_label_len)
    setrow(IV_INPUT_PTR, st.input_ptr)
    setrow(IV_INPUT_BUF_N, st.input_buf_n)
    setrow(IV_OUTPUT_BUF, st.output_buf)
    setrow(IV_TIME_USED, st.time_used)
    setrow(IV_CPU_CYCLES, st.cpu_cycles)
    setrow(IV_GEST_START, st.gestation_start)
    setrow(IV_GEST_TIME, st.gestation_time)
    setrow(IV_EXEC_SIZE, st.executed_size)
    setrow(IV_CHILD_COPIED, st.child_copied_size)
    setrow(IV_GENERATION, st.generation)
    setrow(IV_NUM_DIVIDES, st.num_divides)
    setrow(IV_OFF_START, st.off_start)
    setrow(IV_OFF_LEN, st.off_len)
    setrow(IV_OFF_COPIED, st.off_copied_size)
    setrow(IV_INSTS_EXEC, st.insts_executed)
    setrow(IV_FLAGS, st.mal_active.int() * FLAG_MAL
           + st.alive.int() * FLAG_ALIVE
           + st.divide_pending.int() * FLAG_DIVPEND
           + st.sterile.int() * FLAG_STERILE)
    setrow(IV_GENOME_LEN, st.genome_len)
    setrow(IV_MAX_EXEC, st.max_executed)
    setrow(IV_GRANTED, granted)
    setrow(IV_COPIED_SIZE, st.copied_size)
    for k in range(3):
        setrow(IV_REGS + k, st.regs[:, k])
        setrow(IV_INPUT_BUF + k, st.input_buf[:, k])
        setrow(IV_INPUTS + k, st.inputs[:, k])
    for k in range(4):
        setrow(IV_HEADS + k, st.heads[:, k])
    for k in range(2):
        setrow(IV_SP + k, st.sp[:, k])
    for k in range(MAX_LABEL_SIZE):
        setrow(IV_READ_LABEL + k, st.read_label[:, k])
    for s_ in range(2):
        for d in range(10):
            setrow(IV_STACKS + s_ * 10 + d, st.stacks[:, s_, d])
    setrow(IV_COST_WAIT, st.cost_wait)
    setrow(IV_FT_LO, st.ft_paid_lo)
    setrow(IV_FT_HI, st.ft_paid_hi)
    setrow(IV_OFF_SEX, st.off_sex)
    ivec[IV_PW_POS] = -1
    ivec[IV_EXEC_BM:IV_EXEC_BM + LW, :n] = exec_w.T
    ivec[IV_COPIED_BM:IV_COPIED_BM + LW, :n] = cop_w.T
    for r in range(R):
        setrow(IV_DYN + r, st.cur_task_count[:, r])
        setrow(IV_DYN + R + r, st.cur_reaction_count[:, r])
        setrow(IV_DYN + 2 * R + r, st.last_task_count[:, r])
        setrow(IV_DYN + 3 * R + r, st.task_exe_total[:, r])

    fvec = torch.zeros((NF, n_pad), dtype=torch.float32, device=dev)
    for i, x in enumerate((st.merit, st.cur_bonus, st.fitness,
                           st.last_bonus, st.last_merit_base)):
        fvec[i, :n] = rows(x)
    return opc_t, off_t, ivec, fvec


def unpack_state(params, st, packed, inv=None, restore_ro=False):
    """Kernel layout -> PopulationState, keeping the fields of `st` the
    planes do not carry.  inv (int32[N], organism -> lane) undoes
    pack_state's perm.  restore_ro=True also reads back the rows the
    kernel never writes but the packed birth flush does (genome_len,
    copied_size, max_executed, inputs); the per-update path keeps them
    from `st`."""
    tape_o, off_o, ivec_o, fvec_o = packed
    if inv is not None:
        idx = inv.long()
        tape_o, off_o, ivec_o, fvec_o = (t[:, idx] for t in packed)
    n, L0 = st.tape.shape
    R = params.num_reactions
    L = tape_o.shape[0] * 4
    NI, LW, IV_COPIED_BM, IV_DYN = layout(params, L)
    iv = ivec_o[:, :n]
    fv = fvec_o[:, :n]

    def rows(i, k):
        return iv[i:i + k].T.contiguous()

    opc = unpack_words(tape_o.T[:n], L)
    tape = (opc | words_to_flag(rows(IV_EXEC_BM, LW), 6, L)
            | words_to_flag(rows(IV_COPIED_BM, LW), 7, L))[:, :L0]
    flags = iv[IV_FLAGS]
    ro = {}
    if restore_ro:
        ro = dict(genome_len=iv[IV_GENOME_LEN].clone(),
                  copied_size=iv[IV_COPIED_SIZE].clone(),
                  max_executed=iv[IV_MAX_EXEC].clone(),
                  inputs=rows(IV_INPUTS, 3))
    return st.replace(
        **ro,
        tape=tape.contiguous(),
        off_tape=unpack_words(off_o.T[:n], L)[:, :L0].contiguous(),
        mem_len=iv[IV_MEM_LEN].clone(),
        regs=rows(IV_REGS, 3),
        heads=rows(IV_HEADS, 4),
        stacks=rows(IV_STACKS, 20).reshape(n, 2, 10),
        sp=rows(IV_SP, 2),
        active_stack=iv[IV_ACTIVE_STACK].clone(),
        read_label=rows(IV_READ_LABEL, MAX_LABEL_SIZE).to(torch.int8),
        read_label_len=iv[IV_READ_LABEL_LEN].clone(),
        mal_active=(flags & FLAG_MAL) != 0,
        alive=(flags & FLAG_ALIVE) != 0,
        sterile=(flags & FLAG_STERILE) != 0,
        input_ptr=iv[IV_INPUT_PTR].clone(),
        input_buf=rows(IV_INPUT_BUF, 3),
        input_buf_n=iv[IV_INPUT_BUF_N].clone(),
        output_buf=iv[IV_OUTPUT_BUF].clone(),
        merit=fv[FV_MERIT].clone(), cur_bonus=fv[FV_CUR_BONUS].clone(),
        cur_task_count=rows(IV_DYN, R),
        cur_reaction_count=rows(IV_DYN + R, R),
        last_task_count=rows(IV_DYN + 2 * R, R),
        task_exe_total=rows(IV_DYN + 3 * R, R),
        time_used=iv[IV_TIME_USED].clone(),
        cpu_cycles=iv[IV_CPU_CYCLES].clone(),
        gestation_start=iv[IV_GEST_START].clone(),
        gestation_time=iv[IV_GEST_TIME].clone(),
        fitness=fv[FV_FITNESS].clone(), last_bonus=fv[FV_LAST_BONUS].clone(),
        last_merit_base=fv[FV_LAST_MERIT_BASE].clone(),
        executed_size=iv[IV_EXEC_SIZE].clone(),
        child_copied_size=iv[IV_CHILD_COPIED].clone(),
        generation=iv[IV_GENERATION].clone(),
        num_divides=iv[IV_NUM_DIVIDES].clone(),
        divide_pending=(flags & FLAG_DIVPEND) != 0,
        off_start=iv[IV_OFF_START].clone(), off_len=iv[IV_OFF_LEN].clone(),
        off_copied_size=iv[IV_OFF_COPIED].clone(),
        off_sex=iv[IV_OFF_SEX] != 0,
        insts_executed=iv[IV_INSTS_EXEC].clone(),
        cost_wait=iv[IV_COST_WAIT].clone(),
        ft_paid_lo=iv[IV_FT_LO].clone(), ft_paid_hi=iv[IV_FT_HI].clone(),
    )


# ---- the launch: seed schedule, wrapper, counter ----

def kernel_seed(key):
    """The launch's PRNG seed: randint(key, (1,), 0, 2**31 - 1)."""
    return prng.randint(key, (1,), 0, 2**31 - 1)


def block_seeds(key, n_pad, B):
    """Per-block seeds of a solo launch: run_packed's interpret schedule,
    where every block of the (single) shard carries the launch seed."""
    return kernel_seed(key).expand(n_pad // B).contiguous()


def world_seed_bases(k_steps):
    """int32[W] seed bases of a stacked launch (pallas_cycles.py:1684):
    world w's base is the kernel_seed its solo launch draws from its own
    k_steps key, which makes the stacked launch equal, world by world, to
    the W solo launches.  `k_steps` is a sequence of W keys."""
    return torch.cat([kernel_seed(k) for k in k_steps])


def stacked_block_seeds(world_seeds, n_w, B):
    """Per-block seeds of a stacked launch: run_packed_stacked's interpret
    schedule, where every block of world w carries world w's base."""
    return world_seeds.repeat_interleave(n_w // B)


# ---- the plain PyTorch version ----

_M32 = 0xFFFFFFFF


def _u32(x):
    return x.to(torch.int64) & _M32


def _hash24(seed_lane, s, tag):
    """The reference's interpret-mode 24-bit counter hash
    (pallas_cycles.py:478-484), in uint32 arithmetic."""
    x = (seed_lane + s * 0x9E3779B9 + tag * 40503) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return (x ^ (x >> 16)) & 0xFFFFFF


def _bytemask(m):
    """uint32 mask of the m lowest bytes, m in [0, 4] (int64 tensor)."""
    return torch.where(m >= 4, _M32, (1 << (8 * m.clamp(0, 3))) - 1)


def _popcount(x):
    x = x & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _range_mask(lw_rows, lo, hi):
    """uint32[LW, N] bitmask of site positions [lo, hi)."""
    base = lw_rows * 32
    lo_w = (lo[None] - base).clamp(0, 32)
    hi_w = (hi[None] - base).clamp(0, 32)
    m_lo = torch.where(lo_w >= 32, 0, (_M32 << lo_w.clamp(max=31)) & _M32)
    m_hi = torch.where(hi_w >= 32, 0, (_M32 << hi_w.clamp(max=31)) & _M32)
    return m_lo & ~m_hi & _M32


def _logic_id(i0, i1, i2, n_in, out):
    """tasks.compute_logic_id on lane vectors (cTaskLib.cc:369): the eight
    input combinations' truth-table rows at once, int64 values."""
    c = torch.arange(8, device=i0.device)[:, None]
    m = (torch.where((c & 1) != 0, i0[None], ~i0[None])
         & torch.where((c & 2) != 0, i1[None], ~i1[None])
         & torch.where((c & 4) != 0, i2[None], ~i2[None]))      # [8, N]
    cnt = _popcount(m)
    ones = _popcount(m & out[None])
    ok = ((ones == 0) | (ones == cnt)).all(dim=0)
    lo = list((ones > 0).to(torch.int64).unbind(0))
    lo[1] = torch.where(n_in < 1, lo[0], lo[1])
    lo[2] = torch.where(n_in < 2, lo[0], lo[2])
    lo[3] = torch.where(n_in < 2, lo[1], lo[3])
    for k in range(4):
        lo[4 + k] = torch.where(n_in < 3, lo[k], lo[4 + k])
    logic = (torch.stack(lo) << c).sum(dim=0)
    return torch.where(ok, logic, -1)


def _adjust1(pos, mlen):
    return torch.where(pos >= mlen, pos - mlen, pos)


def _wrap32(x):
    """int64 -> the int32 value with the same low 32 bits (as int64)."""
    x = x & _M32
    return torch.where(x >= 2**31, x - 2**32, x)


def label_search(codes, lbl_c, label_len, mlen):
    """h-search's scan of start positions: int64[N], each lane's first
    position q with q + label_len <= mlen whose tape codes spell the
    label (L where none does).  codes is int64[L + MAX_LABEL_SIZE, N], a
    nop byte's register or 3 for any other byte and past the tape; lbl_c
    holds the label's MAX_LABEL_SIZE complement codes (int64[N] each),
    of which the first label_len count."""
    L = codes.shape[0] - MAX_LABEL_SIZE
    q = torch.arange(L, dtype=torch.int64, device=codes.device)[:, None]
    match = q + label_len[None] <= mlen[None]
    for k in range(MAX_LABEL_SIZE):
        match = match & ((k >= label_len[None])
                         | (codes[k:k + L] == lbl_c[k][None]))
    return torch.where(match, q, L).min(dim=0).values


def cycles_reference(params, planes, seeds, num_steps, B):
    """Plain lockstep version of the cycle kernel, in place on the four
    planes (returned).  `seeds` is int32[n_pad // B], one seed per B-lane
    block; `num_steps` is the static step cap.  Translates the reference
    kernel body (pallas_cycles.py:458-1372) line by line, with the tape
    reads as gathers and the deferred tape writes applied at the end of
    each cycle (nothing reads them earlier)."""
    check_supported(params)
    tape_t, off_t, ivec, fvec = planes
    LP, N = tape_t.shape
    L = LP * 4
    L0 = params.max_memory
    R = params.num_reactions
    NI, LW, IV_COPIED_BM, IV_DYN = layout(params, L)
    ni = params.num_insts
    dev = tape_t.device
    i64 = torch.int64

    def itab(vals):
        return torch.tensor([int(v) for v in vals], dtype=i64, device=dev)

    sem_tab = itab(params.sem)
    mod_tab = itab(params.mod_kind)
    def_tab = itab(params.default_op)
    nop_tab = torch.tensor([bool(x) for x in params.is_nop], device=dev)
    nmod_tab = itab(params.nop_mod)
    # 2-bit complement code of every tape byte for h-search: the nop's
    # register for a nop opcode, 3 for anything else
    code_tab = torch.full((256,), 3, dtype=i64, device=dev)
    code_tab[:ni] = torch.where(nop_tab, nmod_tab, 3)
    costs = has_costs(params)
    if costs:
        cost_tab = itab(params.inst_cost or (0,) * ni)
        ftc_tab = itab(params.inst_ft_cost or (0,) * ni)
    if params.inst_prob_fail:
        pf_tab = torch.tensor(params.inst_prob_fail, dtype=torch.float32,
                              device=dev)
    if params.inst_addl_time_cost:
        addl_tab = itab(params.inst_addl_time_cost)
    weighted = not uniform_mutation(params)
    if weighted:
        cdf_tab = torch.tensor(params.mut_cdf[:ni - 1], dtype=torch.float32,
                               device=dev)
    lane = torch.arange(N, dtype=i64, device=dev)
    seed_lane = (_u32(seeds).repeat_interleave(B) + (lane % B)) & _M32
    lw_rows = torch.arange(LW, dtype=i64, device=dev)[:, None]
    word_rows = torch.arange(LP, dtype=i64, device=dev)[:, None]

    iv = ivec.to(i64)                       # working copy, int64 values
    fv = fvec.clone()
    tw = _u32(tape_t)                       # uint32 words as int64
    granted = iv[IV_GRANTED]
    gmax = granted.reshape(-1, B).max(dim=1).values.clamp(max=num_steps)
    trips = ((gmax + 1) // 2 * 2).repeat_interleave(B)
    logic_mask = [torch.tensor(m, dtype=torch.bool, device=dev)
                  for m in params.task_logic_mask]
    copy_p = torch.tensor(params.copy_mut_prob, dtype=torch.float32)

    def byte_at(pos):
        w = tw.gather(0, (pos >> 2)[None])[0]
        return (w >> ((pos & 3) * 8)) & 0xFF

    def row(i):
        # a copy: the rows are rewritten in place later in the cycle, and
        # a name bound here must keep the value of the cycle's start, as
        # in the reference (a view here let the deferred-write reach see
        # the advanced write head)
        return iv[i].clone()

    # reach of the previous cycle's deferred tape writes (the reference's
    # pend_b), per lane
    pend = torch.maximum(iv[IV_PW_POS] + 1, iv[IV_PZ_END])

    def block_max(x):
        return x.reshape(-1, B).max(dim=1).values.repeat_interleave(B)

    def io_tasks(io_m, in_ptr, value_in, ibuf, ibuf_n, cur_bonus, val):
        """IO with logic-id tasks and reaction rewards (pallas_cycles.py
        :973-1064) for the lanes in io_m."""
        i0 = torch.where(ibuf_n > 0, ibuf[0], 0)
        i1 = torch.where(ibuf_n > 1, ibuf[1], 0)
        i2 = torch.where(ibuf_n > 2, ibuf[2], 0)
        lid = _logic_id(i0, i1, i2, ibuf_n, val)
        lid_ok = (lid >= 0) & io_m
        lidc = lid.clamp(0, 255)
        new_bonus = cur_bonus.clone()
        add_sum = torch.zeros(N, dtype=torch.float32, device=dev)
        performed_l, rewarded_l = [], []
        for r in range(R):
            tc = row(IV_DYN + r)
            performed = logic_mask[r][lidc] & lid_ok
            in_window = ((tc >= int(params.min_task_count[r]))
                         & (tc < int(params.max_task_count[r])))
            req_ok = torch.ones_like(performed)
            for d in range(R):
                if params.req_reaction_mask[r][d]:
                    req_ok = req_ok & (row(IV_DYN + R + d) != 0)
                if params.noreq_reaction_mask[r][d]:
                    req_ok = req_ok & (row(IV_DYN + R + d) == 0)
            rewarded = performed & in_window & req_ok
            v = float(params.proc_value[r])
            t = int(params.proc_type[r])
            if t == 2:
                new_bonus = torch.where(rewarded, new_bonus * float(
                    torch.tensor(2.0 ** v, dtype=torch.float32)), new_bonus)
            elif t == 1:
                if v != 0.0:
                    new_bonus = torch.where(rewarded, new_bonus * float(
                        torch.tensor(v, dtype=torch.float32)), new_bonus)
            else:
                add_sum = add_sum + torch.where(
                    rewarded, torch.tensor(v, dtype=torch.float32), 0.0)
            performed_l.append(performed.to(i64))
            rewarded_l.append(rewarded.to(i64))
        new_bonus = new_bonus + add_sum
        return (performed_l, rewarded_l,
                torch.where(io_m, in_ptr + 1, in_ptr),
                torch.where(io_m, value_in, ibuf[0]),
                torch.where(io_m, ibuf[0], ibuf[1]),
                torch.where(io_m, ibuf[1], ibuf[2]),
                torch.where(io_m, (ibuf_n + 1).clamp(max=3), ibuf_n),
                torch.where(io_m, val, row(IV_OUTPUT_BUF)),
                torch.where(io_m, new_bonus, cur_bonus))

    for s in range(int(trips.max()) if N else 0):
        looping = s < trips
        mlen = row(IV_MEM_LEN).clamp(min=1)
        flags = row(IV_FLAGS)
        alive = (flags & FLAG_ALIVE) != 0
        mal_active = (flags & FLAG_MAL) != 0
        divide_pending = (flags & FLAG_DIVPEND) != 0
        exec_m = alive & (s < granted) & ~divide_pending & looping
        # the word rows the reference's row-tile traversal reads this
        # cycle: TCH=16-row tiles below the live extent of the executing
        # lanes and the pending writes (pallas_cycles.py:536-586)
        bound_w = (block_max(torch.maximum(torch.where(exec_m, mlen, 1),
                                           pend)) + 3) >> 2
        ip, rp, wp = (row(IV_HEADS + HEAD_IP), row(IV_HEADS + HEAD_READ),
                      row(IV_HEADS + HEAD_WRITE))
        parent_size = rp
        child_end = torch.where(wp == 0, mlen, wp)
        child_size = child_end - parent_size

        s_ip = byte_at(ip) & 63
        s_rp = byte_at(rp) & 63
        lab = []
        for k in range(MAX_LABEL_SIZE):
            p = ip + 1 + k
            pa = torch.where(p >= mlen, p - mlen, p)
            lab.append(byte_at(pa) & 63)
        cur_op = s_ip.clamp(0, ni - 1)
        ebm = _u32(iv[IV_EXEC_BM:IV_EXEC_BM + LW])
        cbm = _u32(iv[IV_COPIED_BM:IV_COPIED_BM + LW])
        ip_exec_already = ((ebm.gather(0, (ip >> 5)[None])[0]
                            >> (ip & 31)) & 1) != 0

        # cost engine (pallas_cycles.py:617-652): a cost-c instruction
        # waits c - 1 cycles and executes on the last; ft_cost is a
        # one-time surcharge per opcode
        if costs:
            ft_lo, ft_hi = row(IV_FT_LO), row(IV_FT_HI)
            ft_bit = torch.where(cur_op < 32,
                                 (ft_lo >> cur_op.clamp(0, 31)) & 1,
                                 (ft_hi >> (cur_op - 32).clamp(0, 31)) & 1)
            total_cost = cost_tab[cur_op].clamp(min=1) + torch.where(
                ft_bit == 0, ftc_tab[cur_op], 0)
            cw = row(IV_COST_WAIT)
            eff_exec = exec_m & ((cw == 1) | ((cw == 0) & (total_cost <= 1)))
            cost_wait = torch.where(exec_m, torch.where(
                cw > 0, cw - 1, torch.where(total_cost > 1, total_cost - 1,
                                            0)), cw)
            pay_ft = eff_exec & (ft_bit == 0)
            one = torch.ones_like(cur_op)
            ft_lo = torch.where(pay_ft & (cur_op < 32), _wrap32(
                ft_lo | (one << cur_op.clamp(0, 31))), ft_lo)
            ft_hi = torch.where(pay_ft & (cur_op >= 32), _wrap32(
                ft_hi | (one << (cur_op - 32).clamp(0, 31))), ft_hi)
        else:
            eff_exec = exec_m
        # execution failure (:654-662): costs paid, effect suppressed
        if params.inst_prob_fail:
            u_fail = _hash24(seed_lane, s, 2).to(torch.float32) \
                * (1.0 / (1 << 24))
            failed = eff_exec & (u_fail < pf_tab[cur_op])
        else:
            failed = torch.zeros_like(exec_m)

        sem = torch.where(eff_exec & ~failed, sem_tab[cur_op], -1)
        # the modifier keys off exec_m, not eff_exec (:664-669)
        mod_kind = torch.where(exec_m & ~failed, mod_tab[cur_op], MOD_NONE)
        default_operand = def_tab[cur_op]

        next_op = lab[0].clamp(0, ni - 1)
        wants_mod = (mod_kind == MOD_REG) | (mod_kind == MOD_HEAD)
        has_mod = wants_mod & nop_tab[next_op]
        operand = torch.where(has_mod, nmod_tab[next_op], default_operand)
        consumed = has_mod.to(i64)
        next_pos = _adjust1(ip + 1, mlen)

        has_label = mod_kind == MOD_LABEL
        run = torch.ones_like(cur_op)
        label_len = torch.zeros_like(cur_op)
        lab_vals = []
        for k in range(MAX_LABEL_SIZE):
            v = lab[k].clamp(0, ni - 1)
            run = run * (nop_tab[v] & ((k + 1) <= (mlen - 1))).to(i64)
            label_len = label_len + run
            lab_vals.append(nmod_tab[v])
        label_len = torch.where(has_label, label_len, 0)
        consumed = torch.where(has_label, label_len, consumed)
        lbl_c = [torch.where(v >= 2, v - 2, v + 1) for v in lab_vals]

        regs = [row(IV_REGS + k) for k in range(3)]
        rsel = torch.stack(regs + [torch.zeros_like(ip)])
        val = rsel.gather(0, operand[None])[0]
        nr = operand + 1
        next_reg = torch.where(nr >= 3, nr - 3, nr)
        val2 = rsel.gather(0, next_reg[None])[0]
        bx, cx = regs[1], regs[2]

        def is_op(x):
            return sem == x

        if params.copy_mut_prob > 0:
            u_copy = _hash24(seed_lane, s, 0).to(torch.float32) \
                * (1.0 / (1 << 24))
            r_bits = _hash24(seed_lane, s, 1)
            if weighted:
                # inverse CDF over the float32-rounded cumulative weights
                u_inst = r_bits.to(torch.float32) * (1.0 / (1 << 24))
                rand_inst = (u_inst[None] >= cdf_tab[:, None]).sum(
                    dim=0).to(i64)
            else:
                rand_inst = r_bits % ni
        else:
            u_copy = torch.ones(N, dtype=torch.float32, device=dev)
            rand_inst = torch.zeros_like(ip)

        # stacks
        a_stk = row(IV_ACTIVE_STACK)
        sp0, sp1 = row(IV_SP), row(IV_SP + 1)
        spa = torch.where(a_stk == 0, sp0, sp1)
        push_m, pop_m = is_op(SEM_PUSH), is_op(SEM_POP)
        sp_push = torch.where(spa == 0, 9, spa - 1)
        stacks = iv[IV_STACKS:IV_STACKS + 20].clone()
        cur_slot = a_stk * 10 + spa
        push_slot = a_stk * 10 + sp_push
        pop_val = stacks.gather(0, cur_slot[None])[0]
        srows = torch.arange(20, dtype=i64, device=dev)[:, None]
        stacks = torch.where((srows == push_slot) & push_m, val, stacks)
        stacks = torch.where((srows == cur_slot) & pop_m, 0, stacks)
        new_spa = torch.where(push_m, sp_push, torch.where(
            pop_m, torch.where(spa == 9, 0, spa + 1), spa))
        sp_out0 = torch.where(a_stk == 0, new_spa, sp0)
        sp_out1 = torch.where(a_stk != 0, new_spa, sp1)
        active_stack = torch.where(is_op(SEM_SWAP_STK), 1 - a_stk, a_stk)

        # h-search: first position whose nop codes spell the complement
        srch = is_op(SEM_H_SEARCH)
        q_found = torch.full_like(ip, L)
        searching = srch & (label_len > 0)
        if bool(searching.any()):
            tb = tw.to(torch.int32).T.contiguous().view(torch.uint8)
            codes = torch.full((L + MAX_LABEL_SIZE, N), 3, dtype=i64,
                               device=dev)
            codes[:L] = code_tab[tb.T.to(i64)]
            q_found = torch.where(searching, label_search(
                codes, lbl_c, label_len, mlen), q_found)
        found = q_found < L
        ip_after_label = _adjust1(ip + label_len, mlen)
        search_head = torch.where(found, q_found + label_len - 1,
                                  ip_after_label)
        search_bx = search_head - ip_after_label
        new_flow_srch = _adjust1(search_head + 1, mlen)

        # if-label
        rl_len = row(IV_READ_LABEL_LEN)
        read_label = iv[IV_READ_LABEL:IV_READ_LABEL + MAX_LABEL_SIZE].clone()
        rl_match = rl_len == label_len
        for k in range(MAX_LABEL_SIZE):
            rl_match = rl_match & ((read_label[k] == lbl_c[k])
                                   | (k >= label_len))
        skip = ((is_op(SEM_IF_N_EQU) & (val == val2))
                | (is_op(SEM_IF_LESS) & (val >= val2))
                | (is_op(SEM_IF_LABEL) & ~rl_match))

        # h-alloc
        osr = torch.tensor(params.offspring_size_range, dtype=torch.float32)
        old_len = mlen
        alloc_size = torch.minimum(
            (osr * old_len.to(torch.float32)).to(i64), L0 - old_len)
        alloc_ok = alloc_size >= 1
        if params.require_allocate:
            alloc_ok = alloc_ok & ~mal_active
        alloc_ok = alloc_ok & (old_len <= (alloc_size.to(torch.float32)
                                           * osr).to(i64))
        alloc_ok = alloc_ok & ~divide_pending
        alloc_m = is_op(SEM_H_ALLOC) & alloc_ok
        new_len_alloc = old_len + alloc_size
        mem_len = torch.where(alloc_m, new_len_alloc, row(IV_MEM_LEN))
        new_mal = mal_active | alloc_m

        # h-copy
        copy_m = is_op(SEM_H_COPY)
        read_inst = s_rp.clamp(0, ni - 1)
        do_mut = copy_m & (u_copy < copy_p)
        written = torch.where(do_mut, rand_inst, read_inst)
        ri_isnop = nop_tab[read_inst]
        can_append = ri_isnop & copy_m & (rl_len < MAX_LABEL_SIZE)
        rl_rows = torch.arange(MAX_LABEL_SIZE, dtype=i64, device=dev)[:, None]
        read_label = torch.where((rl_rows == rl_len) & can_append,
                                 nmod_tab[read_inst], read_label)
        read_label_len = torch.where(~ri_isnop & copy_m, 0, torch.where(
            can_append, rl_len + 1, rl_len))

        # h-divide
        div_sex = is_op(SEM_H_DIVIDE_SEX)
        div_m0 = is_op(SEM_H_DIVIDE) | div_sex
        gsize = row(IV_GENOME_LEN)
        fsize = gsize.to(torch.float32)
        # XLA rewrites the division by a constant as a product with its
        # float32 reciprocal
        min_sz = torch.clamp(
            (fsize * prng.f32_reciprocal(params.offspring_size_range)).to(
                i64), min=params.min_genome_len)
        max_sz = torch.clamp((fsize * osr).to(i64), max=L0)
        if bool(div_m0.any()):
            below_p = _range_mask(lw_rows, torch.zeros_like(ip), parent_size)
            child_z = _range_mask(lw_rows, parent_size, child_end)
            exec_count = _popcount(ebm & below_p).sum(dim=0) + torch.where(
                div_m0 & ~ip_exec_already & (ip < parent_size), 1, 0)
            copied_count = _popcount(cbm & child_z).sum(dim=0)
        else:
            # read only under div_m, which no lane has this cycle
            exec_count = copied_count = torch.zeros_like(ip)
        sterile = (flags & FLAG_STERILE) != 0
        mel = torch.tensor(params.min_exe_lines, dtype=torch.float32)
        mcl = torch.tensor(params.min_copied_lines, dtype=torch.float32)
        viable = (~sterile
                  & (child_size >= min_sz) & (child_size <= max_sz)
                  & (parent_size >= min_sz) & (parent_size <= max_sz)
                  & (exec_count >= (parent_size.to(torch.float32) * mel
                                    ).to(i64))
                  & (copied_count >= (child_size.to(torch.float32) * mcl
                                      ).to(i64))
                  & ~divide_pending)
        div_m = div_m0 & viable
        off_start = torch.where(div_m, rp, row(IV_OFF_START))
        off_len = torch.where(div_m, child_size, row(IV_OFF_LEN))
        off_sex = torch.where(div_m, div_sex.to(i64), row(IV_OFF_SEX))

        # IO + tasks
        io_m = is_op(SEM_IO)
        in_ptr = row(IV_INPUT_PTR)
        ptr_mod = in_ptr % 3
        inputs3 = iv[IV_INPUTS:IV_INPUTS + 3]
        value_in = inputs3.gather(0, ptr_mod[None])[0]
        ibuf = [row(IV_INPUT_BUF + k) for k in range(3)]
        ibuf_n = row(IV_INPUT_BUF_N)
        cur_bonus = fv[FV_CUR_BONUS].clone()
        if not bool(io_m.any()):
            # no lane does IO this cycle: nothing below changes
            performed_l = rewarded_l = [torch.zeros_like(ip)] * R
            input_ptr, input_buf_n = in_ptr, ibuf_n
            ibuf0, ibuf1, ibuf2 = ibuf
            output_buf = row(IV_OUTPUT_BUF)
        else:
            (performed_l, rewarded_l, input_ptr, ibuf0, ibuf1, ibuf2,
             input_buf_n, output_buf, cur_bonus) = io_tasks(
                io_m, in_ptr, value_in, ibuf, ibuf_n, cur_bonus, val)

        # register writes
        res = val
        wrote = torch.zeros_like(exec_m)
        for sm, v in ((SEM_SHIFT_R, val >> 1), (SEM_SHIFT_L, _wrap32(val << 1)),
                      (SEM_INC, _wrap32(val + 1)), (SEM_DEC, _wrap32(val - 1)),
                      (SEM_ADD, _wrap32(bx + cx)), (SEM_SUB, _wrap32(bx - cx)),
                      (SEM_NAND, ~(bx & cx)), (SEM_POP, pop_val),
                      (SEM_IO, value_in), (SEM_SWAP, val2)):
            res = torch.where(is_op(sm), v, res)
            wrote = wrote | is_op(sm)
        rr = torch.arange(3, dtype=i64, device=dev)[:, None]
        regs_new = torch.stack(regs)
        regs_new = torch.where((rr == operand) & wrote, res, regs_new)
        regs_new = torch.where((rr == next_reg) & is_op(SEM_SWAP), val,
                               regs_new)
        heads = iv[IV_HEADS:IV_HEADS + 4]
        hsel0 = torch.where(mod_kind == MOD_HEAD, operand, HEAD_IP)
        head_sel = heads.gather(0, hsel0[None])[0]
        eff_head_pos = torch.where(hsel0 == HEAD_IP,
                                   _adjust1(ip + consumed, mlen), head_sel)
        regs_new[2] = torch.where(is_op(SEM_GET_HEAD), eff_head_pos,
                                  regs_new[2])
        regs_new[0] = torch.where(alloc_m, old_len, regs_new[0])
        regs_new[1] = torch.where(srch, search_bx, regs_new[1])
        regs_new[2] = torch.where(srch, label_len, regs_new[2])
        regs_new = torch.where(div_m, 0, regs_new)

        # head writes
        mov_m, jmp_m = is_op(SEM_MOV_HEAD), is_op(SEM_JMP_HEAD)
        setflow_m = is_op(SEM_SET_FLOW)
        flow0 = heads[HEAD_FLOW]
        jp = _wrap32(eff_head_pos + cx)
        jmp_pos = torch.where(jp < 0, 0, jp % mlen)
        setflow_pos = torch.where(val < 0, 0, val % mlen)
        new_hpos = torch.where(mov_m, flow0, jmp_pos)
        hr = torch.arange(4, dtype=i64, device=dev)[:, None]
        heads_new = torch.where((hr == hsel0) & (mov_m | jmp_m), new_hpos,
                                heads)
        heads_new[HEAD_FLOW] = torch.where(
            setflow_m, setflow_pos,
            torch.where(srch, new_flow_srch, heads_new[HEAD_FLOW]))
        heads_new[HEAD_READ] = torch.where(copy_m, _adjust1(rp + 1, mlen),
                                           heads_new[HEAD_READ])
        heads_new[HEAD_WRITE] = torch.where(copy_m, _adjust1(wp + 1, mlen),
                                            heads_new[HEAD_WRITE])
        ip_seq = _adjust1(_adjust1(ip + consumed + skip.to(i64) + 1, mlen),
                          mlen)
        ip_new = torch.where(jmp_m & (hsel0 == HEAD_IP),
                             _adjust1(jmp_pos + 1, mlen), ip_seq)
        ip_new = torch.where(mov_m & (hsel0 == HEAD_IP), flow0, ip_new)
        ip_new = torch.where(div_m, 0, ip_new)
        heads_new[HEAD_IP] = torch.where(eff_exec, ip_new, ip)

        mem_len = torch.where(div_m, rp, mem_len)
        heads_new = torch.where(div_m, 0, heads_new)
        stacks = torch.where(div_m, 0, stacks)
        sp_out0 = torch.where(div_m, 0, sp_out0)
        sp_out1 = torch.where(div_m, 0, sp_out1)
        active_stack = torch.where(div_m, 0, active_stack)
        read_label_len = torch.where(div_m, 0, read_label_len)
        new_mal = new_mal & ~div_m

        # site-flag bitplanes
        nop_exec = has_mod | (has_label & (label_len > 0))
        ebm = ebm | torch.where((lw_rows == (ip >> 5)) & eff_exec,
                                1 << (ip & 31), 0)
        ebm = ebm | torch.where((lw_rows == (next_pos >> 5)) & nop_exec,
                                1 << (next_pos & 31), 0)
        cbm = cbm | torch.where((lw_rows == (wp >> 5)) & copy_m,
                                1 << (wp & 31), 0)
        clear_z = torch.where(alloc_m, _range_mask(lw_rows, old_len,
                                                   new_len_alloc), 0)
        ebm = torch.where(div_m, 0, ebm & ~clear_z & _M32)
        cbm = torch.where(div_m, 0, cbm & ~clear_z & _M32)

        # phenotype DivideReset
        copied_sz = row(IV_COPIED_SIZE)
        m = params.base_merit_method
        least = torch.minimum(torch.minimum(gsize, copied_sz), exec_count)
        if m == 0:
            merit_base = torch.full((N,), float(params.base_const_merit),
                                    dtype=torch.float32, device=dev)
        elif m == 1:
            merit_base = copied_sz.to(torch.float32)
        elif m == 2:
            merit_base = exec_count.to(torch.float32)
        elif m == 3:
            merit_base = gsize.to(torch.float32)
        elif m == 4:
            merit_base = least.to(torch.float32)
        else:
            merit_base = least.to(torch.float64).sqrt().to(torch.float32)
        new_merit = (merit_base * cur_bonus if params.inherit_merit
                     else merit_base)
        time_used0 = row(IV_TIME_USED)
        gest_start = row(IV_GEST_START)
        gestation = time_used0 + 1 - gest_start
        new_fitness = new_merit / gestation.clamp(min=1).to(torch.float32)
        fv[FV_MERIT] = torch.where(div_m, new_merit, fv[FV_MERIT])
        fv[FV_FITNESS] = torch.where(div_m, new_fitness, fv[FV_FITNESS])
        fv[FV_LAST_BONUS] = torch.where(div_m, cur_bonus, fv[FV_LAST_BONUS])
        fv[FV_LAST_MERIT_BASE] = torch.where(div_m, merit_base,
                                             fv[FV_LAST_MERIT_BASE])
        fv[FV_CUR_BONUS] = torch.where(
            div_m, torch.tensor(params.default_bonus, dtype=torch.float32),
            cur_bonus)
        gen_inc = div_m.to(i64) if params.generation_inc_method == 1 else 0

        time_used = time_used0 + exec_m.to(i64)
        if params.inst_addl_time_cost:
            # charged on eff_exec, failures included (:1225-1230)
            time_used = time_used + torch.where(eff_exec, addl_tab[cur_op],
                                                0)
        cpu_cycles = row(IV_CPU_CYCLES) + exec_m.to(i64)
        if params.divide_method != 0:
            time_used = torch.where(div_m, 0, time_used)
            cpu_cycles = torch.where(div_m, 0, cpu_cycles)
            gest_start = torch.where(div_m, 0, gest_start)
        else:
            gest_start = torch.where(div_m, time_used, gest_start)
        max_exec = row(IV_MAX_EXEC)
        died = exec_m & (max_exec > 0) & (time_used >= max_exec)
        alive = alive & ~died
        divide_pending = divide_pending | div_m
        newdiv = ((flags & FLAG_NEWDIV) != 0) | div_m

        # tape writes (the reference defers them one cycle)
        sh = (wp & 3) * 8
        w_old = tw.gather(0, (wp >> 2)[None])[0]
        w_new = (w_old & ~(0xFF << sh) & _M32) | (written << sh)
        tw.scatter_(0, (wp >> 2)[None],
                    torch.where(copy_m, w_new, w_old)[None])
        if bool(alloc_m.any()):
            zmask = (_bytemask((new_len_alloc[None] - word_rows * 4).clamp(
                0, 4)) & ~_bytemask((old_len[None] - word_rows * 4).clamp(
                    0, 4)))
            tw = torch.where(alloc_m[None], tw & ~zmask & _M32, tw)

        # write back
        iv[IV_MEM_LEN] = mem_len
        iv[IV_ACTIVE_STACK] = active_stack
        iv[IV_READ_LABEL_LEN] = read_label_len
        iv[IV_INPUT_PTR] = input_ptr
        iv[IV_INPUT_BUF_N] = input_buf_n
        iv[IV_OUTPUT_BUF] = output_buf
        iv[IV_TIME_USED] = time_used
        iv[IV_CPU_CYCLES] = cpu_cycles
        iv[IV_GEST_START] = gest_start
        iv[IV_GEST_TIME] = torch.where(div_m, gestation, row(IV_GEST_TIME))
        iv[IV_EXEC_SIZE] = torch.where(div_m, exec_count, row(IV_EXEC_SIZE))
        iv[IV_CHILD_COPIED] = torch.where(div_m, copied_count,
                                          row(IV_CHILD_COPIED))
        iv[IV_GENERATION] = row(IV_GENERATION) + gen_inc
        iv[IV_NUM_DIVIDES] = row(IV_NUM_DIVIDES) + div_m.to(i64)
        iv[IV_OFF_START] = off_start
        iv[IV_OFF_LEN] = off_len
        iv[IV_OFF_COPIED] = torch.where(div_m, copied_count,
                                        row(IV_OFF_COPIED))
        iv[IV_OFF_SEX] = off_sex
        iv[IV_INSTS_EXEC] = row(IV_INSTS_EXEC) + exec_m.to(i64)
        if costs:
            # the parent's cost engine restarts at divide
            iv[IV_COST_WAIT] = torch.where(div_m, 0, cost_wait)
            iv[IV_FT_LO] = torch.where(div_m, 0, ft_lo)
            iv[IV_FT_HI] = torch.where(div_m, 0, ft_hi)
        iv[IV_FLAGS] = (torch.where(new_mal, FLAG_MAL, 0)
                        | torch.where(alive, FLAG_ALIVE, 0)
                        | torch.where(divide_pending, FLAG_DIVPEND, 0)
                        | torch.where(sterile, FLAG_STERILE, 0)
                        | torch.where(newdiv, FLAG_NEWDIV, 0))
        iv[IV_REGS:IV_REGS + 3] = regs_new
        iv[IV_HEADS:IV_HEADS + 4] = heads_new
        iv[IV_SP] = sp_out0
        iv[IV_SP + 1] = sp_out1
        iv[IV_INPUT_BUF] = ibuf0
        iv[IV_INPUT_BUF + 1] = ibuf1
        iv[IV_INPUT_BUF + 2] = ibuf2
        iv[IV_READ_LABEL:IV_READ_LABEL + MAX_LABEL_SIZE] = read_label
        iv[IV_STACKS:IV_STACKS + 20] = stacks
        # the pending-write value row is rewritten on every cycle the
        # lane's block runs, executing or not (pallas_cycles.py:1171)
        # (a lane outside the traversal's tiles reads a zero word)
        rp_read = torch.where((rp >> 2) // 16 * 16 < bound_w, read_inst, 0)
        iv[IV_PW_VAL] = torch.where(
            looping, torch.where(exec_m, written, rp_read), row(IV_PW_VAL))
        pend = torch.maximum(torch.where(copy_m, wp + 1, 0),
                             torch.where(alloc_m, new_len_alloc, 0))
        iv[IV_EXEC_BM:IV_EXEC_BM + LW] = _wrap32(ebm)
        iv[IV_COPIED_BM:IV_COPIED_BM + LW] = _wrap32(cbm)
        for r in range(R):
            tc_new = row(IV_DYN + r) + performed_l[r]
            rc_new = row(IV_DYN + R + r) + rewarded_l[r]
            iv[IV_DYN + 2 * R + r] = torch.where(div_m, tc_new,
                                                 row(IV_DYN + 2 * R + r))
            iv[IV_DYN + r] = torch.where(div_m, 0, tc_new)
            iv[IV_DYN + R + r] = torch.where(div_m, 0, rc_new)
            iv[IV_DYN + 3 * R + r] = row(IV_DYN + 3 * R + r) + performed_l[r]

    iv[IV_PW_POS] = -1
    iv[IV_PZ_START] = 0
    iv[IV_PZ_END] = 0

    # offspring extraction for every lane that divided in this launch
    newdiv = (iv[IV_FLAGS] & FLAG_NEWDIV) != 0
    if bool(newdiv.any()):
        tb = tw.to(torch.int32).T.contiguous().view(torch.uint8).T.to(i64)
        pos = torch.arange(L, dtype=i64, device=dev)[:, None]
        src = (iv[IV_OFF_START][None] + pos) % L
        ext = tb.gather(0, src)
        ext = torch.where(pos < iv[IV_OFF_LEN][None], ext, 0)
        ext_w = pack_words(ext.T.to(torch.uint8).contiguous(), L).T
        off_t.copy_(torch.where(newdiv[None], ext_w, off_t))

    tape_t.copy_(_wrap32(tw).to(torch.int32))
    ivec.copy_(iv.to(torch.int32))
    fvec.copy_(fv)
    return planes


# ---- the CUDA kernels: build, resources, tables, launch ----

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
# the Hopper kernel, and the first port kept as its yardstick; both are
# built into one library
SOURCES = tuple(os.path.join(_CSRC, f) for f in ("cycles.cu",
                                                  "cycles_simple.cu"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_lib = None
_lib_lock = threading.Lock()
LAUNCHES = 0           # kernel launches since import (see reset_launches)
STACKED_LAUNCHES = 0   # of them, stacked multi-world launches


def reset_launches():
    global LAUNCHES, STACKED_LAUNCHES
    LAUNCHES = 0
    STACKED_LAUNCHES = 0


def _nvcc():
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    import shutil
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the cycle kernels are built from "
                           "csrc/*.cu at first use on a CUDA machine")
    return found


def source_digest() -> str:
    """Digest of both kernel sources and the compiler flags: names the
    library, so a change to either source rebuilds it."""
    import hashlib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return h.hexdigest()[:12]


def build() -> str:
    """Compile both sources into _build/ (once per source version: one nvcc
    per source, started together, then one link) and return the library
    path.  ptxas's resource report is kept beside it (see resources)."""
    digest = source_digest()
    path = os.path.join(BUILD_DIR, f"libcycles-{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in SOURCES]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for s, o in zip(SOURCES, objs)]
    outs = [p.communicate() for p in procs]
    report = "".join(err + out for out, err in outs)
    bad = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"nvcc failed on {bad}:\n{report}")
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                         capture_output=True, text=True)
    for o in objs:
        os.remove(o)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    with open(path[:-3] + ".ptxas.txt", "w") as f:
        f.write(report)
    os.replace(tmp, path)
    return path


def parse_ptxas(text: str) -> dict:
    """{kernel: {registers, stack_bytes, spill_store_bytes,
    spill_load_bytes, static_smem_bytes}} from `nvcc -Xptxas -v` output,
    for the entry functions cycles_kernel<C> (one per CTA width) and
    cycles_simple_kernel."""
    import re
    out, entry, props = {}, None, None

    def short(mangled):
        m = re.search(r"cycles_simple_kernel|cycles_kernel(?:ILi(\d+)E)?",
                      mangled)
        if m is None:
            return None
        return f"cycles_kernel<{m.group(1)}>" if m.group(1) else m.group(0)

    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = short(m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = short(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            out.setdefault(props, {}).update(
                stack_bytes=int(m.group(1)),
                spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)))
            props = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            sm = re.search(r"(\d+) bytes smem", line)
            out.setdefault(entry, {}).update(
                registers=int(m.group(1)),
                static_smem_bytes=int(sm.group(1)) if sm else 0)
            entry = None
    return out


def resources() -> dict:
    """The built kernels' resources as ptxas reported them (build first)."""
    with open(build()[:-3] + ".ptxas.txt") as f:
        return parse_ptxas(f.read())


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn in (lib.avida_cycles_launch,
                       lib.avida_cycles_launch_simple):
                fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int,
                                                       ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# ---- the Hopper kernel's launch geometry ----

MAX_CTA = 128            # lanes (threads) of a CTA
MAX_CLUSTER = 8          # CTAs of a cluster: the portable cluster size
SMEM_PER_CTA = 232_448   # the most shared memory a CTA may use (227 KB)
SMEM_PER_SM = 233_472    # an SM's shared memory (228 KB) ...
SMEM_CTA_RESERVED = 1_024  # ... of which each resident CTA reserves 1 KB
TILE_ROWS_IVEC = 30      # ivec rows 38-67: the read label and the stacks
# the launch table (_build_tables: 1,088 ints), the reductions and the
# two mbarriers (8) and the cluster's slots (16)
FIXED_SMEM_INTS = 8 * 64 + 16 * 32 + 64 + 8 + 16


def tile_rows(L, R):
    """Lane-wide int32 rows the Hopper kernel stages in shared memory: the
    tape words, the read label and stacks, both site-flag bitplanes and
    the 4R reaction counters."""
    return L // 4 + TILE_ROWS_IVEC + 2 * (L // 32) + 4 * R


def cta_smem_bytes(L, R, C):
    """Dynamic shared memory of one C-lane CTA (csrc/cycles.cu's layout:
    the tile, the launch table, the reductions and the cluster's slots)."""
    return 4 * (tile_rows(L, R) * C + FIXED_SMEM_INTS)


def cta_lanes(L, R, B) -> int:
    """The CTA width C of the Hopper kernel for tape height L, R reactions
    and the reference's block B: the widest power of two C <= 128 that
    divides B in at most 8 CTAs (one cluster) and lets two CTAs share an
    SM; failing that, the widest one CTA can hold."""
    cands = [c for c in (128, 64, 32) if c <= B and B // c <= MAX_CLUSTER]
    for c in cands:
        if 2 * (cta_smem_bytes(L, R, c) + SMEM_CTA_RESERVED) <= SMEM_PER_SM:
            return c
    for c in cands:
        if cta_smem_bytes(L, R, c) <= SMEM_PER_CTA:
            return c
    raise ValueError(f"no CTA width fits tape height {L}, {R} reactions "
                     f"and block {B} in shared memory")


def params_cached(store: dict, params, device, build):
    """build(params, device), made once per params object and device and
    kept in `store` (tables copied to a card synchronise with the host,
    so no per-launch or per-cycle caller rebuilds them)."""
    key = (id(params), str(device))
    hit = store.get(key)
    if hit is not None and hit[0] is params:
        return hit[1]
    if len(store) >= 16:
        store.clear()
    value = build(params, device)
    store[key] = (params, value)
    return value


_TABLES = {}           # (id(params), device) -> (params, table on device)


def kernel_tables(params, device) -> torch.Tensor:
    """The kernel's int32 table on `device` (params_cached)."""
    return params_cached(_TABLES, params, device,
                         lambda p, d: _build_tables(p).to(d))


# opcode tables of the launch table, 64 slots each, in csrc/cycles.cu's
# order (T_META ... T_NOP_MOD), then 16 ints per reaction for up to 32
# reactions, then the nop decode (64 slots)
TAB_INSTS = 64
(T_META, T_COST, T_FT_COST, T_ADDL, T_PROB_FAIL, T_MUT_CDF, T_IS_NOP,
 T_NOP_MOD, T_REACTIONS) = range(9)
T_NOP_DECODE = T_REACTIONS * TAB_INSTS + 16 * 32


def _build_tables(params) -> torch.Tensor:
    """The opcode tables, then 16 ints per reaction, then the nop decode
    (a nop's register, -1 for any other opcode slot); see csrc/cycles.cu.
    prob_fail and the cumulative mutation weights are float32 bit
    patterns: the reference compares its draws against them in float32."""
    import struct
    R = params.num_reactions
    ni = params.num_insts
    t = [0] * (T_NOP_DECODE + TAB_INSTS)

    def put(table, vals):
        for k, v in enumerate(vals):
            t[table * TAB_INSTS + k] = int(v)

    put(T_META, ((int(params.sem[k]) | (int(params.mod_kind[k]) << 8)
                  | (int(params.default_op[k]) << 16)) for k in range(ni)))
    put(T_COST, params.inst_cost)
    put(T_FT_COST, params.inst_ft_cost)
    put(T_ADDL, params.inst_addl_time_cost)
    put(T_PROB_FAIL, (_f32_bits(x) for x in params.inst_prob_fail))
    if not uniform_mutation(params):
        put(T_MUT_CDF, (_f32_bits(x) for x in params.mut_cdf[:ni - 1]))
    put(T_IS_NOP, (bool(x) for x in params.is_nop))
    put(T_NOP_MOD, params.nop_mod)
    for r in range(R):
        v = float(params.proc_value[r])
        typ = int(params.proc_type[r])
        f = torch.tensor(2.0 ** v if typ == 2 else v, dtype=torch.float32)
        base = T_REACTIONS * TAB_INSTS + 16 * r
        t[base + 0] = max(min(int(params.min_task_count[r]), 2**31 - 1), 0)
        t[base + 1] = min(int(params.max_task_count[r]), 2**31 - 1)
        t[base + 2] = typ
        t[base + 3] = struct.unpack("<i", struct.pack("<f", float(f)))[0]
        t[base + 4] = sum(1 << d for d in range(R)
                          if params.req_reaction_mask[r][d])
        t[base + 5] = sum(1 << d for d in range(R)
                          if params.noreq_reaction_mask[r][d])
        for w in range(8):
            word = sum(1 << b for b in range(32)
                       if params.task_logic_mask[r][w * 32 + b])
            t[base + 6 + w] = word - (1 << 32) if word >= 2**31 else word
    for k in range(TAB_INSTS):
        t[T_NOP_DECODE + k] = (int(params.nop_mod[k])
                               if k < ni and params.is_nop[k] else -1)
    return torch.tensor(t, dtype=torch.int32)


def _launch_cuda(params, planes, seeds, num_steps, B, simple=False):
    """Launch the Hopper kernel (csrc/cycles.cu) on the planes, or with
    simple=True the first port (csrc/cycles_simple.cu), which only
    chip_smoke.py's timing and checks launch."""
    tape_t, off_t, ivec, fvec = planes
    LP, n_pad = tape_t.shape
    NI, LW, IV_COPIED_BM, IV_DYN = layout(params, LP * 4)
    R = params.num_reactions
    dev = tape_t.device
    for t, dt, shape in ((tape_t, torch.int32, (LP, n_pad)),
                         (off_t, torch.int32, (LP, n_pad)),
                         (ivec, torch.int32, (NI, n_pad)),
                         (fvec, torch.float32, (NF, n_pad)),
                         (seeds, torch.int32, (n_pad // B,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"cycle kernel operand: got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"contiguous {dt} {shape} on {dev}")
    if LW > MAX_LW or R > MAX_R or B > 512 or B % 32 \
            or B < TAB_INSTS or n_pad % B or params.num_insts > TAB_INSTS:
        raise ValueError("cycle kernel limits: tape <= 1024, <= 32 "
                         "reactions, <= 64 instructions, block width a "
                         "multiple of 32 in [64, 512]")
    if tape_t.data_ptr() % 16 or ivec.data_ptr() % 16:
        raise ValueError("cycle kernel: tape_t and ivec must start on a "
                         "16-byte boundary (rows are bulk-copied)")
    tab = kernel_tables(params, dev)
    pi = (ctypes.c_int32 * 21)(
        n_pad, LP, LW, params.max_memory, params.num_insts,
        R, IV_COPIED_BM, IV_DYN,
        min(int(num_steps), 2**31 - 1), int(params.require_allocate),
        int(params.base_merit_method), int(params.inherit_merit),
        1 if params.generation_inc_method == 1 else 0,
        int(params.divide_method), int(params.min_genome_len),
        int(params.copy_mut_prob > 0), int(has_costs(params)),
        int(bool(params.inst_prob_fail)),
        int(bool(params.inst_addl_time_cost)),
        int(not uniform_mutation(params)),
        cta_lanes(LP * 4, R, B))
    pf = (ctypes.c_float * 7)(
        params.copy_mut_prob, params.offspring_size_range,
        params.min_exe_lines, params.min_copied_lines, params.default_bonus,
        float(params.base_const_merit),
        prng.f32_reciprocal(params.offspring_size_range))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _load()
    fn = lib.avida_cycles_launch_simple if simple else lib.avida_cycles_launch
    rc = fn(tape_t.data_ptr(), off_t.data_ptr(), ivec.data_ptr(),
            fvec.data_ptr(), seeds.data_ptr(), tab.data_ptr(), pi, pf, B,
            stream)
    if rc != 0:
        raise RuntimeError(f"cycle kernel launch failed (CUDA error {rc})")


def cycles_simple(params, planes, seeds, num_steps, B):
    """The first port (csrc/cycles_simple.cu) on CUDA planes, in place:
    the Hopper kernel's yardstick, launched only by chip_smoke.py and the
    card's tests, never by a path, and counted nowhere."""
    if planes[0].device.type != "cuda":
        raise ValueError("cycles_simple launches the CUDA kernel only")
    check_supported(params)
    _launch_cuda(params, planes, seeds, num_steps, B, simple=True)
    return planes


def cycles(params, planes, seeds, num_steps, B):
    """Run one update's cycles over the planes, in place; returns them.

    CUDA tensors launch the Hopper kernel (csrc/cycles.cu) or raise; CPU
    tensors take the plain version.  `seeds` holds one int32 seed per B-lane block
    (block_seeds); `num_steps` is the static per-update step cap."""
    global LAUNCHES
    check_supported(params)
    if planes[0].device.type == "cuda":
        _launch_cuda(params, planes, seeds, num_steps, B)
        LAUNCHES += 1
        return planes
    if planes[0].device.type != "cpu":
        raise ValueError(f"no cycle kernel for device {planes[0].device}")
    return cycles_reference(params, planes, seeds, num_steps, B)


def run_packed_stacked(params, planes, world_seeds, num_steps, B):
    """ONE launch over W worlds' planes stacked world-major on the lane
    axis (replaces pallas_cycles.run_packed_stacked, :1729), in place.

    World w owns lanes [w * n_w, (w + 1) * n_w), n_w a multiple of the
    block width B, so no block straddles two worlds; block b of world w
    carries world w's seed (the interpret schedule), and the kernel's
    hash keys on the lane's offset inside its block, so each world's
    slice computes exactly its solo launch.  The kernel takes one seed per
    block, forms each block's cluster inside one world, and indexes planes
    with 64-bit offsets, so W * n_pad lanes need nothing new.  Bound as the solo
    launch: the planes read once, the changed words written once; a pad
    lane (granted nothing) reads one tape word, its pending-write
    value."""
    global STACKED_LAUNCHES
    lanes = planes[0].shape[1]
    W = world_seeds.shape[0]
    if W < 1 or lanes % W or (lanes // W) % B:
        raise ValueError(f"stacked launch: {lanes} lanes do not split into "
                         f"{W} worlds of whole {B}-lane blocks")
    if int(params.kernel_shards) > 1:
        raise NotImplementedError(
            f"TPU_KERNEL_SHARDS={params.kernel_shards}: the per-card split "
            f"of a launch (K2 with S > 1) is not ported to avida_tpu_torch")
    seeds = stacked_block_seeds(world_seeds, lanes // W, B)
    out = cycles(params, planes, seeds, num_steps, B)
    if planes[0].device.type == "cuda":
        STACKED_LAUNCHES += 1
    return out


def lane_perm_active(params, st) -> bool:
    """Does the per-update engine pack by the persistent lane permutation?
    Only on the kernel route, with TPU_LANE_PERM > 0 and the packed chunk
    inactive: resident
    planes are cell-ordered, and both engines must give each organism the
    same kernel lane (hence the same random stream)."""
    if int(params.lane_perm_k) <= 0 or not use_kernel(params):
        return False
    from avida_tpu_torch.ops import packed_chunk
    return not packed_chunk.active(params, st)


def lane_order(params, st):
    """(perm, inv) that run_cycles packs and unpacks by: st.lane_perm /
    lane_inv (refreshed by ops/update.perm_phase) when the permutation is
    in use, else (None, None), the identity."""
    if lane_perm_active(params, st):
        return st.lane_perm, st.lane_inv
    return None, None


def launch(params, planes, key, num_steps, n):
    """One launch over pack_state's (padded) planes of an n-cell world, in
    place, with run_packed's per-block seeds of `key`."""
    B, n_pad, _ = dims(params, n, params.max_memory)
    return cycles(params, planes, block_seeds(key, n_pad, B), num_steps, B)


def run_cycles(params, st, key, granted, num_steps):
    """One update's cycles on a canonical PopulationState (the per-update
    engine): pack in lane order, one launch, unpack.  The kernel's random
    stream is keyed by the lane's offset inside its block, so the lane
    permutation decides each organism's stream."""
    perm, inv = lane_order(params, st)
    planes = pack_state(params, st, granted, perm)
    launch(params, planes, key, num_steps, st.tape.shape[0])
    return unpack_state(params, st, planes, inv)
