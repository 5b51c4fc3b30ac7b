"""Packed-resident update chunk: the main path's update body.

Counterpart of avida_tpu/ops/packed_chunk.py (its fused row-space body).
The population stays in the cycle kernel's plane layout for a whole chunk:

  pack ONCE -> per update { schedule -> kernel launch -> bank -> birth
                            flush -> stats }, all in row space
            -> unpack ONCE at the chunk boundary

The canonical state rides along as a carrier (`PackedChunk.st`): its
[N, L] planes and the mirrors unpack rebuilds (alive, merit, gestation
time, generation) are stale mid-chunk; the columns unpack cannot rebuild
(birth_update, parent_id, genotype_id, breed_true, budget_carry, ...)
stay fresh, maintained by the flush.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from avida_tpu_torch.ops import birth as birth_ops
from avida_tpu_torch.ops import cycles
from avida_tpu_torch.utils import prng


@dataclass(frozen=True)
class PackedChunk:
    """Resident chunk state: canonical carrier + the five planes."""
    st: object               # PopulationState (see module docstring)
    tape_t: torch.Tensor     # int32[LP, N] opcode word plane
    off_t: torch.Tensor      # int32[LP, N] extracted-offspring plane
    gen_t: torch.Tensor      # int32[LP, N] birth-genome plane
    ivec: torch.Tensor       # int32[NI, N] per-organism scalars
    fvec: torch.Tensor       # f32[NF, N]  float phenotype scalars

    def replace(self, **kw) -> "PackedChunk":
        return dataclasses.replace(self, **kw)


def ineligible_reason(params, nb_ring: bool = False) -> str | None:
    """Why this configuration cannot keep state packed across a chunk
    (None = it can): the reference's routing predicate, gate for gate and
    in its words.  `nb_ring`: the state carries a non-empty newborn ring
    (TPU_SYSTEMATICS=1).  An ineligible configuration runs the per-update
    engine (ops/update.py)."""
    if int(params.packed_chunk) == 0:
        return "TPU_PACKED_CHUNK=0"
    if params.hw_type != 0 or params.max_cpu_threads > 1:
        return "non-heads hardware or multi-threaded CPUs (XLA path)"
    if birth_ops.has_divide_sex(params):
        return "divide-sex instruction set (recombination is canonical)"
    if not birth_ops.local_torus_fast_path(params, sexual=False):
        return ("birth placement off the torus fast path (geometry / "
                "birth method / demes / population caps)")
    if params.point_mut_prob > 0 or params.divide_slip_prob > 0:
        return "point or slip mutations (per-site sweeps stay canonical)"
    if params.num_global_res or params.num_spatial_res \
            or params.num_deme_res:
        return "resource pools (resource_phase reads canonical planes)"
    if params.fault_nan or params.fault_bitflip:
        return "device-side fault injection armed (TPU_FAULT nan:/bitflip:)"
    if nb_ring:
        return ("systematics newborn ring in use (TPU_SYSTEMATICS=1; "
                "newborn-record gathers stay canonical)")
    return None


def active(params, st=None) -> bool:
    """May this configuration (and state) keep state packed across a
    chunk?  The ring counts as in use when the state allocates one."""
    return ineligible_reason(
        params, st is not None and st.nb_genome.shape[0] > 0) is None


def unported_reason(params) -> str | None:
    """Why the packed route of an eligible configuration is not ported
    (None = it is): only the fused row-space body with the 8-bit genome
    plane is."""
    if int(params.packed_fused) == 0:
        return "TPU_PACKED_FUSED=0 (the row-space body is not ported)"
    if int(params.trace_cap):
        return "flight recorder (TPU_TRACE)"
    if int(params.packed_bits):
        return "TPU_PACKED_BITS=1 (the 5-bit genome plane is not ported)"
    return None


def engine_report(params, nb_ring: bool = False) -> dict:
    """Which engine this configuration routes to, in the reference's
    vocabulary: {'engine': 'packed', 'sub_path', 'packed_bits'} or
    {'engine': 'per-update', 'fallback_reason'}."""
    reason = ineligible_reason(params, nb_ring)
    if reason is not None:
        return {"engine": "per-update", "fallback_reason": reason}
    return {"engine": "packed", "sub_path": "fused", "packed_bits": 0}


def alive_rows(ivec):
    """bool[N] alive mask off the resident flag row."""
    return (ivec[cycles.IV_FLAGS] & cycles.FLAG_ALIVE) != 0


def schedule_rows(params, ivec, fvec, budget_carry, k_budget):
    """schedule_phase in row space: (budgets, granted, max_k)."""
    from avida_tpu_torch.ops import scheduler, update
    budgets = scheduler.compute_budgets_from(
        params, alive_rows(ivec), fvec[cycles.FV_MERIT], k_budget)
    return update.schedule_grant(params, budgets, budget_carry)


def stats_rows(pc: PackedChunk, alive_before, update_no):
    """(births, deaths, dt, ave_gen, n_alive) from the resident rows."""
    from avida_tpu_torch.ops import update
    vals = update.light_stats_vals(
        alive_rows(pc.ivec), pc.ivec[cycles.IV_GEST_TIME],
        pc.ivec[cycles.IV_GENERATION], pc.st.birth_update, update_no)
    return update.update_stats_from(vals, alive_before)


def pack_chunk(params, st) -> PackedChunk:
    """Canonical state -> resident planes (identity lane order, n lanes)."""
    n, L0 = st.tape.shape
    quad = cycles.pack_state(
        params, st, torch.zeros(n, dtype=torch.int32, device=st.device))
    tape_t, off_t, ivec, fvec = (p[:, :n].contiguous() for p in quad)
    L = tape_t.shape[0] * 4
    genp = torch.zeros((n, L), dtype=torch.uint8, device=st.device)
    genp[:, :L0] = st.genome.to(torch.uint8)
    gen_t = cycles.pack_words(genp, L).T.contiguous()
    return PackedChunk(st=st, tape_t=tape_t, off_t=off_t, gen_t=gen_t,
                       ivec=ivec, fvec=fvec)


def unpack_chunk(params, pc: PackedChunk):
    """Resident planes -> canonical state (once per chunk)."""
    n, L0 = pc.st.tape.shape
    st = cycles.unpack_state(params, pc.st, (pc.tape_t, pc.off_t, pc.ivec,
                                             pc.fvec), restore_ro=True)
    L = pc.tape_t.shape[0] * 4
    genome = cycles.unpack_words(pc.gen_t.T, L)[:, :L0]
    return st.replace(genome=genome.to(torch.int8).contiguous())


def launch(params, planes, key, cap):
    """One cycle-kernel launch over the resident planes (in place): pad
    lanes to the block quantum, run, slice back."""
    n = planes[0].shape[1]
    n_pad = cycles.dims(params, n, params.max_memory)[1]
    if n_pad == n:
        return cycles.launch(params, planes, key, cap, n)

    def padl(x):
        out = torch.zeros((x.shape[0], n_pad), dtype=x.dtype,
                          device=x.device)
        out[:, :n] = x
        return out

    out = cycles.launch(params, tuple(padl(p) for p in planes), key, cap, n)
    for dst, src in zip(planes, out):
        dst.copy_(src[:, :n])
    return planes


def bank_rows(params, st, ivec, budgets, executed0):
    """bank_phase in row space: returns (st, executed_this[N])."""
    executed_this = ivec[cycles.IV_INSTS_EXEC] - executed0
    carry = torch.clamp(budgets - executed_this, 0,
                        100 * params.ave_time_slice)
    st = st.replace(budget_carry=torch.where(alive_rows(ivec), carry, 0).to(
        torch.int32))
    return st, executed_this


# ---- the update body's phases, in order (update_step_packed) ----

def schedule_phase(params, pc: PackedChunk, k_budget):
    """Draw this update's budgets and write the grant row (in place).
    Returns (budgets, executed0): what bank_phase needs."""
    budgets, granted, _ = schedule_rows(params, pc.ivec, pc.fvec,
                                        pc.st.budget_carry, k_budget)
    pc.ivec[cycles.IV_GRANTED] = granted
    return budgets, pc.ivec[cycles.IV_INSTS_EXEC].clone()


def kernel_phase(params, pc: PackedChunk, k_steps):
    """One cycle-kernel launch over the resident planes (in place)."""
    from avida_tpu_torch.ops import update
    launch(params, (pc.tape_t, pc.off_t, pc.ivec, pc.fvec), k_steps,
           update.static_cap(params))


def bank_phase(params, pc: PackedChunk, budgets, executed0):
    """Bank unspent budget.  Returns (pc', executed_this[N])."""
    st, executed_this = bank_rows(params, pc.st, pc.ivec, budgets, executed0)
    return pc.replace(st=st), executed_this


def flush_phase(params, pc: PackedChunk, k_birth, update_no):
    """The packed birth flush.  Returns pc'."""
    planes, st = birth_ops.flush_births_packed(
        params, pc.st, k_birth,
        (pc.tape_t, pc.off_t, pc.gen_t, pc.ivec, pc.fvec), update_no)
    tape_t, off_t, gen_t, ivec, fvec = planes
    return pc.replace(st=st, tape_t=tape_t, off_t=off_t, gen_t=gen_t,
                      ivec=ivec, fvec=fvec)


def update_step_packed(params, pc: PackedChunk, key, update_no):
    """One update on resident planes (schedule -> kernel -> bank ->
    birth), consuming the reference's PRNG splits.  Returns
    (pc', executed_this_update)."""
    ks = prng.split(key, 3)
    budgets, executed0 = schedule_phase(params, pc, ks[0])
    kernel_phase(params, pc, ks[1])
    pc, executed_this = bank_phase(params, pc, budgets, executed0)
    pc = flush_phase(params, pc, ks[2], update_no)
    return pc, executed_this.sum().to(torch.int32)
