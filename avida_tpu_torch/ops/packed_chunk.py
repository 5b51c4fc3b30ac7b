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

A batch of W static-equal worlds (parallel/multiworld.py) stays resident
the same way in `PackedWorlds`: every plane grows a world axis in the
middle ([rows, W, N]), the update's one kernel launch runs over the
planes flattened world-major onto the lanes (cycles.run_packed_stacked),
and the cheap phases and the flush run world by world -- a loop over the
members is this package's vmap.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from avida_tpu_torch.core.state import (stack_states, unstack_states,
                                        world_state)
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
    #                          (int32[ceil(L/6), N] under the 5-bit codec)
    ivec: torch.Tensor       # int32[NI, N] per-organism scalars
    fvec: torch.Tensor       # f32[NF, N]  float phenotype scalars

    def replace(self, **kw) -> "PackedChunk":
        return dataclasses.replace(self, **kw)


def ineligible_reason(params, nb_ring: bool = False) -> str | None:
    """Why this configuration cannot keep state packed across a chunk
    (None = it can): the reference's routing predicate, gate for gate and
    in its words.  `nb_ring`: the state carries a non-empty newborn ring
    (TPU_SYSTEMATICS=1).  An ineligible configuration runs the per-update
    engine (ops/update.py); so does every run off the kernel route
    (cycles.use_kernel), on the micro-step engine."""
    if int(params.packed_chunk) == 0:
        return "TPU_PACKED_CHUNK=0"
    if params.hw_type != 0 or params.max_cpu_threads > 1:
        return "non-heads hardware or multi-threaded CPUs (XLA path)"
    if not cycles.use_kernel(params):
        return ("Pallas cycle kernel off for this run "
                "(TPU_USE_PALLAS / eligibility / backend)")
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


def batch_active(params, bst) -> bool:
    """`active` for a batched state: the gates are per configuration, so
    world 0 answers for the whole static-equal batch."""
    return active(params, world_state(bst, 0))


def unported_reason(params) -> str | None:
    """Why the packed route of an eligible configuration is not ported
    (None = it is): the fused row-space body is, with the 8-bit or the
    5-bit genome plane."""
    if int(params.packed_fused) == 0:
        return "TPU_PACKED_FUSED=0 (the row-space body is not ported)"
    if int(params.trace_cap):
        return "flight recorder (TPU_TRACE)"
    return None


def bits_ineligible_reason(params) -> str | None:
    """Why the genome shadow plane cannot ride the 5-bit codec (None =
    it does; meaningful only when the packed chunk is active): the codec
    keeps 5 bits of each opcode, so the whole set must fit."""
    if int(params.packed_bits) == 0:
        return "TPU_PACKED_BITS=0"
    if int(params.num_insts) > 32:
        return ("opcode count > packable width (num_insts=%d does not "
                "fit 5-bit codes)" % int(params.num_insts))
    return None


def bits_active(params) -> bool:
    """Does the genome shadow plane use the 5-bit codec
    (TPU_PACKED_BITS=1: ceil(L/6) words a lane, 6 opcodes a word, in
    place of L/4)?  The kernel never reads the plane."""
    return bits_ineligible_reason(params) is None


def engine_report(params, nb_ring: bool = False) -> dict:
    """Which engine this configuration routes to, in the reference's
    vocabulary: {'engine': 'packed', 'sub_path', 'packed_bits'} (with
    'bits_fallback_reason' when TPU_PACKED_BITS=1 is refused) or
    {'engine': 'per-update', 'fallback_reason'}."""
    reason = ineligible_reason(params, nb_ring)
    if reason is not None:
        return {"engine": "per-update", "fallback_reason": reason}
    rep = {"engine": "packed", "sub_path": "fused"}
    breason = bits_ineligible_reason(params)
    rep["packed_bits"] = 0 if breason else 1
    if breason and int(params.packed_bits):
        rep["bits_fallback_reason"] = breason
    return rep


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
    if bits_active(params):
        # lossless: every genome byte is an opcode < num_insts <= 32
        gen_t = cycles.pack_words5(genp, L).T.contiguous()
    else:
        gen_t = cycles.pack_words(genp, L).T.contiguous()
    return PackedChunk(st=st, tape_t=tape_t, off_t=off_t, gen_t=gen_t,
                       ivec=ivec, fvec=fvec)


def unpack_chunk(params, pc: PackedChunk):
    """Resident planes -> canonical state (once per chunk)."""
    n, L0 = pc.st.tape.shape
    st = cycles.unpack_state(params, pc.st, (pc.tape_t, pc.off_t, pc.ivec,
                                             pc.fvec), restore_ro=True)
    L = pc.tape_t.shape[0] * 4      # gen_t's rows differ under the codec
    if bits_active(params):
        genome = cycles.unpack_words5(pc.gen_t.T.contiguous(), L)[:, :L0]
    else:
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


# ---- stacked multi-world residency (packed_chunk.py:428-562) ----

_PLANES = ("tape_t", "off_t", "gen_t", "ivec", "fvec")


@dataclass(frozen=True)
class PackedWorlds:
    """Resident state of W worlds: each world's canonical carrier (as
    PackedChunk.st) and the five planes with lanes split [rows, W, N]."""
    sts: tuple               # W PopulationState carriers
    tape_t: torch.Tensor     # int32[LP, W, N]
    off_t: torch.Tensor      # int32[LP, W, N]
    gen_t: torch.Tensor      # int32[LP, W, N]
    ivec: torch.Tensor       # int32[NI, W, N]
    fvec: torch.Tensor       # f32[NF, W, N]

    def replace(self, **kw) -> "PackedWorlds":
        return dataclasses.replace(self, **kw)

    def world(self, w: int) -> PackedChunk:
        """World w as a PackedChunk over views of the stacked planes."""
        return PackedChunk(st=self.sts[w], **{
            name: getattr(self, name)[:, w] for name in _PLANES})


def pack_worlds(params, bst) -> PackedWorlds:
    """Batched canonical state -> stacked resident planes (once per
    chunk): pack_chunk per world, the world axis behind the row axis."""
    pcs = [pack_chunk(params, st) for st in unstack_states(bst)]
    return PackedWorlds(sts=tuple(pc.st for pc in pcs), **{
        name: torch.stack([getattr(pc, name) for pc in pcs], dim=1)
        for name in _PLANES})


def unpack_worlds(params, pw: PackedWorlds):
    """Stacked resident planes -> batched canonical state (the inverse of
    pack_worlds)."""
    return stack_states([unpack_chunk(params, pw.world(w))
                         for w in range(len(pw.sts))])


def pad_worlds(planes, n_pad):
    """W worlds' planes ([rows, W, n]) padded each with fresh zero lanes
    to n_pad (as the reference pads at every launch) and flattened
    world-major onto the lane axis: a tuple of [rows, W * n_pad]."""
    out = []
    for x in planes:
        rows, W, n = x.shape
        buf = torch.zeros((rows, W, n_pad), dtype=x.dtype, device=x.device)
        buf[:, :, :n] = x
        out.append(buf.view(rows, W * n_pad))
    return tuple(out)


def launch_worlds(params, planes, world_seeds, cap):
    """One stacked launch over W worlds' resident planes ([rows, W, N],
    in place): pad_worlds, launched once, sliced back."""
    _, W, n = planes[0].shape
    B, n_pad, _ = cycles.dims(params, n, params.max_memory)
    flat = pad_worlds(planes, n_pad)
    cycles.run_packed_stacked(params, flat, world_seeds, cap, B)
    for x, buf in zip(planes, flat):
        x.copy_(buf.view(x.shape[0], W, n_pad)[:, :, :n])
    return planes


def stats_rows_worlds(pw: PackedWorlds, alive_before, update_no):
    """stats_rows per world: (births, deaths, dt, ave_gen, n_alive), each
    a [W] vector; `alive_before` is [W], `update_no` W ints."""
    cols = [stats_rows(pw.world(w), alive_before[w], update_no[w])
            for w in range(len(pw.sts))]
    return tuple(torch.stack([c[j] for c in cols]) for j in range(5))


# ---- the batched update body's phases, in update_step_packed_worlds'
# order; keys and update numbers are per-world sequences ----

def schedule_phase_worlds(params, pw: PackedWorlds, k_budget):
    """Each world's budgets and grant row (in place).  Returns (budgets
    per world, executed0[W, N], trips[W]): trips is each world's own trip
    count max_k, what its solo launch runs."""
    budgets, trips = [], []
    for w, st in enumerate(pw.sts):
        b, granted, max_k = schedule_rows(params, pw.ivec[:, w],
                                          pw.fvec[:, w], st.budget_carry,
                                          k_budget[w])
        pw.ivec[cycles.IV_GRANTED, w] = granted
        budgets.append(b)
        trips.append(max_k.to(torch.int32))
    return (budgets, pw.ivec[cycles.IV_INSTS_EXEC].clone(),
            torch.stack(trips))


def kernel_phase_worlds(params, pw: PackedWorlds, k_steps):
    """The update's one stacked launch, seeded per world (in place)."""
    from avida_tpu_torch.ops import update
    launch_worlds(params, (pw.tape_t, pw.off_t, pw.ivec, pw.fvec),
                  cycles.world_seed_bases(k_steps), update.static_cap(params))


def bank_phase_worlds(params, pw: PackedWorlds, budgets, executed0):
    """bank_rows per world.  Returns (pw', executed[W])."""
    sts, executed = [], []
    for w, st in enumerate(pw.sts):
        st, ex = bank_rows(params, st, pw.ivec[:, w], budgets[w],
                           executed0[w])
        sts.append(st)
        executed.append(ex.sum().to(torch.int32))
    return pw.replace(sts=tuple(sts)), torch.stack(executed)


def flush_phase_worlds(params, pw: PackedWorlds, k_birth, update_no):
    """The world-blocked packed birth flush.  Returns pw'."""
    planes, sts = birth_ops.flush_births_packed_worlds(
        params, pw.sts, k_birth, tuple(getattr(pw, n) for n in _PLANES),
        update_no)
    return pw.replace(sts=tuple(sts), **dict(zip(_PLANES, planes)))


def update_step_packed_worlds(params, pw: PackedWorlds, keys, update_no):
    """One update of W worlds on stacked planes (update_step_packed phase
    for phase, one launch for the batch), each world consuming its own
    key's splits and stamping its own update number.  Returns (pw',
    executed[W], trips[W])."""
    ks = [prng.split(k, 3) for k in keys]
    budgets, executed0, trips = schedule_phase_worlds(
        params, pw, [k[0] for k in ks])
    kernel_phase_worlds(params, pw, [k[1] for k in ks])
    pw, executed = bank_phase_worlds(params, pw, budgets, executed0)
    pw = flush_phase_worlds(params, pw, [k[2] for k in ks], update_no)
    return pw, executed, trips
