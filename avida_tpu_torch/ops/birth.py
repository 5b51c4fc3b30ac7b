"""Birth engine: the flush of pending offspring, in two layouts.

Counterpart of avida_tpu/ops/birth.py.

  flush_births_packed  on the resident kernel planes (ops/packed_chunk.py),
                       the torus fast path only: target selection and
                       conflict resolution on cell-indexed vectors (9
                       static torus rolls, lowest parent index wins),
                       divide mutations on the packed offspring plane, the
                       newborn scatter as roll-selects over [rows, N];
                       flush_births_packed_worlds runs it world by world
                       on a stacked batch
  flush_births         on the canonical PopulationState (the per-update
                       engine, ops/update.py): the torus fast path or the
                       general placement through the neighbor table
                       (grid or torus, BIRTH_METHOD 0-10), the birth
                       chamber of divide-sex sets, and the append of every
                       newborn to the systematics ring (nb_*)

Same PRNG splits, draw shapes and order as the reference, so both flushes
are bit-exact against it (tests/test_torch_birth.py,
tests/test_torch_update.py, tests/test_torch_placement.py,
tests/test_torch_sex.py).
"""

from __future__ import annotations

import numpy as np
import torch

from avida_tpu_torch.core.state import (is_smt, make_cell_inputs,
                                        smt_base_spaces)
from avida_tpu_torch.models.heads import MAX_LABEL_SIZE, SEM_H_DIVIDE_SEX
from avida_tpu_torch.utils import prng

_M32 = 0xFFFFFFFF
_OFFS_2D = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
            (1, 1))


def _roll2d(x, dy, dx, world_x, world_y):
    """Torus shift of a cell-indexed array: out[c] = x[cell at (y-dy,
    x-dx)]."""
    g = x.reshape((world_y, world_x) + tuple(x.shape[1:]))
    g = torch.roll(g, (dy, dx), dims=(0, 1))
    return g.reshape((world_x * world_y,) + tuple(x.shape[1:]))


def _pk_roll2d(x, dy, dx, wx, wy):
    """_roll2d along the LAST (cell) axis of [..., N] planes."""
    lead = tuple(x.shape[:-1])
    g = torch.roll(x.reshape(lead + (wy, wx)), (dy, dx), dims=(-2, -1))
    return g.reshape(lead + (wy * wx,))


def local_torus_fast_path(params, sexual: bool) -> bool:
    """Birth placement is neighbor-local on a torus (BIRTH_METHOD 0-3,
    asexual, no demes or population caps)."""
    return (params.geometry == 2
            and params.birth_method in (0, 1, 2, 3)
            and params.num_demes <= 1
            and not sexual
            and params.world_x > 2 and params.world_y > 2
            and params.population_cap == 0 and params.pop_cap_eldest == 0)


def neighbor_table(world_x: int, world_y: int, geometry: int,
                   seed: int = 0, scale_free_m: int = 3,
                   scale_free_alpha: float = 1.0,
                   scale_free_zero_appeal: float = 0.0) -> np.ndarray:
    """Static [N, C] neighbor cell ids, -1 = padding slot (ref
    cPopulation::SetupCellGrid cc:376-394 switching over nGeometry.h:30-37
    via the cTopology.h builders).  Geometries:

      1 GRID   bounded 8-neighborhood (edge cells have shorter lists)
      2 TORUS  wrapped 8-neighborhood (C=8, no padding)
      3 CLIQUE every cell connects to every other (build_clique h:103)
      4 HEX    grid minus the NE/SW diagonals (build_hex h:119)
      6 LATTICE 3-D lattice with z=1 == bounded grid (build_lattice h:137)
      7 RANDOM_CONNECTED random bidirectional graph grown to connectivity
               (build_random_connected_network h:232)
      8 SCALE_FREE preferential-attachment graph, P ~ (deg/|E|)^alpha +
               zero_appeal, m edges per new vertex (build_scale_free h:376)

    GLOBAL (0) and PARTIAL (5) are declared in nGeometry.h but have no
    case in the reference's own SetupCellGrid switch -- they raise here
    too.  Random geometries are frozen at world construction from `seed`
    (the reference also builds them once at setup)."""
    n = world_x * world_y
    # column k of the table MUST be the _OFFS_2D[k] displacement: the torus
    # fast path (local_torus_fast_path) replaces gathers on this table with
    # rolls by _OFFS_2D[k], so the two orderings may never diverge
    offs = _OFFS_2D

    def grid_like(skip=()):
        out = np.full((n, 8), -1, np.int32)
        for y in range(world_y):
            for x in range(world_x):
                c = y * world_x + x
                col = 0
                for k, (dy, dx) in enumerate(offs):
                    if (dy, dx) in skip:
                        continue
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < world_y and 0 <= nx < world_x:
                        out[c, col] = ny * world_x + nx
                        col += 1
        return out

    if geometry == 2:              # torus
        out = np.zeros((n, 8), np.int32)
        for y in range(world_y):
            for x in range(world_x):
                c = y * world_x + x
                for k, (dy, dx) in enumerate(offs):
                    out[c, k] = ((y + dy) % world_y) * world_x \
                        + (x + dx) % world_x
        return out
    if geometry in (1, 6):         # bounded grid; lattice with z=1 == grid
        return grid_like()
    if geometry == 4:              # hex: drop NE (-1,+1) and SW (+1,-1)
        return grid_like(skip={(-1, 1), (1, -1)})
    if geometry == 3:              # clique
        out = np.full((n, n - 1), -1, np.int32)
        ids = np.arange(n)
        for c in range(n):
            out[c] = np.concatenate([ids[:c], ids[c + 1:]])
        return out
    if geometry in (7, 8):
        rng = np.random.default_rng(seed + geometry)
        adj = [set() for _ in range(n)]
        if geometry == 7:          # random connected network
            connected = set()
            for i in range(n):
                j = i
                while j == i:
                    j = int(rng.integers(0, n))
                if j not in adj[i]:
                    adj[i].add(j)
                    adj[j].add(i)
                    connected.update((i, j))
            # grow to a single component like the reference's fix-up pass:
            # connect any stranded cell to a connected one
            comp = {0}
            frontier = [0]
            while frontier:
                c = frontier.pop()
                for d in adj[c]:
                    if d not in comp:
                        comp.add(d)
                        frontier.append(d)
            for i in range(n):
                if i not in comp:
                    j = int(rng.choice(sorted(comp)))
                    adj[i].add(j)
                    adj[j].add(i)
                    comp.add(i)
        else:                      # scale-free (build_scale_free h:376)
            adj[0].add(1)
            adj[1].add(0)
            edge_count = 1
            for u in range(2, n):
                to_add = min(u, scale_free_m)
                added = 0
                v = 0
                while added < to_add:
                    if v not in adj[u] and v != u:
                        p = (len(adj[v]) / edge_count) ** scale_free_alpha \
                            + scale_free_zero_appeal
                        if rng.random() < min(p, 1.0):
                            adj[u].add(v)
                            adj[v].add(u)
                            edge_count += 1
                            added += 1
                    v += 1
                    if v >= u:
                        v = 0
        deg = max(1, max(len(a) for a in adj))
        out = np.full((n, deg), -1, np.int32)
        for c in range(n):
            for k, d in enumerate(sorted(adj[c])):
                out[c, k] = d
        return out
    raise NotImplementedError(
        f"WORLD_GEOMETRY {geometry}: GLOBAL (0) and PARTIAL (5) have no "
        f"builder in the reference's cPopulation::SetupCellGrid either "
        f"(cPopulation.cc:376-394); supported: 1-4, 6-8")


def fast_torus_placement(params, k_place, pending, alive, time_used, merit):
    """Target selection + conflict resolution for the torus fast path.
    Returns (pending, births, parent_idx, won, dir_idx); dir_idx[cell] is
    the placement offset the newborn at `cell` came from (-1 = none)."""
    n = alive.shape[0]
    dev = alive.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    bm = params.birth_method
    wx, wy = params.world_x, params.world_y
    offs_all = _OFFS_2D + (((0, 0),) if params.allow_parent else ())
    ncand = len(offs_all)

    def nbr(x, k):
        dy, dx = offs_all[k]
        return _roll2d(x, -dy, -dx, wx, wy)

    occupied = torch.stack([nbr(alive, k) for k in range(ncand)], dim=1)
    u = prng.uniform(k_place, (n, ncand))
    empty_cand = ~occupied
    has_empty = empty_cand.any(dim=1)
    empty_pick = torch.argmax(torch.where(empty_cand, u, -1.0), dim=1)

    def pick_empty_first(occ_score):
        return torch.where(has_empty, empty_pick,
                           torch.argmax(occ_score, dim=1))

    if bm == 0:
        choice = (pick_empty_first(u) if params.prefer_empty
                  else torch.argmax(u, dim=1))
    elif bm == 1:
        occ_age = torch.where(occupied, torch.stack(
            [nbr(time_used, k) for k in range(ncand)], dim=1), 0)
        choice = pick_empty_first(occ_age.to(torch.float32) + u)
    elif bm == 2:
        occ_merit = torch.where(occupied, torch.stack(
            [nbr(merit, k) for k in range(ncand)], dim=1), 0)
        choice = pick_empty_first(-occ_merit.to(torch.float32) + u)
    else:
        choice = empty_pick
    if bm == 3:
        pending = pending & ~occupied.all(dim=1)

    BIG = 2**30
    claim = torch.full((n,), BIG, dtype=torch.int32, device=dev)
    dir_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pk_l, hit_l = [], []
    for k in range(ncand):
        dy, dx = offs_all[k]
        pk = _roll2d(rows, dy, dx, wx, wy)
        hit = _roll2d(pending, dy, dx, wx, wy) & (
            _roll2d(choice, dy, dx, wx, wy) == k)
        claim = torch.minimum(claim, torch.where(hit, pk, BIG))
        pk_l.append(pk)
        hit_l.append(hit)
    for k in range(ncand):
        dir_idx = torch.where(hit_l[k] & (pk_l[k] == claim), k, dir_idx)
    births = claim < BIG
    parent_idx = claim.clamp(0, n - 1)
    claim_at_tgt = torch.full((n,), BIG, dtype=torch.int32, device=dev)
    for k in range(ncand):
        claim_at_tgt = torch.where(choice == k, nbr(claim, k), claim_at_tgt)
    won = pending & (claim_at_tgt == rows)
    return pending, births, parent_idx, won, dir_idx


# ---- packed-plane helpers (word planes as uint32 patterns in int64) ----

def _bytemask(m):
    return torch.where(m >= 4, _M32, (1 << (8 * m.clamp(0, 3))) - 1)


def _pk_range_mask(LP, lo, hi, device):
    """uint32[LP, N] byte mask of tape positions [lo, hi)."""
    base = torch.arange(LP, dtype=torch.int64, device=device)[:, None] * 4
    return (_bytemask((hi[None].to(torch.int64) - base).clamp(0, 4))
            & ~_bytemask((lo[None].to(torch.int64) - base).clamp(0, 4))
            & _M32)


def _pk_set_byte(plane, pos, val):
    LP = plane.shape[0]
    rows = torch.arange(LP, dtype=torch.int64, device=plane.device)[:, None]
    pos = pos.to(torch.int64)
    sh = (pos & 3) * 8
    return torch.where(rows == (pos >> 2)[None],
                       (plane & ~(0xFF << sh) & _M32)
                       | (val.to(torch.int64) << sh), plane)


def _pk_shift_r1(plane):
    """out[q] = in[q - 1] (position 0 gets 0)."""
    up = torch.cat([torch.zeros_like(plane[:1]), plane[:-1]])
    return ((plane << 8) & _M32) | ((up >> 24) & 0xFF)


def _pk_shift_l1(plane):
    """out[q] = in[q + 1]."""
    down = torch.cat([plane[1:], torch.zeros_like(plane[:1])])
    return (plane >> 8) | ((down << 24) & _M32)


def _pk5_prefix_mask(L5, hi):
    """int32[L5, N] mask of positions [0, hi) of a 5-bit word plane
    (cycles.pack_words5's layout, transposed): _pk_range_mask(LP, 0, hi)
    under the codec.  Six fields a word fill 30 bits, so no shift
    reaches the sign bit."""
    m = (hi[None, :] - torch.arange(L5, dtype=torch.int32,
                                    device=hi.device)[:, None] * 6
         ).clamp(0, 6)
    return (1 << (5 * m)) - 1


def _pk_to_plane5(plane, L5):
    """A byte word plane ([LP, N] uint32 patterns, opcodes < 32 in every
    byte) -> the 5-bit word plane int32[L5, N]: the flush's bridge from
    the kernel's offspring plane to the 5-bit genome shadow."""
    LP, n = plane.shape
    b = torch.stack([(plane >> (8 * k)) & 0x1F for k in range(4)],
                    dim=1).reshape(LP * 4, n)
    pad = L5 * 6 - LP * 4
    if pad > 0:
        b = torch.cat([b, b.new_zeros((pad, n))])
    g = b[:L5 * 6].reshape(L5, 6, n)
    sh = (torch.arange(6, dtype=torch.int64, device=plane.device) * 5)[
        None, :, None]
    return (g << sh).sum(dim=1).to(torch.int32)


def _to_i32(x):
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def pk_extract_offspring(params, key, off_t, off_len, genome_len,
                         divide_pending):
    """Divide mutations on the packed offspring plane (the reference's
    _pk_extract_offspring, draw for draw).  `off_t` is uint32 words in
    int64.  Returns (off plane, off_len)."""
    from avida_tpu_torch.ops.interpreter import random_inst
    LP, n = off_t.shape
    dev = off_t.device
    L0 = params.max_memory
    zeros_n = torch.zeros(n, dtype=torch.int32, device=dev)
    fullL = torch.full((n,), LP * 4, dtype=torch.int32, device=dev)

    off = off_t & _pk_range_mask(LP, zeros_n, off_len, dev)
    gsize = genome_len.to(torch.float32)
    max_sz = (gsize * torch.tensor(params.offspring_size_range,
                                   dtype=torch.float32)).to(torch.int32
                                                            ).clamp(max=L0)
    div_m = divide_pending
    ks = prng.split(key, 5)
    k_u, k_mpos, k_ipos, k_dpos, k_iinst = (ks[i] for i in range(5))
    u_mut = prng.uniform(k_u, (n, 3))
    r_inst2 = random_inst(params, k_iinst, (n, 2))

    def ins1(off, off_len, ipos, iv, do):
        sel = _pk_range_mask(LP, ipos + 1, fullL, dev)
        out = (_pk_shift_r1(off) & sel) | (off & ~sel & _M32)
        out = _pk_set_byte(out, ipos, iv)
        return (torch.where(do[None], out, off),
                torch.where(do, off_len + 1, off_len))

    def del1(off, off_len, dpos, do):
        sel = _pk_range_mask(LP, dpos, fullL, dev)
        out = (_pk_shift_l1(off) & sel) | (off & ~sel & _M32)
        out = out & _pk_range_mask(LP, zeros_n, off_len - 1, dev)
        return (torch.where(do[None], out, off),
                torch.where(do, off_len - 1, off_len))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    if params.div_mut_prob > 0:
        k_dm = prng.fold_in(key, 0xD1)
        n_sub = prng.binomial(k_dm, off_len.clamp(min=1).to(torch.float32),
                              params.div_mut_prob).clamp(0, 8).to(torch.int32)
        for k in range(8):
            kk = prng.fold_in(k_dm, k + 1)
            site = prng.randint(kk, (n,), 0, off_len.clamp(min=1))
            rv = random_inst(params, prng.fold_in(kk, 3), (n,))
            do = div_m & (k < n_sub) & (off_len > 0)
            off = torch.where(do[None], _pk_set_byte(off, site, rv), off)
    if params.divide_mut_prob > 0:
        mpos = prng.randint(k_mpos, (n,), 0, off_len.clamp(min=1))
        do_sub = div_m & (u_mut[:, 0] < f32(params.divide_mut_prob)) \
            & (off_len > 0)
        off = torch.where(do_sub[None],
                          _pk_set_byte(off, mpos, r_inst2[:, 0]), off)
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
    return off, off_len


def flush_births_packed(params, st, key, planes, update_no,
                        fresh_mirrors=False):
    """The reference's flush_births_packed on the five resident planes
    (tape_t, off_t, gen_t, ivec, fvec), cell-ordered.  Always updates
    the canonical columns unpack cannot rebuild on `st`;
    `fresh_mirrors=True` (the row-space body, ops/packed_chunk.py) also
    refreshes the plane-backed mirrors (alive, merit, gestation_time,
    generation, and under TPU_TRACE mem_len, heads and task_exe_total)
    that its canonical-state phases read mid-chunk; the fused body
    leaves them stale until unpack rebuilds them.  Returns (planes',
    st')."""
    from avida_tpu_torch.ops import cycles as pc
    tape_t, off_t, gen_t, ivec, fvec = planes
    LP, n = tape_t.shape
    dev = tape_t.device
    R = params.num_reactions
    NI, LW, IV_COPIED_BM, IV_DYN = pc.layout(params, LP * 4)
    wx, wy = params.world_x, params.world_y
    zeros_n = torch.zeros(n, dtype=torch.int32, device=dev)

    ks = prng.split(key, 4)
    k_place, k_inputs, k_off = ks[0], ks[1], ks[2]

    flags = ivec[pc.IV_FLAGS]
    alive = (flags & pc.FLAG_ALIVE) != 0
    divide_pending = (flags & pc.FLAG_DIVPEND) != 0
    pending = divide_pending & alive

    genome_len = ivec[pc.IV_GENOME_LEN]
    merit = fvec[pc.FV_MERIT]
    off_w, off_len = pk_extract_offspring(
        params, k_off, off_t.to(torch.int64) & _M32, ivec[pc.IV_OFF_LEN],
        genome_len, divide_pending)
    fresh_inputs = make_cell_inputs(k_inputs, n)

    pending, births, parent_idx, won, dir_idx = fast_torus_placement(
        params, k_place, pending, alive, ivec[pc.IV_TIME_USED], merit)

    # breed-true: the offspring against the parent's birth genome, word
    # by word over the offspring's positions; under the 5-bit codec the
    # offspring plane is bridged into the codec first (opcodes < 32, so
    # the 5-bit compare decides the byte compare), and the bridged plane
    # is the newborn genome written below
    from avida_tpu_torch.ops.packed_chunk import bits_active
    bits5 = bits_active(params)
    if bits5:
        off_w5 = _pk_to_plane5(off_w, gen_t.shape[0])
        diff = (off_w5 ^ gen_t) & _pk5_prefix_mask(gen_t.shape[0], off_len)
    else:
        diff = (off_w ^ (gen_t.to(torch.int64) & _M32)) & _pk_range_mask(
            LP, zeros_n, off_len, dev)
    is_breed_true = (off_len == genome_len) & ~(diff != 0).any(dim=0)

    if params.death_method == 2:
        max_exec = params.age_limit * off_len
    elif params.death_method == 1:
        max_exec = torch.full_like(off_len, params.age_limit)
    else:
        max_exec = torch.full_like(off_len, 2**30)

    offs_all = _OFFS_2D + (((0, 0),) if params.allow_parent else ())

    def by_parent(x):
        out = torch.zeros_like(x)
        for k, (dy, dx) in enumerate(offs_all):
            out = torch.where(dir_idx == k, _pk_roll2d(x, dy, dx, wx, wy),
                              out)
        return out

    gim_inc = 0 if params.generation_inc_method == 1 else 1
    imat = torch.stack(
        [off_len, max_exec, ivec[pc.IV_GEST_TIME], ivec[pc.IV_EXEC_SIZE],
         ivec[pc.IV_CHILD_COPIED], ivec[pc.IV_GENERATION] + gim_inc,
         is_breed_true.to(torch.int32)]
        + [ivec[IV_DYN + 2 * R + r] for r in range(R)])
    fmat = torch.stack([merit, fvec[pc.FV_FITNESS], fvec[pc.FV_LAST_BONUS],
                        fvec[pc.FV_LAST_MERIT_BASE]])
    mvi = by_parent(imat)
    mvf = by_parent(fmat)
    mv_plane = _to_i32(by_parent(off_w))

    b = births
    zrows = [pc.IV_ACTIVE_STACK, pc.IV_READ_LABEL_LEN, pc.IV_INPUT_PTR,
             pc.IV_INPUT_BUF_N, pc.IV_OUTPUT_BUF, pc.IV_TIME_USED,
             pc.IV_CPU_CYCLES, pc.IV_GEST_START, pc.IV_CHILD_COPIED,
             pc.IV_NUM_DIVIDES, pc.IV_OFF_START, pc.IV_OFF_LEN,
             pc.IV_OFF_COPIED, pc.IV_INSTS_EXEC, pc.IV_COST_WAIT,
             pc.IV_FT_LO, pc.IV_FT_HI, pc.IV_OFF_SEX]
    zrows += [pc.IV_REGS + k for k in range(3)]
    zrows += [pc.IV_HEADS + k for k in range(4)]
    zrows += [pc.IV_SP + k for k in range(2)]
    zrows += [pc.IV_INPUT_BUF + k for k in range(3)]
    zrows += [pc.IV_READ_LABEL + k for k in range(MAX_LABEL_SIZE)]
    zrows += [pc.IV_STACKS + k for k in range(20)]
    zrows += [pc.IV_EXEC_BM + w for w in range(LW)]
    zrows += [IV_COPIED_BM + w for w in range(LW)]
    zrows += [IV_DYN + r for r in range(2 * R)]
    zmask = torch.zeros(NI, dtype=torch.bool, device=dev)
    zmask[zrows] = True
    ivec = torch.where(zmask[:, None] & b[None], 0, ivec)

    for i, v in ((pc.IV_MEM_LEN, mvi[0]), (pc.IV_GENOME_LEN, mvi[0]),
                 (pc.IV_COPIED_SIZE, mvi[4]), (pc.IV_MAX_EXEC, mvi[1]),
                 (pc.IV_GEST_TIME, mvi[2]), (pc.IV_EXEC_SIZE, mvi[3]),
                 (pc.IV_GENERATION, mvi[5])):
        ivec[i] = torch.where(b, v, ivec[i])
    for k in range(3):
        ivec[pc.IV_INPUTS + k] = torch.where(b, fresh_inputs[:, k],
                                             ivec[pc.IV_INPUTS + k])
    for r in range(R):
        ivec[IV_DYN + 2 * R + r] = torch.where(b, mvi[7 + r],
                                               ivec[IV_DYN + 2 * R + r])

    fvec = fvec.clone()
    fvec[pc.FV_MERIT] = torch.where(b, mvf[0], merit)
    fvec[pc.FV_CUR_BONUS] = torch.where(
        b, torch.tensor(params.default_bonus, dtype=torch.float32),
        fvec[pc.FV_CUR_BONUS])
    fvec[pc.FV_FITNESS] = torch.where(b, mvf[1], fvec[pc.FV_FITNESS])
    fvec[pc.FV_LAST_BONUS] = torch.where(b, mvf[2], fvec[pc.FV_LAST_BONUS])
    fvec[pc.FV_LAST_MERIT_BASE] = torch.where(b, mvf[3],
                                              fvec[pc.FV_LAST_MERIT_BASE])

    tape_t = torch.where(b[None], mv_plane, tape_t)
    gen_t = torch.where(b[None], by_parent(off_w5) if bits5 else mv_plane,
                        gen_t)
    off_t = torch.where(b[None], 0, off_t)

    # newborns are ALIVE only; winners and dead parents resume; the
    # kernel's NEWDIV bit clears everywhere
    flags_b = torch.where(b, pc.FLAG_ALIVE, flags)
    alive_post = (flags_b & pc.FLAG_ALIVE) != 0
    divp_b = (flags_b & pc.FLAG_DIVPEND) != 0
    cleared = torch.where(won | ~alive_post, False, divp_b)
    ivec[pc.IV_FLAGS] = ((flags_b & ~(pc.FLAG_DIVPEND | pc.FLAG_NEWDIV))
                         | torch.where(cleared, pc.FLAG_DIVPEND, 0))
    off_sex_b = torch.where(b, 0, ivec[pc.IV_OFF_SEX])
    ivec[pc.IV_OFF_SEX] = torch.where(cleared, off_sex_b, 0)

    upd = dict(
        breed_true=torch.where(b, mvi[6] != 0, st.breed_true),
        parent_id=torch.where(b, parent_idx, st.parent_id),
        birth_update=torch.where(b, int(update_no), st.birth_update),
        genotype_id=torch.where(b, -1, st.genotype_id),
        budget_carry=torch.where(b, 0, st.budget_carry),
        mating_type=torch.where(b, -1, st.mating_type),
        energy_spent=torch.where(b, 0.0, st.energy_spent),
    )
    if fresh_mirrors:
        upd.update(alive=alive_post, merit=fvec[pc.FV_MERIT].clone(),
                   gestation_time=ivec[pc.IV_GEST_TIME].clone(),
                   generation=ivec[pc.IV_GENERATION].clone())
    if int(params.trace_cap):
        # the trace emission reads these canonical fields mid-chunk
        upd.update(
            mem_len=ivec[pc.IV_MEM_LEN].clone(),
            heads=torch.stack([ivec[pc.IV_HEADS + k] for k in range(4)],
                              dim=1),
            task_exe_total=torch.stack(
                [ivec[IV_DYN + 3 * R + r] for r in range(R)], dim=1))
    st = st.replace(**upd)
    return (tape_t, off_t, gen_t, ivec, fvec), st


def flush_births_packed_worlds(params, sts, keys, planes, update_no,
                               fresh_mirrors=False):
    """The world-blocked packed flush of a stacked batch (the reference's
    flush_births_packed_worlds, birth.py:1448).  `planes` carry lanes
    split [rows, W, N]; `sts`, `keys` and `update_no` hold one entry per
    world.  Each world is flushed alone on its own [rows, N] slice, so
    every torus roll and newborn scatter stays inside that world (a birth
    at a world's last lane never touches the next world) and each world
    consumes its own key and stamps its own update number.  Returns
    (planes', sts')."""
    outs, new_sts = [], []
    for w, st in enumerate(sts):
        pl, st = flush_births_packed(params, st, keys[w],
                                     tuple(p[:, w] for p in planes),
                                     update_no[w], fresh_mirrors)
        outs.append(pl)
        new_sts.append(st)
    return (tuple(torch.stack([o[j] for o in outs], dim=1)
                  for j in range(len(planes))), new_sts)


# ---- the canonical flush (the per-update engine) ----

# newborn fields written at the target cell with a constant (the
# reference's const_updates, flush_births); birth_update and cur_bonus
# are added per call
_CONST_UPDATES = {
    "regs": 0, "heads": 0, "stacks": 0, "sp": 0, "active_stack": 0,
    "read_label": 0, "read_label_len": 0,
    "mal_active": False, "alive": True, "sterile": False,
    "input_ptr": 0, "input_buf": 0, "input_buf_n": 0, "output_buf": 0,
    "cur_task_count": 0, "cur_reaction_count": 0,
    "time_used": 0, "cpu_cycles": 0, "gestation_start": 0,
    "child_copied_size": 0, "num_divides": 0,
    "divide_pending": False, "off_start": 0, "off_len": 0,
    "off_tape": 0, "off_copied_size": 0, "genotype_id": -1,
    "insts_executed": 0, "budget_carry": 0,
    "cost_wait": 0, "ft_paid_lo": 0, "ft_paid_hi": 0,
    "energy_spent": 0.0,
    "t_alive": False, "main_tid": 0, "t_ids": 0, "cur_thread": 0,
    "t_regs": 0, "t_heads": 0, "t_stack": 0, "t_sp": 0,
    "t_active_stack": 0, "t_rlabel": 0, "t_rlabel_len": 0,
    "mating_type": -1,
    "smt_aux": 0, "smt_aux_len": 0, "pmem": 0, "pmem_len": 0,
    "parasite_active": False, "smt_stacks": 0, "smt_sp": 0, "gstack": 0,
    "gsp": 0, "smt_head_pos": 0, "inject_pending": False,
    "inj_mem": 0, "inj_len": 0,
}


def has_divide_sex(params) -> bool:
    """Does the instruction set contain divide-sex?"""
    return any(int(s) == SEM_H_DIVIDE_SEX for s in params.sem)


def canonical_unsupported_reason(params) -> str | None:
    """Why this package's canonical flush cannot run `params` (None = it
    can): every branch of the reference's flush is ported.  The
    geometries the reference builds no table for raise in
    neighbor_table, in its words."""
    if not 0 <= params.birth_method <= 11:
        return f"BIRTH_METHOD {params.birth_method}"
    return None


def _where_rows(mask, val, dst):
    """dst with the rows under bool[N] `mask` replaced by `val` (a tensor
    broadcastable to dst, or a scalar)."""
    m = mask.reshape((mask.shape[0],) + (1,) * (dst.ndim - 1))
    if not torch.is_tensor(val):
        val = torch.tensor(val, dtype=dst.dtype, device=dst.device)
    return torch.where(m, val.to(dst.dtype), dst)


def _f32t(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


# ---- the birth chamber (sexual reproduction) ----

def recombine_sexual(params, st, key, off_mem, off_len, pending):
    """Birth-chamber pairing and one-region crossover (the reference's
    recombine_sexual; cBirthChamber::SubmitOffspring cc:443,
    DoBasicRecombination cc:290, RegionSwap cc:178).  Without mating
    types every sexual offspring pending at flush time -- the waiting
    store entry first, then cells in index order -- pairs with its
    neighbour in that order (rank r mates rank r ^ 1).  With MATING_TYPES
    (cBirthMatingTypeGlobalHandler::SelectOffspring) juvenile parents
    lose their offspring, and male rank r mates female rank r, the ranks
    drawn at random within each type each flush (the store entry holds
    rank 0 of its own type).  The odd one out moves into the
    single-entry store and its parent resumes; further waiters are
    dropped.  The row paired with the store is a dual parent: it also
    carries the store-flank child.

    Returns (off_mem, off_len, child_merit, placeable_pending, dual,
    dual_mem, dual_len, dual_merit, store), store = (bc_mem, bc_len,
    bc_merit, bc_valid, bc_type)."""
    from avida_tpu_torch.ops.interpreter import roll_right
    n, L = off_mem.shape
    dev = off_mem.device
    i32 = torch.int32
    rows = torch.arange(n, dtype=i32, device=dev)
    sexp = pending & st.off_sex
    has_store = st.bc_valid
    hs = has_store.to(i32)

    if params.mating_types:
        ptype = st.mating_type
        juv_drop = sexp & (ptype == -1)
        sexp = sexp & ~juv_drop
        is_m = sexp & (ptype == 1)
        is_f = sexp & (ptype == 0)
        store_m = has_store & (st.bc_type == 1)
        store_f = has_store & (st.bc_type == 0)
        u_pair = prng.uniform(prng.fold_in(key, 0x9A13), (n,))
        inf = _f32t(float("inf"), dev)

        def rand_rank(mask):
            # each row's rank among the mask rows, ordered by u_pair (the
            # other rows sort after them, in index order)
            order = torch.argsort(torch.where(mask, u_pair, inf),
                                  stable=True)
            r = torch.empty(n, dtype=i32, device=dev)
            r[order] = rows
            return r

        rank_m = rand_rank(is_m) + store_m.to(i32)
        rank_f = rand_rank(is_f) + store_f.to(i32)
        rank = torch.where(is_m, rank_m, rank_f)
        pairs = torch.minimum(is_m.sum() + store_m.to(i32),
                              is_f.sum() + store_f.to(i32))
        paired = sexp & (rank < pairs)

        def row_of(mask, r):
            # rank -> row; rows off the mask (and a rank of n) land in the
            # extra slot n, which is cut off (the reference's mode="drop")
            out = torch.zeros(n + 1, dtype=i32, device=dev)
            out[torch.where(mask, r, n).long()] = rows
            return out[:n]

        row_of_m, row_of_f = row_of(is_m, rank_m), row_of(is_f, rank_f)
        rc = rank.clamp(0, n - 1).long()
        mate_row = torch.where(is_m, row_of_f[rc], row_of_m[rc]).long()
        store_paired = paired & (rank == 0) & torch.where(is_m, store_f,
                                                          store_m)
        dropped = juv_drop
    else:
        # rank sexual rows by cell index, shifted by 1 when the store
        # entry is occupied (the store is rank 0); rank r mates rank r ^ 1
        rank = torch.cumsum(sexp.to(i32), 0).to(i32) - 1 + hs
        total = sexp.sum().to(i32) + hs
        mate_rank = rank ^ 1
        paired = sexp & (mate_rank < total)
        store_paired = paired & (mate_rank == 0) & has_store
        keep = sexp & (rank < n)
        rank_to_row = torch.zeros(n, dtype=i32, device=dev)
        rank_to_row[rank[keep].long()] = rows[keep]
        mate_row = rank_to_row[mate_rank.clamp(0, n - 1).long()].long()
        dropped = torch.zeros_like(sexp)

    mate_mem = torch.where(store_paired[:, None], st.bc_mem[None, :],
                           off_mem[mate_row])
    mate_len = torch.where(store_paired, st.bc_len, torch.where(
        paired, off_len[mate_row], 1)).clamp(min=1)
    mate_merit = torch.where(store_paired, st.bc_merit, st.merit[mate_row])
    own_len = off_len.clamp(min=1)

    # per-pair draws: both members read the pair representative's values
    # (the store-paired row is its own representative)
    ks = prng.split(key, 3)
    pair_lo = torch.where(store_paired, rows,
                          torch.minimum(rows, mate_row.to(torch.int32))).long()
    u_rec = prng.uniform(ks[0], (n,))[pair_lo]
    f0 = prng.uniform(ks[1], (n,))[pair_lo]
    f1 = prng.uniform(ks[2], (n,))[pair_lo]
    if params.module_num > 0:
        # crossover points snap to module boundaries
        # (DoModularContRecombination, cBirthChamber.cc:316-330)
        M = _f32t(float(params.module_num), dev)
        f0 = torch.floor(f0 * M) / M
        f1 = torch.floor(f1 * M) / M
    start_frac = torch.minimum(f0, f1)
    end_frac = torch.maximum(f0, f1)
    cut_frac = end_frac - start_frac

    def at(frac, length):
        return (frac * length.to(torch.float32)).to(torch.int32)

    s0, e0 = at(start_frac, own_len), at(end_frac, own_len)
    s1, e1 = at(start_frac, mate_len), at(end_frac, mate_len)
    size0, size1 = e0 - s0, e1 - s1
    new_len = off_len - size0 + size1
    new_len_mate = mate_len - size1 + size0
    # RegionSwap refuses illegal offspring on either side (cc:193-196)
    mg = params.min_genome_len
    legal = ((new_len >= mg) & (new_len <= L)
             & (new_len_mate >= mg) & (new_len_mate <= L))
    do_rec = paired & (u_rec < _f32t(params.recombination_prob, dev)) \
        & legal

    # own-flank child = own[:s0] ++ mate[s1:e1] ++ own[e0:]
    cols = torch.arange(L, device=dev)[None, :]
    zero = torch.zeros((), dtype=off_mem.dtype, device=dev)
    child = torch.where(cols < s0[:, None], off_mem, torch.where(
        cols < (s0 + size1)[:, None], roll_right(mate_mem, s0 - s1, L),
        roll_right(off_mem, s0 + size1 - e0, L)))
    child = torch.where(cols < new_len[:, None], child, zero)
    # store-flank child (meaningful on the dual row only) =
    # mate[:s1] ++ own[s0:e0] ++ mate[e1:]
    child2 = torch.where(cols < s1[:, None], mate_mem, torch.where(
        cols < (s1 + size0)[:, None], roll_right(off_mem, s1 - s0, L),
        roll_right(mate_mem, s1 + size0 - e1, L)))
    child2 = torch.where(cols < new_len_mate[:, None], child2, zero)
    dual = store_paired
    dual_mem = torch.where(do_rec[:, None], child2, mate_mem)
    dual_len = torch.where(do_rec, new_len_mate, mate_len)

    # merit mix (DoBasicRecombination): own*stay + mate*cut.  The
    # reference's compiled CPU program (the jitted update) fuses one
    # product of each mix into its add: in the dual mix the one holding
    # the row's own merit; in the child's mix the same without mating
    # types, the mate's with them (tests/test_torch_sex.py and
    # tests/test_torch_mating.py run it jitted)
    stay = 1.0 - cut_frac
    if params.mating_types:
        mixed = prng.fma_f32(mate_merit, cut_frac, st.merit * stay)
    else:
        mixed = prng.fma_f32(st.merit, stay, mate_merit * cut_frac)
    child_merit = torch.where(do_rec, mixed, st.merit)
    dual_merit = torch.where(do_rec, prng.fma_f32(
        st.merit, cut_frac, mate_merit * stay), mate_merit)
    off_mem = torch.where(do_rec[:, None], child, off_mem)
    off_len = torch.where(do_rec, new_len, off_len)

    # the odd one out moves into the store and its parent resumes
    unpaired = sexp & ~paired
    leftover = unpaired & (torch.cumsum(unpaired.to(torch.int32), 0) == 1)
    dropped = dropped | (unpaired & ~leftover)
    # the occupant keeps its slot unless a pairing consumed it this flush
    slot_free = ~has_store | store_paired.any()
    dropped = dropped | (leftover & ~slot_free)
    leftover = leftover & slot_free
    any_left = leftover.any()
    new_bc_mem = torch.where(
        any_left, torch.where(leftover[:, None], off_mem.to(torch.int32),
                              0).sum(dim=0, dtype=torch.int32).to(
            torch.int8), st.bc_mem)
    new_bc_len = torch.where(
        any_left, torch.where(leftover, off_len, 0).sum().to(torch.int32),
        st.bc_len)
    new_bc_merit = torch.where(
        any_left, torch.where(leftover, st.merit, 0.0).sum(),
        st.bc_merit)
    new_bc_valid = torch.where(any_left, True,
                               has_store & ~store_paired.any())
    placeable = pending & ~leftover & ~dropped
    new_bc_type = torch.where(
        any_left, torch.where(leftover, st.mating_type, 0).sum().to(i32)
        if params.mating_types else -1, st.bc_type)
    store = (new_bc_mem, new_bc_len, new_bc_merit, new_bc_valid, new_bc_type)
    return (off_mem, off_len, child_merit, placeable,
            dual, dual_mem, dual_len, dual_merit, store)


# ---- placement off the torus fast path ----

_NEIGHBORS = {}        # (world shape, geometry, topology, device) -> table


def neighbors_on(params, device, seed: int = 0, scale_free_m: int = 3,
                 scale_free_alpha: float = 1.0,
                 scale_free_zero_appeal: float = 0.0) -> torch.Tensor:
    """The static neighbor table on `device`, built once per world shape,
    geometry and -- for the random geometries (7, 8), whose graph is drawn
    from them -- the seed and the scale-free parameters (the reference's
    World builds it from max(RANDOM_SEED, 0) and SCALE_FREE_*)."""
    topo = ((int(seed), int(scale_free_m), float(scale_free_alpha),
             float(scale_free_zero_appeal))
            if params.geometry in (7, 8) else ())
    k = (params.world_x, params.world_y, params.geometry, topo, str(device))
    if k not in _NEIGHBORS:
        _NEIGHBORS[k] = torch.from_numpy(neighbor_table(
            params.world_x, params.world_y, params.geometry,
            *topo)).to(device)
    return _NEIGHBORS[k]


def general_placement(params, k_place, pending, alive, time_used, merit,
                      neighbors, energy_spent=None, facing=None):
    """Target selection and conflict resolution through the neighbor
    table (the reference's general branch, PositionOffspring cc:5185,
    BIRTH_METHOD 0-11): candidate cells with padding, the empty-first
    lexicographic pick, the method's target, then the lowest pending
    parent index claims each cell (a scatter-min).  `energy_spent` is
    the energy model's used energy (BIRTH_METHOD 9 and 10 read time used
    without it); `facing` is experimental hardware's facing, which
    BIRTH_METHOD 7 follows (a parent facing off a bounded grid leaves
    `pending`: its offspring is dropped).  Returns (pending, births,
    parent_idx, won, cand, u, choice, occupied); the last four feed the
    sexual second birth."""
    n = alive.shape[0]
    dev = alive.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    rl = rows.long()
    bm = params.birth_method
    cand = neighbors.to(torch.int32)
    pad = cand < 0             # padding slots never win
    cand = torch.where(pad, rows[:, None], cand)
    cpd = params.num_cells // max(params.num_demes, 1)
    if params.num_demes > 1:
        # deme-local placement: a candidate in another deme collapses to
        # the parent's cell (only migration crosses demes)
        cand = torch.where(cand // cpd == (rows // cpd)[:, None], cand,
                           rows[:, None])
    if params.allow_parent and bm in (0, 1, 2, 3):
        cand = torch.cat([cand, rows[:, None]], dim=1)
        pad = torch.cat([pad, torch.zeros((n, 1), dtype=torch.bool,
                                          device=dev)], dim=1)
    ncand = cand.shape[1]
    cl = cand.long()
    occupied = alive[cl]
    u = prng.uniform(k_place, (n, ncand))
    real = ~pad
    empty_cand = real & ~occupied
    has_empty = empty_cand.any(dim=1)
    empty_pick = torch.argmax(torch.where(empty_cand, u, -1.0), dim=1)
    neg_inf = _f32t(float("-inf"), dev)

    def pick_empty_first(occ_score):
        occ_pick = torch.argmax(torch.where(real, occ_score, neg_inf), dim=1)
        return torch.where(has_empty, empty_pick, occ_pick)

    if bm == 0 and params.prefer_empty:
        choice = pick_empty_first(u)
    elif bm == 1:              # AGE: the oldest neighbor, empty first
        occ_age = torch.where(occupied, time_used[cl], 0)
        choice = pick_empty_first(occ_age.to(torch.float32) + u)
    elif bm == 2:              # MERIT: the lowest-merit neighbor
        occ_merit = torch.where(occupied, merit[cl], 0.0)
        choice = pick_empty_first(-occ_merit.to(torch.float32) + u)
    elif bm == 3:              # EMPTY: only empty neighbors qualify
        choice = empty_pick
    else:
        choice = torch.argmax(torch.where(real, u, -1.0), dim=1)
    target = cand[rl, choice]
    if bm == 3:
        pending = pending & ~occupied.all(dim=1)
    elif bm == 4:              # FULL_SOUP_RANDOM (inside the deme)
        if params.num_demes > 1:
            r = prng.randint(prng.fold_in(k_place, 4), (n,), 0, cpd)
            target = (rows // cpd) * cpd + r
        else:
            target = prng.randint(prng.fold_in(k_place, 4), (n,), 0, n)
    elif bm == 5:              # FULL_SOUP_ELDEST: the globally oldest
        age = torch.where(alive, time_used, 2**30)
        target = torch.argmax(age).to(torch.int32).expand(n)
    elif bm == 6:              # DEME_RANDOM
        r = prng.randint(prng.fold_in(k_place, 6), (n,), 0, cpd)
        target = (rows // cpd) * cpd + r
    elif bm == 7 and facing is not None:    # PARENT_FACING on
        #                        experimental hardware: one step along the
        #                        parent's real facing
        from avida_tpu_torch.ops.interpreter import facing_step
        ftgt, fvalid = facing_step(params, rows, facing,
                                   torch.ones_like(rows))
        target = torch.where(fvalid, ftgt, rows)
        pending = pending & fvalid
    elif bm == 7:              # PARENT_FACING: heads hardware faces
        #                        connection 0
        target = torch.where(neighbors[:, 0] < 0, rows,
                             neighbors[:, 0].to(torch.int32))
    elif bm == 8:              # NEXT_CELL
        target = (rows + 1) % n
    elif bm == 9:              # FULL_SOUP_ENERGY_USED: empty cells
        #                        first, random tiebreak
        used9 = (energy_spent if energy_spent is not None
                 else time_used.to(torch.float32))
        u9 = prng.uniform(prng.fold_in(k_place, 9), (n,))
        dead_pick = torch.argmax(torch.where(alive, -1.0, u9))
        live_pick = torch.argmax(torch.where(alive, used9 + u9, neg_inf))
        target = torch.where((~alive).any(), dead_pick, live_pick).to(
            torch.int32).expand(n)
    elif bm == 10:             # NEIGHBORHOOD_ENERGY_USED
        used10 = (energy_spent if energy_spent is not None
                  else time_used.to(torch.float32))
        choice10 = pick_empty_first(
            torch.where(occupied, used10[cl], 0.0) + u)
        target = cand[rl, choice10]
    elif bm == 11:             # DISPERSAL (cc:5363): Poisson(DISPERSAL_RATE)
        #                        random single-cell hops, at most 8
        target = dispersal_targets(params, prng.fold_in(k_place, 11), rows)
    if params.num_demes > 1:
        if bm in (5, 7, 8):
            # an absolute target in another deme collapses to the parent
            target = torch.where(target // cpd == rows // cpd, target, rows)
        if params.demes_migration_rate > 0:
            target = migrate_targets(params, k_place, pending, target)

    BIG = 2**30
    claim = torch.full((n,), BIG, dtype=torch.int32, device=dev)
    claim = claim.scatter_reduce(
        0, torch.where(pending, target, rows).long(),
        torch.where(pending, rows, BIG), "amin", include_self=True)
    births = claim < BIG
    parent_idx = claim.clamp(0, n - 1)
    won = pending & (claim[target.long()] == rows)
    return pending, births, parent_idx, won, cand, u, choice, occupied


_MIG_DY = (-1, -1, -1, 0, 0, 1, 1, 1)
_MIG_DX = (-1, 0, 1, -1, 1, -1, 0, 1)


def dispersal_targets(params, k11, rows):
    """BIRTH_METHOD 11's targets: each offspring takes min(Poisson(
    DISPERSAL_RATE), 8) hops from its parent's cell, hop h in the 8-
    neighbour direction randint(fold_in(k11, h + 1), 0, 8), wrapped on
    the torus and clamped on every other geometry."""
    n = rows.shape[0]
    wx, wy = params.world_x, params.world_y
    hops = prng.poisson(prng.fold_in(k11, 0), params.dispersal_rate,
                        (n,)).clamp(0, 8)
    dx_t = torch.tensor(_MIG_DX, dtype=torch.int32, device=rows.device)
    y, x = rows // wx, rows % wx
    for h in range(8):
        d = prng.randint(prng.fold_in(k11, h + 1), (n,), 0, 8)
        step = h < hops
        dy = torch.where(d < 3, -1, torch.where(d < 5, 0, 1))
        dx = dx_t[d.long()]
        if params.geometry == 2:
            y = torch.where(step, (y + dy) % wy, y)
            x = torch.where(step, (x + dx) % wx, x)
        else:
            y = torch.where(step, (y + dy).clamp(0, wy - 1), y)
            x = torch.where(step, (x + dx).clamp(0, wx - 1), x)
    return (y * wx + x).to(torch.int32)


def migrate_targets(params, k_place, pending, target):
    """DEMES_MIGRATION_RATE (cPopulation.cc:5508-5600): each pending
    offspring migrates with that probability to a random cell of another
    deme, picked by DEMES_MIGRATION_METHOD: 0 uniform over the other
    demes, 1 a random 8-neighbor on the DEMES_NUM_X deme grid, 2 the
    previous or next deme, 4 the MIGRATION_FILE weights.  Method 3 (deme
    points) is refused, as in the reference."""
    n = pending.shape[0]
    dev = pending.device
    D = params.num_demes
    cpd = params.num_cells // D
    ks = prng.split(prng.fold_in(k_place, 1), 3)
    k_mig, k_mcell, k_mdeme = ks[0], ks[1], ks[2]
    migrate = (prng.uniform(k_mig, (n,)) < prng.round_f32(
        params.demes_migration_rate)) & pending
    home = torch.arange(n, dtype=torch.int32, device=dev) // cpd
    mm = params.demes_migration_method
    if mm == 0:
        d_r = prng.randint(k_mdeme, (n,), 0, D - 1)
        mig_deme = torch.where(d_r >= home, d_r + 1, d_r)
    elif mm == 1:
        xs = params.demes_num_x
        ys = D // xs
        d8 = prng.randint(k_mdeme, (n,), 0, 8).long()
        dy = torch.tensor(_MIG_DY, dtype=torch.int32, device=dev)[d8]
        dx = torch.tensor(_MIG_DX, dtype=torch.int32, device=dev)[d8]
        mx = torch.remainder(home % xs + dx + xs, xs)
        my = torch.remainder(home // xs + dy + ys, ys)
        mig_deme = mx + xs * my
    elif mm == 2:
        pm = prng.randint(k_mdeme, (n,), 0, 2) * 2 - 1
        mig_deme = torch.remainder(home + pm + D, D)
    elif mm == 4:
        u_d = prng.uniform(k_mdeme, (n,))
        cdf = torch.tensor(params.migration_cdf, dtype=torch.float32,
                           device=dev)
        mig_deme = (u_d[:, None] >= cdf[home.long()]).sum(dim=1).to(
            torch.int32).clamp(0, D - 1)
    else:
        raise NotImplementedError(f"DEMES_MIGRATION_METHOD {mm}")
    mig_cell = mig_deme * cpd + prng.randint(k_mcell, (n,), 0, cpd)
    return torch.where(migrate, mig_cell, target)


# ---- the canonical flush (the per-update engine) ----

def newborn_fields(params, st, births, by_parent, off_mem, off_len,
                   child_merit, fresh_inputs, update_no):
    """The fields of every cell receiving a newborn: gathered from its
    parent where they depend on it, constants elsewhere (the reference's
    parent_updates / const_updates).  Returns {field: tensor}."""
    from avida_tpu_torch.ops.interpreter import pack_tape
    cols = torch.arange(st.tape.shape[1], device=births.device)[None, :]
    same_site = (off_mem == st.genome) | (cols >= off_len[:, None])
    is_breed_true = (off_len == st.genome_len) & same_site.all(dim=1)
    parent_updates = _parent_fields(params, st, off_mem, off_len,
                                    child_merit, is_breed_true)
    if params.hw_type == 3:
        # experimental hardware: the offspring inherits the forage target
        # (cPhenotype::SetupOffspring)
        parent_updates["forage_target"] = st.forage_target
    if params.energy_enabled:
        # the child's share of the parent's energy lands with the birth;
        # merit follows the energy (ConvertEnergyToMerit)
        from avida_tpu_torch.ops.interpreter import (
            child_energy, convert_energy_to_merit)
        e = child_energy(params, st.energy)
        parent_updates["energy"] = e
        parent_updates["merit"] = convert_energy_to_merit(params, e)
    new = {name: _where_rows(births, by_parent(src), getattr(st, name))
           for name, src in parent_updates.items()}
    new["tape"] = _where_rows(births, pack_tape(new["genome"]), st.tape)
    _const_fields(params, new, st, births, fresh_inputs, update_no)
    if is_smt(params):
        # newborn SMT thread bases: host at space 0, parasite at space 2
        new["smt_head_space"] = _where_rows(
            births, smt_base_spaces(births.device)[None], st.smt_head_space)
    return new


def _parent_fields(params, st, mem, length, merit, breed_true):
    """{field: per-parent-row value} of a newborn whose parent is that
    row and whose genome is (mem, length)."""
    if params.death_method == 2:
        max_exec = params.age_limit * length
    elif params.death_method == 1:
        max_exec = torch.full_like(length, params.age_limit)
    else:
        max_exec = torch.full_like(length, 2**30)
    return {
        "mem_len": length, "genome": mem, "genome_len": length,
        "merit": merit, "last_task_count": st.last_task_count,
        "gestation_time": st.gestation_time, "fitness": st.fitness,
        "last_bonus": st.last_bonus, "last_merit_base": st.last_merit_base,
        "executed_size": st.executed_size,
        "copied_size": st.child_copied_size,
        "generation": st.generation + (
            0 if params.generation_inc_method == 1 else 1),
        "max_executed": max_exec, "breed_true": breed_true,
        "parent_id": torch.arange(length.shape[0], dtype=torch.int32,
                                  device=length.device),
    }


def _const_fields(params, new, st, mask, fresh_inputs, update_no):
    """Write the newborn constants and fresh inputs under `mask` into
    `new` (fields not yet in `new` start from `st`)."""
    consts = dict(_CONST_UPDATES, birth_update=int(update_no),
                  cur_bonus=float(params.default_bonus))
    for name, val in consts.items():
        new[name] = _where_rows(mask, val, new.get(name, getattr(st, name)))
    new["inputs"] = _where_rows(mask, fresh_inputs,
                                new.get("inputs", st.inputs))


def dual_births(params, st, new, births, won, placement, dual, dual_mem,
                dual_len, dual_merit, fresh_inputs, update_no):
    """The second child of the store-paired dual row: placed at another
    of its parent's candidate cells, avoiding every cell claimed this
    flush (at most one dual row exists).  Merged into `new` under the
    b2 mask with no host sync (the reference gates the same writes on
    a lax.cond).  Returns b2, the cells that receive it."""
    from avida_tpu_torch.ops.interpreter import pack_tape
    cand, u, choice, occupied = placement
    n, ncand = cand.shape
    dev = cand.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    claimed2 = births[cand.long()]
    slot = torch.arange(ncand, device=dev)[None, :]
    score2 = (u - torch.where(claimed2, 100.0, 0.0)
              - torch.where(slot == choice[:, None], 200.0, 0.0))
    if params.prefer_empty:
        score2 = score2 + torch.where(~occupied, 10.0, 0.0)
    choice2 = torch.argmax(score2, dim=1)
    target2 = cand[rows.long(), choice2].long()
    dual_born = dual & won & ~births[target2]
    b2 = torch.zeros(n, dtype=torch.bool, device=dev)
    p2 = torch.zeros(n, dtype=torch.int32, device=dev)
    b2[target2[dual_born]] = True
    p2[target2[dual_born]] = rows[dual_born]
    p2l = p2.long()
    parent2 = _parent_fields(params, st, dual_mem, dual_len, dual_merit,
                             torch.zeros(n, dtype=torch.bool, device=dev))
    for name, src in parent2.items():
        new[name] = _where_rows(b2, src[p2l], new[name])
    new["tape"] = _where_rows(b2, pack_tape(new["genome"]), new["tape"])
    _const_fields(params, new, st, b2, fresh_inputs, update_no)
    return b2


def ring_append(st, new, births, parent_idx, update_no):
    """Append this flush's newborns to the ring (nb_*) in `new`; rows
    past the capacity are dropped but still counted, so the host sees
    the overflow."""
    cap = st.nb_genome.shape[0]
    if cap == 0:
        return
    n = births.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=births.device)
    rank = torch.cumsum(births.to(torch.int32), 0) - 1
    slot = st.nb_count + rank
    ok = births & (slot < cap)
    idx = slot[ok].long()

    def put(ring, vals):
        ring = ring.clone()
        ring[idx] = vals[ok].to(ring.dtype)
        return ring

    new.update(
        nb_genome=put(st.nb_genome, new["genome"]),
        nb_len=put(st.nb_len, new["genome_len"]),
        nb_cell=put(st.nb_cell, rows),
        nb_parent=put(st.nb_parent, parent_idx),
        nb_update=put(st.nb_update, torch.full_like(rows, update_no)),
        nb_count=(st.nb_count + births.sum()).to(torch.int32))


def flush_births(params, st, key, update_no, neighbors=None):
    """Place pending offspring on a canonical PopulationState (the
    reference's flush_births with use_off_tape=True): divide mutations,
    the birth chamber when the set has divide-sex, placement (the torus
    fast path's rolls, or the neighbor table's scatter-min), the newborn
    fields, the dual second birth, the append to the newborn ring that
    host systematics drains, the winning parents' energy and the
    population caps.  `neighbors` is the world's table (neighbors_on's
    default-seed table when None).  Same PRNG splits and draw shapes as
    the reference.  What it does not port raises by name."""
    reason = canonical_unsupported_reason(params)
    if reason is not None:
        raise NotImplementedError(
            f"birth flush: {reason} is not ported to avida_tpu_torch")
    from avida_tpu_torch.ops import interpreter
    n = st.tape.shape[0]
    dev = st.tape.device
    if neighbors is None:
        neighbors = neighbors_on(params, dev)
    ks = prng.split(key, 4)
    k_place, k_inputs, k_off, k_sex = ks[0], ks[1], ks[2], ks[3]
    pending = st.divide_pending & st.alive

    off_mem, off_len = interpreter.extract_offspring(params, st, k_off)
    fresh_inputs = make_cell_inputs(k_inputs, n)

    sexual = has_divide_sex(params)
    child_merit = st.merit
    if sexual:
        (off_mem, off_len, child_merit, pending, dual, dual_mem, dual_len,
         dual_merit, store) = recombine_sexual(params, st, k_sex, off_mem,
                                               off_len, pending)
        leftover = (st.divide_pending & st.alive) & ~pending

    if local_torus_fast_path(params, sexual):
        pending, births, parent_idx, won, dir_idx = fast_torus_placement(
            params, k_place, pending, st.alive, st.time_used, st.merit)
        wx, wy = params.world_x, params.world_y
        offs_all = _OFFS_2D + (((0, 0),) if params.allow_parent else ())

        def by_parent(x):
            out = torch.zeros_like(x)
            for k, (dy, dx) in enumerate(offs_all):
                out = _where_rows(dir_idx == k, _roll2d(x, dy, dx, wx, wy),
                                  out)
            return out
    else:
        facing = st.facing if params.hw_type == 3 else None
        pending_in = pending
        (pending, births, parent_idx, won, *placement) = general_placement(
            params, k_place, pending, st.alive, st.time_used, st.merit,
            neighbors, st.energy_spent if params.energy_enabled else None,
            facing)
        pl = parent_idx.long()

        def by_parent(x):
            return x[pl]

    new = newborn_fields(params, st, births, by_parent, off_mem, off_len,
                         child_merit, fresh_inputs, update_no)
    if params.hw_type == 3:
        # newborns face a random ring direction (cPopulationCell's random
        # rotation at activation)
        new["facing"] = torch.where(births, prng.randint(
            prng.fold_in(key, 0xFACE), (n,), 0, 8), st.facing)
    if sexual:
        b2 = dual_births(params, st, new, births, won, placement, dual,
                         dual_mem, dual_len, dual_merit, fresh_inputs,
                         update_no)
        births = births | b2
    ring_append(st, new, births, parent_idx, update_no)
    if params.num_demes > 1:
        # the per-deme birth tally (cDeme::IncBirthCount)
        new["deme_birth_count"] = st.deme_birth_count + births.reshape(
            params.num_demes, -1).sum(dim=1).to(torch.int32)
    st = st.replace(**new)
    resumes = won | ~st.alive
    if params.hw_type == 3 and params.birth_method == 7:
        # a parent facing off a bounded grid drops its offspring and
        # resumes: the birth can never land, and a waiting parent runs no
        # rotate-x (the reference's fix of the livelock, ADVICE.md)
        resumes = resumes | (pending_in & ~pending)
    if sexual:
        # transactional store: when the dual row's store child found no
        # cell, the waiting entry is not consumed -- unless a new
        # leftover already took the single slot
        bc_mem, bc_len, bc_merit, bc_valid, bc_type = store
        restore = dual.any() & ~b2.any() & ~bc_valid
        st = st.replace(
            bc_mem=torch.where(restore, st.bc_mem, bc_mem),
            bc_len=torch.where(restore, st.bc_len, bc_len),
            bc_merit=torch.where(restore, st.bc_merit, bc_merit),
            bc_valid=bc_valid | restore, bc_type=bc_type)
        resumes = resumes | leftover
    # winners, dead parents and parents whose offspring went into the
    # store (or were dropped) resume; living losers retry next update
    cleared = torch.where(resumes, False, st.divide_pending)
    st = st.replace(divide_pending=cleared, off_sex=st.off_sex & cleared)
    if params.energy_enabled:
        # the winning parent keeps (1 - decay)(1 - frac) of its energy and
        # its merit follows (cPhenotype::DivideReset energy branch)
        energy = torch.where(won, interpreter.parent_energy_after(
            params, st.energy), st.energy)
        st = st.replace(energy=energy, merit=torch.where(
            won, interpreter.convert_energy_to_merit(params, energy),
            st.merit))
    if params.population_cap > 0 or params.pop_cap_eldest > 0:
        st = st.replace(alive=cap_population(params, st, births,
                                             prng.fold_in(key, 0xCAB)))
    if is_smt(params):
        # a winning SMT parent's offspring buffer resets to the
        # one-instruction blank (Divide_Main tail, cHardwareTransSMT.cc:485)
        st = st.replace(
            smt_aux=_set_thread(st.smt_aux, 0, won, 0),
            smt_aux_len=_set_thread(st.smt_aux_len, 0, won, 1))
        st = flush_injections(params, st, prng.fold_in(key, 17), neighbors)
    return st


def cap_population(params, st, births, k_cap):
    """Carrying capacity (cPopulation::PositionOffspring pop-cap kills,
    cc:5192-5238): past the cap the excess dies -- random victims under
    POPULATION_CAP, the eldest (most time used, random tiebreak) under
    POP_CAP_ELDEST -- sparing this flush's newborns.  Returns the new
    alive mask."""
    n = births.shape[0]
    cap = params.population_cap or params.pop_cap_eldest
    eligible = st.alive & ~births
    excess = torch.minimum((st.alive.sum() - cap).clamp(min=0),
                           eligible.sum())
    u = prng.uniform(k_cap, (n,))
    if params.pop_cap_eldest > 0:
        u = st.time_used.to(torch.float32) + u
    score = torch.where(eligible, u, -1.0)
    order = torch.argsort(-score, stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=births.device)
    rank[order] = torch.arange(n, device=births.device)
    return st.alive & ~(rank < excess)


def _set_thread(field, j, mask, val):
    """field [N, 2, ...] with thread j's row set to val where mask."""
    rows = [field[:, 0], field[:, 1]]
    rows[j] = _where_rows(mask, val, rows[j])
    return torch.stack(rows, dim=1)


def flush_injections(params, st, key, neighbors=None):
    """Parasite transmission (ParasiteInfectHost,
    cHardwareTransSMT.cc:375-417): each living organism with a staged
    injection targets a random neighbor; the infection takes when the
    target is alive and holds no parasite.  Several injectors on one
    target: the lowest injector wins (a scatter-min).  Every staged
    injection is consumed, whether it took or not, so a failed one loses
    its parasite.  The new parasite thread starts at (space 2, position
    0) with empty stacks."""
    n = st.alive.shape[0]
    dev = st.alive.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    if neighbors is None:
        neighbors = neighbors_on(params, dev)
    pend = st.inject_pending & st.alive
    choice = prng.randint(key, (n,), 0, neighbors.shape[1])
    target = neighbors[rows.long(), choice.long()].long()
    # a padding slot (-1) indexes the last cell, as the reference's
    # negative index does
    target = torch.where(target < 0, target + n, target)
    ok = pend & st.alive[target] & ~st.parasite_active[target]
    big = 2**30
    claim = torch.full((n,), big, dtype=torch.int32, device=dev)
    claim = claim.scatter_reduce(
        0, torch.where(ok, target, rows.long()),
        torch.where(ok, rows, big), reduce="amin")
    infected = (claim < big) & st.alive & ~st.parasite_active
    src = claim.clamp(0, n - 1).long()
    return st.replace(
        pmem=_where_rows(infected, st.inj_mem[src], st.pmem),
        pmem_len=torch.where(infected, st.inj_len[src], st.pmem_len),
        parasite_active=st.parasite_active | infected,
        smt_head_pos=_set_thread(st.smt_head_pos, 1, infected, 0),
        smt_head_space=_set_thread(st.smt_head_space, 1, infected, 2),
        smt_stacks=_set_thread(st.smt_stacks, 1, infected, 0),
        smt_sp=_set_thread(st.smt_sp, 1, infected, 0),
        inject_pending=st.inject_pending & ~pend)


def birth_death_masks(alive_before, st, update_no):
    """Per-cell (born, died) masks: born = alive newborns placed this
    update; died = cells alive at the update's start that are now empty
    or hold this update's newborn."""
    born = st.alive & (st.birth_update == update_no)
    died = alive_before & (~st.alive | born)
    return born, died
