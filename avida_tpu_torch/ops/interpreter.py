"""Interpreter helpers shared outside the cycle kernel.

Counterpart of avida_tpu/ops/interpreter.py: `random_inst`, `pack_tape`
and the canonical `extract_offspring` (the deferred half of h-divide plus
the divide mutations) of heads hardware.  The XLA lockstep micro-step is
not part of this package: the cycle kernel (ops/cycles.py) runs every
cycle and leaves each fresh offspring in `off_tape`.
"""

from __future__ import annotations

import torch

from avida_tpu_torch.utils import prng

OP_MASK = 0x3F                 # bits 0-5 of a tape byte: the opcode


def random_inst(params, key, shape):
    """Redundancy-weighted random instruction draw (cInstSet::GetRandomInst,
    cpu/cInstSet.h:52): inverse-CDF over the per-opcode mutation weights;
    uniform sets short-circuit to randint."""
    cdf = params.mut_cdf
    n_i = params.num_insts
    if not cdf or all(abs(cdf[k] - (k + 1) / n_i) < 1e-12
                      for k in range(n_i)):
        return prng.randint(key, shape, 0, n_i)
    u = prng.uniform(key, shape)
    op = torch.zeros(tuple(shape), dtype=torch.int32, device=key.device)
    for k in range(n_i - 1):
        op = op + (u >= torch.tensor(cdf[k], dtype=torch.float32)
                   ).to(torch.int32)
    return op


def pack_tape(ops):
    """Opcode array (int8) -> packed tape (uint8, flags clear)."""
    return ops.to(torch.uint8) & OP_MASK


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
    kernel has already written every fresh offspring to st.off_tape.
    Returns (off int8[N, L], off_len int32[N])."""
    n, L = st.tape.shape
    dev = st.tape.device
    cols = torch.arange(L, device=dev)[None, :]
    off_len = st.off_len
    off = torch.where(cols < off_len[:, None], st.off_tape.to(torch.int8),
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
