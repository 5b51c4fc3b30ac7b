"""Structured-population (.spop) save/load.

Counterpart of avida_tpu/utils/spop.py: the reference's genotype-grouped
20-column format (cPopulation::SavePopulation,
avida-core/source/main/cPopulation.cc:6294), written byte for byte as
the JAX package writes it, and the reload (cPopulation::LoadPopulation
cc:6723), which injects the genomes and fast-forwards each organism
`gest_offset` cycles with masked micro-steps (ops/interpreter.micro_step,
cycle s keyed fold_in(key, s)).

FIDELITY LIMITS (the format's): a round-trip keeps the alive mask, the
genome and its length per organism; merit / gestation time / fitness
only as the per-genotype mean; generation from the group's first listed
cell.  CPU state is rebuilt by the fast-forward, not restored; PRNG
keys, resource pools, systematics ancestry and per-update accounting
are not in the format at all.  Bit-exact persistence is the native
checkpoint format (utils/checkpoint.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from avida_tpu_torch.utils import prng


# Reference sequence encoding (cInstruction::GetSymbol, cInstruction.cc:33):
# opcodes 0-25 map to 'a'-'z', 26-51 to 'A'-'Z'.  Larger instruction sets
# have no symbol alphabet in the .spop format -- refuse rather than emit
# unparseable punctuation (the pre-fix code silently wrote chr(ord('a')+op)
# garbage past 'z').
_SEQ_ALPHABET = ("abcdefghijklmnopqrstuvwxyz"
                 "ABCDEFGHIJKLMNOPQRSTUVWXYZ")
_SEQ_DECODE = {c: i for i, c in enumerate(_SEQ_ALPHABET)}


def _seq_to_string(ops: np.ndarray) -> str:
    out = []
    for o in ops:
        o = int(o)
        if not 0 <= o < len(_SEQ_ALPHABET):
            raise ValueError(
                f"opcode {o} has no .spop symbol (the a-zA-Z encoding "
                f"covers 52 instructions); use the native checkpoint "
                f"format (utils/checkpoint.py) for larger instruction sets")
        out.append(_SEQ_ALPHABET[o])
    return "".join(out)


def _string_to_seq(s: str) -> np.ndarray:
    try:
        return np.asarray([_SEQ_DECODE[c] for c in s], np.int8)
    except KeyError as e:
        raise ValueError(
            f"invalid .spop sequence symbol {e.args[0]!r} (expected a-zA-Z)")


def save_population(path: str, params, st, update: int,
                    instset_name: str = "heads_default"):
    """Write the genotype-grouped .spop file of a state (the reference's
    save_population, byte for byte apart from the date line)."""
    def host(name):
        return getattr(st, name).detach().cpu().numpy()

    alive = host("alive")
    mem_len = host("genome_len")
    genomes = host("genome")
    merit = host("merit")
    gest = host("gestation_time")
    fit = host("fitness")
    gen = host("generation")
    born = host("birth_update")
    offset = host("time_used") - host("gestation_start")

    cells = np.nonzero(alive)[0]
    groups = {}
    for c in cells:
        key = genomes[c, :mem_len[c]].tobytes()
        groups.setdefault(key, []).append(int(c))

    with open(path, "w") as f:
        f.write("#filetype genotype_data\n")
        f.write("#format id src src_args parents num_units total_units length "
                "merit gest_time fitness gen_born update_born "
                "update_deactivated depth hw_type inst_set sequence cells "
                "gest_offset lineage \n")
        f.write("# Structured Population Save\n")
        f.write(f"# {time.asctime()}\n\n")
        for gid, (key, cs) in enumerate(sorted(groups.items(),
                                               key=lambda kv: -len(kv[1])), 1):
            seq = np.frombuffer(key, np.int8)
            c0 = cs[0]
            f.write(" ".join(map(str, [
                gid, "div:int", "(none)", "(none)", len(cs), len(cs),
                len(seq), f"{merit[cs].mean():g}", f"{gest[cs].mean():g}",
                f"{fit[cs].mean():g}", int(gen[c0]), int(born[c0]), -1, 0, 0,
                instset_name, _seq_to_string(seq),
                ",".join(str(c) for c in cs),
                ",".join(str(int(offset[c])) for c in cs),
                0])) + " \n")


def load_population(path: str, params=None, key=None):
    """Parse a .spop file; returns a list of dicts (one per organism):
    {cell, genome, merit, gest_offset, generation}."""
    orgs = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            t = line.split()
            if len(t) < 19:
                continue
            length = int(t[6])
            merit = float(t[7])
            gen_born = int(t[10])
            seq = _string_to_seq(t[16])
            assert len(seq) == length, f"sequence length mismatch in {path}"
            cells = [int(c) for c in t[17].split(",")]
            offsets = [int(o) for o in t[18].split(",")]
            parents = t[3]
            for c, off in zip(cells, offsets):
                orgs.append({"cell": c, "genome": seq, "merit": merit,
                             "gest_offset": off, "generation": gen_born,
                             "id": int(t[0]),
                             "depth": int(t[13]),
                             "parent": int(parents.split(",")[0])
                             if parents not in ("(none)", "") else -1})
    return orgs


def restore_population(params, orgs, key):
    """A PopulationState (on key's device) from load_population output,
    each organism fast-forwarded to its gestation offset with masked
    micro-steps."""
    from avida_tpu_torch.core.state import (is_smt, make_cell_inputs,
                                            zeros_population)
    from avida_tpu_torch.ops.interpreter import micro_step

    n, L, R = params.num_cells, params.max_memory, params.num_reactions
    dev = key.device
    st = zeros_population(n, L, R, params.num_global_res,
                          params.num_spatial_res, params.num_demes,
                          smt=is_smt(params),
                          num_registers=params.num_registers,
                          nb_cap=params.nb_cap,
                          n_deme_res=params.num_deme_res,
                          max_threads=params.max_cpu_threads, device=dev)
    ks = prng.split(key)
    k_in, key = ks[0], ks[1]
    f32 = dict(dtype=torch.float32, device=dev)
    st = st.replace(
        inputs=make_cell_inputs(k_in, n),
        deme_resources=torch.tensor(params.dres_initial, **f32)[None, :]
        .expand(params.num_demes, params.num_deme_res).clone(),
        resources=torch.tensor(params.res_initial, **f32),
        res_grid=torch.tensor(params.sres_initial, **f32)[:, None]
        .expand(params.num_spatial_res, n).clone())

    mem = np.zeros((n, L), np.int8)
    mem_len = np.zeros(n, np.int32)
    merit = np.zeros(n, np.float32)
    alive = np.zeros(n, bool)
    gen = np.zeros(n, np.int32)
    offs = np.zeros(n, np.int32)
    for o in orgs:
        c = o["cell"]
        g = o["genome"]
        mem[c, :len(g)] = g
        mem_len[c] = len(g)
        merit[c] = o["merit"]
        alive[c] = True
        gen[c] = o["generation"]
        offs[c] = o["gest_offset"]

    if params.death_method == 2:
        max_exec = params.age_limit * mem_len
    else:
        max_exec = params.age_limit if params.death_method == 1 else 2**30

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    alive_t = dev_t(alive)
    st = st.replace(
        tape=dev_t(mem.view(np.uint8)), mem_len=dev_t(mem_len),
        genome=dev_t(mem), genome_len=dev_t(mem_len),
        merit=dev_t(merit), alive=alive_t, generation=dev_t(gen),
        cur_bonus=torch.where(alive_t, torch.tensor(params.default_bonus,
                                                    **f32),
                              torch.tensor(0.0, **f32)),
        executed_size=dev_t(mem_len), copied_size=dev_t(mem_len),
        max_executed=dev_t(np.where(alive, max_exec, 0).astype(np.int32)),
    )

    if params.demes_use_germline and len(orgs):
        # no germline section in .spop: each deme's germline is re-seeded
        # from its lowest-index live organism, else the first one
        D = params.num_demes
        germ = np.zeros((D, L), np.int8)
        glen = np.zeros(D, np.int32)
        cpd = n // D
        first = orgs[0]
        for d in range(D):
            in_deme = [o for o in orgs if o["cell"] // cpd == d]
            src = min(in_deme, key=lambda o: o["cell"]) if in_deme else first
            g = src["genome"]
            germ[d, :len(g)] = g
            glen[d] = len(g)
        st = st.replace(germ_mem=dev_t(germ), germ_len=dev_t(glen))

    # fast-forward: organism i executes offs[i] cycles
    offs_t = dev_t(offs)
    max_off = int(offs.max()) if len(orgs) else 0
    for s in range(max_off):
        mask = st.alive & (s < offs_t)
        st = micro_step(params, st, prng.fold_in(key, s), mask)
    return st
