"""Sandboxed genotype evaluation: the batched Test CPU.

Counterpart of avida_tpu/analyze/testcpu.py (cTestCPU, avida-core
source/cpu/cTestCPU.cc: TestGenome :190, ProcessGestation :144).  The
whole genotype batch is one lockstep population: each genome gets a lane,
micro-steps (ops/interpreter.micro_step) run until every lane divided or
used TEST_CPU_TIME_MOD x its length in cycles, and the generation
recursion -- at most TEST_CPU_GENERATIONS batched runs, each next one
re-running the offspring of lanes that did not breed true -- is numpy on
the host, as the reference's is.

Draw for draw the reference's: cycle t of generation `gen` is keyed
fold_in(fold_in(key(seed), gen), t), the offspring extraction
fold_in(., 0x7FFFFFFF), and lane i's inputs come from
fold_in(split(.)[0], i).  The batch is padded to a power of two, as the
reference pads it: the width sets every per-cycle draw inside
micro_step, so the padding is part of the result.

The cycles run in blocks of STOP_EVERY, and the stop test (every lane
divided or out of budget) is read on the host once a block, not every
cycle: the cycles of a block past the stop run under an all-false mask,
which micro_step leaves as the identity (tests/test_torch_testcpu.py
holds it), so the result is the reference's, whose loop stops at the
stop or at the largest budget.  On a CUDA device a block is one captured
CUDA graph, replayed (_GraphBlocks); on the CPU it runs as it is.

This is the oracle behind analyze-mode RECALCULATE, LANDSCAPE and
ANALYZE_KNOCKOUTS, the checkpoint analytics (analyze/pipeline.py) and the
in-run reversion test (World._apply_reversion).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from avida_tpu_torch.core.state import clone_state, zeros_population
from avida_tpu_torch.ops import interpreter
from avida_tpu_torch.ops.update import materialize_offspring
from avida_tpu_torch.utils import prng

TEST_CPU_GENERATIONS = 3   # ref nHardware::TEST_CPU_GENERATIONS

# cycles run between two host reads of the stop test (their draws are
# made together)
STOP_EVERY = 16


def _bucket(n: int) -> int:
    """Power-of-two batch width (the reference's; dead padded lanes have
    lens == 0, so they are never alive)."""
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclass
class TestResult:
    """Per-genotype metrics (ref cCPUTestInfo accessors)."""
    __test__ = False            # not a pytest class
    viable: np.ndarray          # bool[G]  divided with a self-replicating line
    gestation_time: np.ndarray  # int32[G] cycles to (final-generation) divide
    merit: np.ndarray           # f32[G]
    fitness: np.ndarray         # f64[G]   merit / gestation
    task_counts: np.ndarray     # int32[G, R] tasks at divide
    copied_size: np.ndarray     # int32[G]
    executed_size: np.ndarray   # int32[G]
    offspring_genome: np.ndarray  # int8[G, L]
    offspring_len: np.ndarray   # int32[G]
    generations: np.ndarray     # int32[G] generations to reach a fixed point


def _sandbox_inputs(key, g):
    """Lane i's three IO inputs from fold_in(key, i) -- the reference's
    vmap of make_cell_inputs(fold_in(key, i), 1)[0] -- so a lane's inputs
    do not depend on the batch width.  -> int32[g, 3]."""
    lanes = torch.arange(g, device=key.device)
    ks = prng.fold_in_rows(key[None], lanes)[0]           # [g, 2]
    k12 = prng.split_rows(ks)                              # [g, 2, 2]
    low = prng.randint_from_bits(prng.bits_rows(k12[:, 0], 3),
                                 prng.bits_rows(k12[:, 1], 3), 0, 1 << 24)
    tops = torch.tensor([15 << 24, 51 << 24, 85 << 24], dtype=torch.int32,
                        device=key.device)
    return tops[None, :] + low


def _sandbox_state(params, genomes, lens, key):
    """A fresh population of one lane per genome (int8[G, L] on the
    device, lens int32[G]), as the reference's _sandbox_state builds it:
    no aging, initial pools, merit = length."""
    g = genomes.shape[0]
    dev = genomes.device
    f32 = dict(dtype=torch.float32, device=dev)
    st = zeros_population(g, params.max_memory, params.num_reactions,
                          params.num_global_res, params.num_spatial_res,
                          n_deme_res=params.num_deme_res, device=dev)
    k_in = prng.split(key)[0]
    return st.replace(
        inputs=_sandbox_inputs(k_in, g),
        deme_resources=torch.tensor(list(params.dres_initial), **f32
                                    ).reshape(1, params.num_deme_res),
        tape=genomes.to(torch.uint8),
        genome=genomes.to(torch.int8),
        mem_len=lens, genome_len=lens,
        alive=lens > 0,
        merit=lens.to(torch.float32),
        cur_bonus=torch.full((g,), prng.round_f32(params.default_bonus),
                             **f32),
        executed_size=lens, copied_size=lens,
        max_executed=torch.full((g,), 2**30, dtype=torch.int32, device=dev),
        resources=torch.tensor(list(params.res_initial), **f32
                               ).reshape(params.num_global_res),
        res_grid=torch.tensor(list(params.sres_initial), **f32
                              ).reshape(params.num_spatial_res, 1
                                        ).expand(-1, g).contiguous())


def _block(params, st, ck, bits, t0, budget):
    """STOP_EVERY cycles from cycle t0 (an int64 scalar tensor): cycle
    t0 + j runs micro_step keyed ck[j] on the lanes alive, not waiting on
    a divide and inside their budget.  A cycle at or past every budget
    runs under an all-false mask, the identity."""
    for j in range(STOP_EVERY):
        mask = st.alive & ~st.divide_pending & (t0 + j < budget)
        st = interpreter.micro_step(params, st, ck[j], mask, bits[:, j])
    return st


class _GraphBlocks:
    """_block on a CUDA device as one captured CUDA graph, replayed once a
    block: the same operations on the same tensors, issued without the
    host (a micro-step is about a thousand small kernels).  Its inputs
    are static tensors -- the state, the block's cycle keys and bits, t0
    and the budget -- copied in before each replay; the output state is
    the graph's own memory, valid until the next replay.  Captured at
    the first block and kept for every generation of one
    evaluate_genomes call (one batch width)."""

    def __init__(self):
        self.graph = None

    def _capture(self, params, st, ck, bits, t0, budget):
        from avida_tpu_torch.ops import tasks
        self.inp = clone_state(st)
        self.ck, self.bits = ck.clone(), bits.clone()
        self.t0, self.budget = t0.clone(), budget.clone()
        args = (params, self.inp, self.ck, self.bits, self.t0, self.budget)
        side = torch.cuda.Stream(device=ck.device)
        side.wait_stream(torch.cuda.current_stream(ck.device))
        with torch.cuda.stream(side):
            _block(*args)           # warm-up: builds the cached tables
        torch.cuda.current_stream(ck.device).wait_stream(side)
        # the tables the graph reads stay alive with it
        self.tables = (interpreter._tables(params, ck.device),
                       tasks.env_tables_to_device(params, ck.device))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _block(*args)

    def __call__(self, params, st, ck, bits, t0, budget):
        if self.graph is None:
            self._capture(params, st, ck, bits, t0, budget)
        for f, v in vars(st).items():
            if v is not None and v is not getattr(self.inp, f):
                getattr(self.inp, f).copy_(v)
        for dst, src in ((self.ck, ck), (self.bits, bits), (self.t0, t0),
                         (self.budget, budget)):
            dst.copy_(src)
        self.graph.replay()
        return self.out


def _run_gestation(params, genomes, lens, time_mod, key, stats=None,
                   blocks=_block):
    """Run every lane until divide or time_mod * len cycles (one
    generation; cTestCPU::ProcessGestation), a block of STOP_EVERY cycles
    at a time through `blocks` (_block, or a _GraphBlocks on a CUDA
    device).  Returns (state after, divided[G], gestation[G],
    offspring[G, L], off_len[G])."""
    st = _sandbox_state(params, genomes, lens, key)
    budget = time_mod * lens.clamp(min=1)
    max_t = int(budget.max())
    n = genomes.shape[0]
    t = 0
    while t < max_t:
        active = st.alive & ~st.divide_pending & (t < budget)
        if not bool(active.any()):
            break
        ck = prng.fold_in_rows(key[None], torch.arange(
            t, t + STOP_EVERY, device=key.device))[0]   # [STOP_EVERY, 2]
        bits = interpreter.cycle_bits(interpreter.draw_keys, params,
                                      ck[:, None], n)     # [D, STOP_EVERY, n]
        t0 = torch.tensor(t, dtype=torch.int64, device=key.device)
        st = blocks(params, st, ck, bits, t0, budget)
        t += STOP_EVERY
    if stats is not None:
        stats["cycles"] = stats.get("cycles", 0) + t
    if params.hw_type == 0:
        # the offspring read off the tape from its split point (the
        # reference's extract_offspring with use_off_tape=False)
        st = materialize_offspring(params, st,
                                   torch.zeros_like(st.divide_pending))
    off, off_len = interpreter.extract_offspring(
        params, st, prng.fold_in(key, 0x7FFFFFFF))
    return st, st.divide_pending, st.gestation_time, off, off_len


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def evaluate_genomes(params, genomes, lens=None, seed: int = 0,
                     time_mod: int = 20, device=None,
                     stats: dict | None = None) -> TestResult:
    """Evaluate a batch of genotypes in the sandbox (host-facing API).

    genomes: int array [G, L] (anything past lens is ignored).
    time_mod: TEST_CPU_TIME_MOD (cAvidaConfig; default 20, which every
    world-side caller uses, as in the reference).  Runs on `device` (the
    GPU unless the caller names another).  `stats`, when given, gets the
    cycles run ("cycles") and the padded width ("width")."""
    from avida_tpu_torch.world import resolve_device
    dev = resolve_device(device)
    genomes = np.asarray(genomes)
    G, L = genomes.shape
    if L != params.max_memory:
        raise ValueError(f"genome buffer width {L} != params.max_memory "
                         f"{params.max_memory}")
    # the sandbox evaluates the genotype itself: every mutation off
    params = params.replace(copy_mut_prob=0.0, divide_mut_prob=0.0,
                            divide_ins_prob=0.0, divide_del_prob=0.0,
                            point_mut_prob=0.0)
    if lens is None:
        lens = (genomes != 0).cumsum(axis=1).argmax(axis=1) + 1
    lens = np.asarray(lens, np.int32)
    G0 = G
    Gp = _bucket(G)
    if Gp != G:
        genomes = np.concatenate(
            [genomes, np.zeros((Gp - G, L), genomes.dtype)])
        lens = np.concatenate([lens, np.zeros(Gp - G, np.int32)])
        G = Gp
    if stats is not None:
        stats["width"] = G
    key = prng.key(seed, dev)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cur_g, cur_len = put(genomes.astype(np.int8)), put(lens)
    blocks = _GraphBlocks() if dev.type == "cuda" else _block
    done = np.zeros(G, bool)
    generations = np.zeros(G, np.int32)
    out = {}
    for gen in range(TEST_CPU_GENERATIONS):
        st, divided, gest, off, off_len = _run_gestation(
            params, cur_g, cur_len, time_mod, prng.fold_in(key, gen), stats,
            blocks)
        divided_np = _host(divided)
        if gen == 0:
            out = {
                "divided": divided_np.copy(),
                "gestation": _host(gest).copy(),
                "merit": _host(st.merit).copy(),
                "fitness": _host(st.fitness).copy(),
                "tasks": _host(st.last_task_count).copy(),
                "copied": _host(st.child_copied_size).copy(),
                "executed": _host(st.executed_size).copy(),
                "off": _host(off).copy(),
                "off_len": _host(off_len).copy(),
            }
        else:
            redo = ~done
            for name, val in (("divided", divided), ("gestation", gest),
                              ("merit", st.merit), ("fitness", st.fitness),
                              ("tasks", st.last_task_count),
                              ("copied", st.child_copied_size),
                              ("executed", st.executed_size),
                              ("off", off), ("off_len", off_len)):
                out[name][redo] = _host(val)[redo]
            generations[redo] += 1
        # a lane is settled when it failed to divide or bred true
        # (offspring == input genome): ref cTestCPU generation recursion
        off_np = _host(off)
        off_len_np = _host(off_len)
        cur_np = _host(cur_g)
        len_np = _host(cur_len)
        same = (off_len_np == len_np)
        L_idx = np.arange(L)
        valid = L_idx[None, :] < np.minimum(off_len_np, len_np)[:, None]
        same &= ~np.any((off_np != cur_np) & valid, axis=1)
        done |= (~divided_np) | same
        if done.all():
            break
        # next generation: run the (new) offspring of unsettled lanes
        nxt = np.where(done[:, None], cur_np, off_np)
        nxt_len = np.where(done, len_np, off_len_np)
        cur_g, cur_len = put(nxt), put(nxt_len)

    gest = out["gestation"][:G0]
    merit = out["merit"][:G0]
    return TestResult(
        viable=out["divided"][:G0] & (gest > 0),
        gestation_time=gest,
        merit=merit,
        fitness=np.where(gest > 0, merit / np.maximum(gest, 1), 0.0),
        task_counts=out["tasks"][:G0],
        copied_size=out["copied"][:G0],
        executed_size=out["executed"][:G0],
        offspring_genome=out["off"][:G0],
        offspring_len=out["off_len"][:G0],
        generations=generations[:G0],
    )
