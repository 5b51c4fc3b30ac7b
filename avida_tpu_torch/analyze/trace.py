"""Per-cycle hardware tracing.

Counterpart of avida_tpu/analyze/trace.py (cHardwareTracer,
avida-core source/cpu/cHardwareTracer.h:34; cHardwareStatusPrinter,
cpu/cHardwareStatusPrinter.cc, for the analyze TRACE command).  The
genome runs alone in the sandbox one micro-step at a time, and the
architectural state is snapshotted after every cycle: `collect_trace`
returns the snapshots (the opcode fetched before the cycle, then the
heads, registers, top of stack, memory length and divide flag after it),
`trace_genome` writes the cHardwareStatusPrinter-style text file.
"""

from __future__ import annotations

import numpy as np
import torch

from avida_tpu_torch.analyze.testcpu import _sandbox_state
from avida_tpu_torch.ops.interpreter import fetch_opcode, micro_step
from avida_tpu_torch.utils import prng


def collect_trace(params, genome, max_cycles: int = 2000, seed: int = 0,
                  device=None):
    """Run one genome in the sandbox on `device` (the GPU unless named),
    snapshotting its state every cycle.  Returns (snapshots, final
    state); cycle t is keyed fold_in(key(seed), t), as in the
    reference."""
    from avida_tpu_torch.world import resolve_device
    dev = resolve_device(device)
    genome = np.asarray(genome, np.int8)
    L = params.max_memory
    buf = np.zeros((1, L), np.int8)
    n = min(len(genome), L)
    buf[:, :n] = genome[:n]
    params = params.replace(copy_mut_prob=0.0, divide_mut_prob=0.0,
                            divide_ins_prob=0.0, divide_del_prob=0.0)
    key = prng.key(seed, dev)
    st = _sandbox_state(params, torch.from_numpy(buf).to(dev),
                        torch.tensor([n], dtype=torch.int32, device=dev), key)
    snaps = []
    for t in range(max_cycles):
        op = int(fetch_opcode(params, st)[0])
        st = micro_step(params, st, prng.fold_in(key, t),
                        st.alive & ~st.divide_pending)
        heads = st.heads[0].tolist()
        stk = int(st.active_stack[0])
        snaps.append({
            "cycle": t + 1,
            "op": op,
            "ip": heads[0],
            "read": heads[1],
            "write": heads[2],
            "flow": heads[3],
            "regs": st.regs[0].tolist(),
            "stack_top": int(st.stacks[0, stk, int(st.sp[0, stk])]),
            "mem_len": int(st.mem_len[0]),
            "divided": bool(st.divide_pending[0]),
        })
        if snaps[-1]["divided"]:
            break
    return snaps, st


def trace_genome(params, instset, genome, path: str,
                 max_cycles: int = 2000, seed: int = 0, device=None):
    """Write a cHardwareStatusPrinter-style text trace to `path`."""
    genome = np.asarray(genome, np.int8)
    snaps, st = collect_trace(params, genome, max_cycles, seed, device)
    names = instset.inst_names
    with open(path, "w") as f:
        f.write(f"# Trace of genome (length {len(genome)})\n")
        f.write("# " + " ".join(names[int(o)] for o in genome) + "\n\n")
        for s in snaps:
            f.write(
                f"{names[s['op']]:12s} "
                f"U:{s['cycle']} IP:{s['ip']} AX:{s['regs'][0]} "
                f"BX:{s['regs'][1]} CX:{s['regs'][2]} "
                f"R-Head:{s['read']} W-Head:{s['write']} F-Head:{s['flow']} "
                f"Mem:{s['mem_len']} Stack:{s['stack_top']}"
                + ("  DIVIDE" if s["divided"] else "") + "\n")
        f.write(f"\n# {len(snaps)} cycles"
                + (" (divided)" if snaps and snaps[-1]["divided"] else "")
                + "\n")
    return snaps
