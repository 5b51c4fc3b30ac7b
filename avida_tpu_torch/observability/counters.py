"""Device-side telemetry counters.

Counterpart of avida_tpu/observability/counters.py.  Everything here is
a small reduction over state the engine already tracks (insts_executed,
birth_update, task_exe_total, the granted budget vector).  The one
exception is the instruction-dispatch mix, an int32[num_insts]
accumulator the micro-step engine adds to each cycle
(ops/update.xla_cycles' `counters`: the opcode under every scheduled
lane's IP).  The cycle kernel does not collect it.

The budget-tail counters: each kernel block runs to the largest grant of
ITS lanes, so

    utilization = granted.sum() / sum_b(block_size * max_b(granted))

is the fraction of lockstep lane-cycles doing useful work.  On the
micro-step engine the whole population is one block.
"""

from __future__ import annotations

import torch

from avida_tpu_torch.utils import prng


def dispatch_init(params, device=None):
    """Zeroed dispatch-mix accumulator for xla_cycles' `counters`."""
    return torch.zeros(params.num_insts, dtype=torch.int32, device=device)


def update_counters(params, st, alive_before, update_no):
    """Per-update counter block, after the birth flush, so the
    birth/death accounting matches what summarize() and light_stats()
    feed the .dat files.  Device scalars plus the task-execution lifetime
    totals (the host diffs consecutive updates, like tasks_exe.dat)."""
    alive = st.alive
    n_alive = alive.sum().to(torch.int32)
    births = (alive & (st.birth_update == update_no)).sum().to(torch.int32)
    deaths = torch.clamp(alive_before + births - n_alive, min=0)
    return {
        "organisms": n_alive,
        "births": births,
        "deaths": deaths,
        "divides_total": st.num_divides.sum().to(torch.int32),
        "task_exe_totals": st.task_exe_total.sum(dim=0).to(torch.int32),
    }


def budget_tail(granted, block: int):
    """Per-block budget-tail utilization of a granted vector: granted_sum
    and ceiling_sum (scheduler.block_ceiling, the lane-cycles the
    lockstep loops burn; float32 in XLA's order), block_max_max and
    block_mean_mean."""
    from avida_tpu_torch.ops.scheduler import block_ceiling
    n = granted.shape[0]
    g = torch.zeros(n + (-n) % block, dtype=granted.dtype,
                    device=granted.device)
    g[:n] = granted                   # padded lanes grant 0 cycles
    gb = g.reshape(-1, block)
    f32 = torch.float32
    return {
        "granted_sum": prng.xla_f32_sum(granted.to(f32)),
        "ceiling_sum": block_ceiling(granted, block),
        "block_max_max": gb.max(dim=1).values.max(),
        "block_mean_mean": gb.to(f32).mean(dim=1).mean(),
    }


def budget_block(params, n) -> int:
    """Blocking granularity of the update's cycles: the reference
    kernel's block width (cycles.dims' B) on the kernel route, else the
    whole population."""
    from avida_tpu_torch.ops import cycles
    if cycles.use_kernel(params):
        return cycles.dims(params, n, params.max_memory)[0]
    return n
