"""Phase-by-phase execution of one update, for timing attribution.

Counterpart of avida_tpu/observability/staged.py.  `StagedUpdate` runs
the phase functions ops/update.update_step runs -- resource_phase,
schedule_phase, perm_phase, the flight recorder's halves, the update's
cycles (on the kernel route split into cycles.pack_state / one kernel
launch / cycles.unpack_state, as run_cycles does them), bank_phase,
birth_phase and the device faults -- in the same order, each fenced by a
Timeline so wall time is attributed per phase.  The trajectory is
bit-identical to update_step given the same key
(tests/test_torch_telemetry.py): the same functions in the same order,
only the fences differ.

Fencing serializes work the card would overlap, so a staged update is
slower than an unstaged one: the telemetry trade, opt-in (TPU_TELEMETRY).
"""

from __future__ import annotations

import torch

from avida_tpu_torch.observability import counters as counters_mod
from avida_tpu_torch.ops import cycles
from avida_tpu_torch.ops.update import (bank_phase, birth_phase,
                                        fault_phase, perm_phase,
                                        resource_phase, schedule_phase,
                                        static_cap, trace_post_phase,
                                        trace_pre_phase, xla_cycles)
from avida_tpu_torch.utils import prng


class StagedUpdate:
    """Per-phase update runner.

    collect_dispatch: collect the instruction-dispatch mix on the
    micro-step engine.  Only meaningful for single-threaded heads
    hardware off the kernel route: the kernel does not collect it,
    fetch_opcode reads the heads IP (the TransSMT and experimental
    interpreters keep theirs elsewhere), and with MAX_CPU_THREADS > 1
    only one thread's sub-step would be sampled -- all gated off rather
    than reporting plausible-looking garbage."""

    def __init__(self, params, neighbors, collect_dispatch=True):
        self.params = params
        self.neighbors = neighbors
        self.kernel = cycles.use_kernel(params)
        self.cap = static_cap(params)
        self.collect_dispatch = (collect_dispatch and not self.kernel
                                 and params.hw_type == 0
                                 and params.max_cpu_threads <= 1)
        self.trace = int(params.trace_cap) > 0
        self.fault = bool(params.fault_nan or params.fault_bitflip)

    def _pack(self, st, granted):
        perm, _ = cycles.lane_order(self.params, st)
        return cycles.pack_state(self.params, st, granted, perm)

    def _launch(self, planes, k_steps, n):
        return cycles.launch(self.params, planes, k_steps, self.cap, n)

    def _unpack(self, st, planes):
        return cycles.unpack_state(self.params, st, planes,
                                   cycles.lane_order(self.params, st)[1])

    def run(self, st, key, update_no, timeline):
        """One update, phase-fenced into `timeline`.  Returns (st,
        executed, dispatch_counts | None, granted, alive_before)."""
        p, tl = self.params, timeline
        u = int(update_no)
        ks = tl.run("schedule", prng.split, key, 3)
        k_budget, k_steps, k_birth = ks[0], ks[1], ks[2]
        alive_before = tl.run("counters",
                              lambda: st.alive.sum().to(torch.int32))
        st = tl.run("resources", resource_phase, p, st, key, u)
        budgets, granted, max_k = tl.run("schedule", schedule_phase, p, st,
                                         k_budget)
        st = tl.run("schedule", perm_phase, p, st, granted, u)
        tsnap = None
        if self.trace:
            st, tsnap = tl.run("trace", trace_pre_phase, p, st, granted, u)
        executed0 = st.insts_executed
        dispatch = None
        if self.kernel:
            planes = tl.run("pack", self._pack, st, granted)
            planes = tl.run("kernel", self._launch, planes, k_steps,
                            st.tape.shape[0])
            st = tl.run("unpack", self._unpack, st, planes)
        else:
            if self.collect_dispatch:
                dispatch = counters_mod.dispatch_init(p, st.alive.device)
            st = tl.run("while_loop", xla_cycles, p, st, k_steps, granted,
                        max_k, dispatch)
        st, executed = tl.run("bank", bank_phase, p, st, budgets, executed0)
        st = tl.run("birth_flush", birth_phase, p, st, k_birth, k_steps, u,
                    self.neighbors)
        if self.fault:
            st = tl.run("fault", fault_phase, p, st, u)
        if self.trace:
            st = tl.run("trace", trace_post_phase, p, st, tsnap, u)
        return st, executed, dispatch, granted, alive_before
