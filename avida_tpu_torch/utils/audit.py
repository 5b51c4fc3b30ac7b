"""State invariant auditor: fast corruption detection for run state.

Counterpart of avida_tpu/utils/audit.py.  `audit_state(params, st)`
checks the structural invariants of a PopulationState on its own device
and returns a per-invariant violation count (int32 each), equal to the
reference's counts on the same state.  It runs on every native
checkpoint save and restore (World.save_checkpoint / resume, unless
TPU_CKPT_AUDIT=0) and every TPU_AUDIT_EVERY updates inside World.run.

Invariant catalogue (see the reference module for the code that
establishes each):

  merit_finite, fitness_finite, bonus_finite   alive phenotype floats
  ip_in_bounds, heads_in_bounds                heads in [0, mem_len)
  genome_len_range, mem_len_range              lengths in range
  genome_ops_valid                             opcodes < num_insts
  input_ptr_nonneg, stack_ptr_range            IO cursor, stack pointers
  generation_nonneg, time_nonneg               monotone counters
  budget_carry_range                           [0, 100 * AVE_TIME_SLICE]
  dead_lane_granted                            the scheduler grants dead
                                               lanes nothing (a fixed key,
                                               ops/update.scheduler_probe)
  lane_perm_bijective, lane_inv_inverse        the lane permutation
  resources_nonneg, resources_finite           the resource pools
  off_window_valid                             pending offspring windows
  nb_count_nonneg                              the newborn ring cursor

The flight recorder's two ring checks apply only with the recorder on,
which this package refuses (TPU_TRACE).
"""

from __future__ import annotations

import torch


class StateInvariantError(AssertionError):
    """Raised by check_invariants with a per-invariant violation report."""

    def __init__(self, message: str, violations: dict):
        super().__init__(message)
        self.violations = violations


def audit_state(params, st) -> dict:
    """{invariant_name: int32 violation count} (0-d device tensors) for
    the whole population state.  All-zero means the state passes."""
    from avida_tpu_torch.ops.update import scheduler_probe

    n, L = st.tape.shape
    alive = st.alive
    mlen = torch.clamp(st.mem_len, min=1)

    def rows(mask):
        return mask.sum().to(torch.int32)

    def bad_float(x):
        return ~torch.isfinite(x) | (x < 0)

    checks = {}
    checks["merit_finite"] = rows(alive & bad_float(st.merit))
    checks["fitness_finite"] = rows(alive & bad_float(st.fitness))
    checks["bonus_finite"] = rows(alive & ~torch.isfinite(st.cur_bonus))

    ip = st.heads[:, 0]
    checks["ip_in_bounds"] = rows(alive & ((ip < 0) | (ip >= mlen)))
    other = st.heads[:, 1:]
    checks["heads_in_bounds"] = rows(
        alive & ((other < 0) | (other >= mlen[:, None])).any(dim=1))

    checks["genome_len_range"] = rows(
        alive & ((st.genome_len < params.min_genome_len)
                 | (st.genome_len > L)))
    checks["mem_len_range"] = rows(
        alive & ((st.mem_len < 1) | (st.mem_len > L)))

    in_genome = torch.arange(L, device=st.tape.device)[None, :] \
        < st.genome_len[:, None]
    bad_op = (st.genome < 0) | (st.genome.to(torch.int32)
                                >= params.num_insts)
    checks["genome_ops_valid"] = rows(
        alive & (in_genome & bad_op).any(dim=1))

    checks["input_ptr_nonneg"] = rows(alive & (st.input_ptr < 0))
    checks["stack_ptr_range"] = rows(
        alive & ((st.sp < 0) | (st.sp >= 10)).any(dim=1))
    checks["generation_nonneg"] = rows(alive & (st.generation < 0))
    checks["time_nonneg"] = rows(
        alive & ((st.time_used < 0) | (st.cpu_cycles < 0)))

    carry_cap = 100 * params.ave_time_slice
    checks["budget_carry_range"] = rows(
        (st.budget_carry < 0) | (st.budget_carry > carry_cap))

    _, granted, _ = scheduler_probe(params, st)
    checks["dead_lane_granted"] = rows(~alive & (granted != 0))

    safe_perm = torch.clamp(st.lane_perm, 0, n - 1).long()
    counts = torch.bincount(safe_perm, minlength=n)
    in_range = (st.lane_perm >= 0) & (st.lane_perm < n)
    checks["lane_perm_bijective"] = rows(~in_range) + rows(counts != 1)
    checks["lane_inv_inverse"] = rows(
        st.lane_inv[safe_perm] != torch.arange(n, dtype=st.lane_inv.dtype,
                                               device=st.lane_inv.device))

    res_neg = torch.zeros((), dtype=torch.int32, device=alive.device)
    res_nan = torch.zeros((), dtype=torch.int32, device=alive.device)
    for pool in (st.resources, st.res_grid, st.deme_resources):
        res_neg = res_neg + rows(pool < -1e-3)
        res_nan = res_nan + rows(~torch.isfinite(pool))
    checks["resources_nonneg"] = res_neg
    checks["resources_finite"] = res_nan

    checks["off_window_valid"] = rows(
        st.divide_pending & ((st.off_len < 0) | (st.off_len > L)
                             | (st.off_start < 0) | (st.off_start >= L)))
    checks["nb_count_nonneg"] = (st.nb_count < 0).to(torch.int32)
    return checks


def check_invariants(params, st, where: str = "") -> dict:
    """Run the auditor; raise StateInvariantError with a per-invariant
    report when anything is violated, else return the (all-zero) count
    dict."""
    counts = {k: int(v) for k, v in audit_state(params, st).items()}
    bad = {k: v for k, v in counts.items() if v}
    if bad:
        ctx = f" at {where}" if where else ""
        report = ", ".join(f"{k}={v} cell(s)" for k, v in sorted(bad.items()))
        raise StateInvariantError(
            f"state invariant violation{ctx}: {report}", bad)
    return counts
