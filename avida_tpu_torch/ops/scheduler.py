"""Merit-proportional CPU-cycle allocation, lockstep style.

Counterpart of avida_tpu/ops/scheduler.py: one per-update instruction
budget per organism (cPopulation::BuildTimeSlicer, cPopulation.cc:7326;
SLICING_METHOD semantics at cAvidaConfig.h:545), drawn from the same
`jax.random` stream (utils/prng.py).
"""

from __future__ import annotations

import torch

from avida_tpu_torch.utils import prng


def compute_budgets_from(params, alive, merit, key):
    """int32[N] budgets from bare (alive, merit) vectors."""
    f32 = torch.float32
    num_orgs = alive.sum().to(torch.int32)
    ud_size = params.ave_time_slice * num_orgs
    if params.slicing_method == 0:
        return torch.where(alive, params.ave_time_slice, 0).to(torch.int32)

    merit = torch.where(alive, merit.clamp(min=0.0), 0.0)
    # the reference's float32 total, in XLA's summation order (merits of
    # recombinant offspring are not integers, so the order shows)
    total = prng.xla_f32_sum(merit)
    p = torch.where(total > 0, merit / total.clamp(min=1e-30), 0.0)

    if params.slicing_method == 1:
        n = alive.shape[0]
        if n >= 32768:
            # normal approximation of Binomial(UD, p) ~ Poisson(lam) for
            # large populations (the reference's documented deviation)
            lam = p * ud_size.to(f32)
            z = prng.normal(key, (n,))
            k = torch.round(prng.fma_f32(prng.sqrt_f32(lam.clamp(min=0.0)), z, lam))
            k = k.clamp(min=0.0)
        else:
            k = prng.binomial(key, ud_size.to(f32), p)
        return torch.where(alive, k, 0).to(torch.int32)

    if params.slicing_method == 2:
        share = p * ud_size.to(f32)
        base = torch.floor(share)
        frac = share - base
        # the float32 total in XLA's order: past 2**24 it rounds by order
        remainder = (ud_size - prng.xla_f32_sum(base)).to(torch.int32)
        order = torch.argsort(-frac, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.shape[0], device=order.device)
        k = base.to(torch.int32) + (rank < remainder).to(torch.int32)
        return torch.where(alive, k, 0)

    raise NotImplementedError(f"SLICING_METHOD {params.slicing_method}")


def block_ceiling(granted, block: int):
    """Lockstep lane-cycle ceiling of a granted vector under `block`-wide
    blocking: sum over blocks of block * block max (float32, in XLA's
    summation order: past 2**24 the total rounds by order)."""
    n = granted.shape[0]
    g = torch.zeros(n + (-n) % block, dtype=granted.dtype,
                    device=granted.device)
    g[:n] = granted                   # padded lanes grant 0 cycles
    bmax = g.reshape(-1, block).max(dim=1).values.to(torch.float32)
    return prng.xla_f32_sum(bmax * float(block))


def block_utilization(granted, block: int):
    """granted.sum() / block_ceiling: the fraction of lockstep lane-cycles
    doing useful work (float32; ops/update.perm_phase's early-refresh
    statistic)."""
    ceil = block_ceiling(granted, block)
    return prng.xla_f32_sum(granted.to(torch.float32)) / ceil.clamp(min=1.0)
