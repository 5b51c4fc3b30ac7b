"""Device-side state digest: the torch half of the integrity plane.

Counterpart of avida_tpu/ops/digest.py.  `state_digest(st)` reduces a
whole PopulationState to ONE u32 on the state's own device -- an
order-stable tree digest (position-salted u32 mix-and-fold per leaf,
sorted-name combine across leaves) equal bit for bit to the numpy
mirror utils/integrity.digest_arrays and to the reference's digest of
the same state.  World.run computes it at chunk boundaries when
TPU_STATE_DIGEST / TPU_SCRUB_EVERY are armed; the value lands in the
checkpoint manifest (`state_digest`) and integrity.jsonl, and the scrub
compares a live chunk's digest with its shadow replay's.

torch has no unsigned 32-bit arithmetic and no XOR reduction, so the
words ride in int64 holding u32 values: every product is reduced mod
2^32 (a multiply by a 32-bit constant is split into 16-bit halves so
nothing overflows int64), shifts act on non-negative values (logical),
and the XOR reduce folds pairwise, halving the length each step.
Leaves are read as the reference reads them: bools as 0/1, int8 and
uint8 zero-extended, four-byte leaves (float32 included) bit-cast.
"""

from __future__ import annotations

import torch

from avida_tpu_torch.core.state import state_field_names
from avida_tpu_torch.utils.integrity import (C_FOLD, C_IDX, C_MIX,
                                             FNV_OFFSET, FNV_PRIME,
                                             name_salt)

_M = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and a constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M


def _leaf_words(x: torch.Tensor, W: int) -> torch.Tensor:
    """[W, n] int64 word streams (u32 values), row-major per world: the
    mirror of utils/integrity.leaf_words."""
    x = x.reshape(W, -1)
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    if x.dtype == torch.int8:
        return x.view(torch.uint8).to(torch.int64)
    if x.dtype == torch.uint8:
        return x.to(torch.int64)
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64) & _M
    if x.dtype == torch.int32:
        return x.to(torch.int64) & _M
    raise ValueError(
        f"state digest supports 1- and 4-byte leaves only (got {x.dtype})")


def _xor_reduce(h: torch.Tensor) -> torch.Tensor:
    """[W, n] -> [W]: XOR over the last axis, folding halves."""
    while h.shape[1] > 1:
        n = h.shape[1]
        if n % 2:
            h = torch.cat([h, torch.zeros_like(h[:, :1])], dim=1)
        half = h.shape[1] // 2
        h = h[:, :half] ^ h[:, half:]
    return h[:, 0]


def _fold_words(w: torch.Tensor) -> torch.Tensor:
    """[W, n] -> [W]: mirror of utils/integrity.fold_words."""
    W, n = w.shape
    if n:
        idx = torch.arange(n, dtype=torch.int64, device=w.device)
        h = _mul32(w ^ ((idx * C_IDX) & _M), C_MIX)
        h = h ^ (h >> 15)
        x = _xor_reduce(h)
    else:
        x = torch.zeros(W, dtype=torch.int64, device=w.device)
    d = _mul32(x ^ ((n * C_IDX) & _M), C_FOLD)
    return d ^ (d >> 13)


def _digest(st, W: int) -> torch.Tensor:
    """[W] int64 tree digests (u32 values): leaves in sorted field-name
    order, each salted with its name's crc32; None leaves skipped."""
    d = None
    for name in sorted(state_field_names()):
        leaf = getattr(st, name)
        if leaf is None:
            continue
        ld = _fold_words(_leaf_words(leaf, W))
        if d is None:
            d = torch.full_like(ld, FNV_OFFSET)
        d = ((d ^ (ld ^ name_salt(name))) * FNV_PRIME) & _M
        d = d ^ (d >> 17)
    return d


def state_digest(st) -> torch.Tensor:
    """The digest of one PopulationState: a 0-d int64 tensor on the
    state's device holding the u32 value.  Nothing is read back here;
    `int(...)` on the result is the host readback (deferred by one chunk
    on the run loop's path)."""
    return _digest(st, 1)[0]


def state_digest_batched(bst) -> torch.Tensor:
    """[W] digests of a world-stacked batch state: member w's digest
    equals the digest of its own state (its solo run's)."""
    return _digest(bst, bst.alive.shape[0])
