"""Silent-corruption integrity plane: host half (digest + taxonomy).

The counterpart of avida_tpu/utils/integrity.py, numpy and stdlib only:

  * `digest_arrays` -- the ORDER-STABLE u32 mix-and-fold tree digest.
    This host (numpy) implementation and the device one
    (ops/digest.state_digest, torch) agree bit for bit by construction:
    both walk leaves in sorted-name order, salt every element with its
    position and every leaf with a crc32 of its name, and fold with the
    same u32 wraparound arithmetic.  The agreement is what lets a
    host-only process (`--resume`, a checkpoint verifier) re-verify a
    digest the device computed, and the reference's digests are the
    same numbers.
  * `generation_digest` -- recompute the digest of a checkpoint
    generation from its `state.*.npy` leaves, for comparison against the
    `state_digest` the manifest stores (utils/checkpoint.py writes it
    when the integrity plane is on).
  * the process-wide integrity counters and the `integrity.jsonl`
    records.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

# the shared mix-and-fold constants (ops/digest.py uses the same ones;
# change one side and the host/device agreement test fails loudly)
C_IDX = 0x9E3779B9          # per-element position salt multiplier
C_MIX = 0x85EBCA6B          # element mixer
C_FOLD = 0xC2B2AE35         # leaf finalizer
FNV_OFFSET = 0x811C9DC5     # cross-leaf combine seed
FNV_PRIME = 0x01000193      # cross-leaf combine multiplier

_U32 = 0xFFFFFFFF

INTEGRITY_LOG = "integrity.jsonl"


def digest_enabled(cfg) -> bool:
    """TPU_STATE_DIGEST, env-OR-config: armed when either the config
    var (avida.cfg / -set) or the environment variable is nonzero --
    the environment half lets an operator arm digesting across every
    child without touching specs.  tests/conftest.py pins the env var to
    0 for suite hermeticity; explicit test overrides still win through
    the config half."""
    if int(cfg.get("TPU_STATE_DIGEST", 0) or 0):
        return True
    return bool(int(os.environ.get("TPU_STATE_DIGEST", "0") or 0))


def scrub_every(cfg) -> int:
    """TPU_SCRUB_EVERY (chunks between sampled shadow re-executions),
    env-OR-config with the config value winning when nonzero."""
    v = int(cfg.get("TPU_SCRUB_EVERY", 0) or 0)
    if v:
        return v
    return int(os.environ.get("TPU_SCRUB_EVERY", "0") or 0)


class StateDivergenceError(AssertionError):
    """A scrub (shadow re-execution) produced a different state digest
    than the live execution -- on a deterministic engine that is
    evidence of silent data corruption (or of a kernel that is not
    deterministic), never noise.  Mapped to the classified exit
    EXIT_SDC (67) by __main__."""


# ---------------------------------------------------------------------------
# the digest (host reference implementation)
# ---------------------------------------------------------------------------

def leaf_words(arr: np.ndarray) -> np.ndarray:
    """Canonical u32 word stream of one leaf: bools as 0/1, one-byte
    dtypes zero-extended bit-preserving, four-byte dtypes bit-cast.
    Row-major element order, so the digest is ORDER-STABLE: swapping two
    elements changes it."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.bool_:
        return arr.astype(np.uint32).ravel()
    if arr.dtype.itemsize == 1:
        return arr.view(np.uint8).astype(np.uint32).ravel()
    if arr.dtype.itemsize == 4:
        return arr.ravel().view(np.uint32)
    raise ValueError(
        f"state digest supports 1- and 4-byte leaves only (got "
        f"{arr.dtype}); PopulationState declares every field at one of "
        f"those widths")


def fold_words(words: np.ndarray) -> int:
    """u32[n] -> one u32: position-salted multiply-xor per element, a
    commutative xor reduce (deterministic on every backend), then a
    length-salted finalizer.  The position salt is what makes the xor
    fold order-stable."""
    n = int(words.shape[0])
    if n:
        idx = np.arange(n, dtype=np.uint32)
        h = (words ^ (idx * np.uint32(C_IDX))) * np.uint32(C_MIX)
        h = h ^ (h >> np.uint32(15))
        x = int(np.bitwise_xor.reduce(h))
    else:
        x = 0
    d = ((x ^ ((n * C_IDX) & _U32)) * C_FOLD) & _U32
    return d ^ (d >> 13)


def name_salt(name: str) -> int:
    return zlib.crc32(name.encode()) & _U32


def combine(leaf_digests: list) -> int:
    """[(name, u32)] -> one u32, folded in SORTED name order with a
    per-name salt -- renaming, dropping or swapping a leaf changes the
    digest (the tree-shape half of order stability)."""
    d = FNV_OFFSET
    for name, leaf in sorted(leaf_digests):
        d = ((d ^ (leaf ^ name_salt(name))) * FNV_PRIME) & _U32
        d ^= d >> 17
    return d


def digest_arrays(arrays: dict) -> int:
    """The full tree digest of {leaf_name: np.ndarray} -- the host
    spelling of ops/digest.state_digest (the device computes the same
    value over the live PopulationState).  None leaves are skipped."""
    return combine([(name, fold_words(leaf_words(np.asarray(a))))
                    for name, a in arrays.items() if a is not None])


# ---------------------------------------------------------------------------
# checkpoint-generation digests (manifest `state_digest` verification)
# ---------------------------------------------------------------------------

_STATE_PREFIX = "state."


def state_arrays_of(arrays: dict) -> dict:
    """The PopulationState subset of a checkpoint's array dict, prefix
    stripped -- the exact leaf set (and names) the digest covers.  The
    PRNG key sidecars are protected by the ordinary CRC manifest; the
    digest covers the evolved state the device actually computes on."""
    return {k[len(_STATE_PREFIX):]: v for k, v in arrays.items()
            if k.startswith(_STATE_PREFIX)}


def generation_digest(gen_path: str) -> tuple:
    """(stored, recomputed) digests for one checkpoint generation --
    stored is None when the manifest predates the integrity plane (or
    it was written with digesting off).  Reads the `state.*.npy` leaves
    directly (numpy only); callers wanting CRC validation first use
    checkpoint.verify_generation."""
    with open(os.path.join(gen_path, "manifest.json")) as f:
        manifest = json.load(f)
    stored = manifest.get("state_digest")
    arrays = {}
    for name, spec in manifest.get("arrays", {}).items():
        if not name.startswith(_STATE_PREFIX):
            continue
        arrays[name[len(_STATE_PREFIX):]] = np.load(
            os.path.join(gen_path, spec["file"]))
    return (None if stored is None else int(stored),
            digest_arrays(arrays))


# ---------------------------------------------------------------------------
# process-wide counters
# ---------------------------------------------------------------------------

_counters = {
    "scrubs": 0,            # shadow re-executions completed (or failed)
    "mismatches": 0,        # scrub digest mismatches (detected SDC)
    "digest_ms": 0.0,       # host wall spent dispatching/reading digests
}


def note_scrub():
    _counters["scrubs"] += 1


def note_mismatch():
    _counters["mismatches"] += 1


def note_digest_ms(ms: float):
    _counters["digest_ms"] += float(ms)


def counters() -> dict:
    return dict(_counters)


def reset_for_tests():
    for k in _counters:
        _counters[k] = 0 if isinstance(_counters[k], int) else 0.0


def prom_families() -> list:
    """The avida_integrity_* families, render_families shaped.  Empty
    when the integrity plane never ran, so digest-off processes publish
    byte-identical metrics files."""
    c = _counters
    if not (c["scrubs"] or c["mismatches"] or c["digest_ms"]):
        return []
    return [
        ("avida_integrity_scrubs_total", "counter",
         "shadow re-executions (sampled chunk replays) completed",
         c["scrubs"]),
        ("avida_integrity_mismatches_total", "counter",
         "scrub digest mismatches -- detected silent data corruption",
         c["mismatches"]),
        ("avida_integrity_digest_ms_total", "counter",
         "milliseconds of host wall spent dispatching and reading "
         "state digests", round(c["digest_ms"], 1)),
    ]


def append_integrity_record(data_dir: str, event: str,
                            max_bytes: int = 16 << 20, **fields):
    """One {"record": "integrity"} line in DATA_DIR/integrity.jsonl
    (size-capped rotation pair; non-durable appends -- the hot-loop
    runlog flavor, a torn tail is tolerated by every reader).  Shared
    by the solo and multi-world run loops so the record shape has one
    spelling."""
    from avida_tpu_torch.observability.records import append_record
    rec = {"record": "integrity", "event": event, **fields}
    try:
        append_record(os.path.join(data_dir, INTEGRITY_LOG), rec,
                      max_bytes=max_bytes, durable=False)
    except OSError:
        pass                    # logging must not take down the run
