"""Deterministic, seeded fault injection: the `TPU_FAULT` spec.

The only way to trust the self-healing machinery (service/supervisor.py,
checkpoint CRC fallback, the state auditor) is to inject the failures it
claims to survive -- deterministically, so a chaos test that passes
today reproduces bit-exactly tomorrow.  Every fault is host-side except
the `nan` kind, which corrupts device state inside the update
behind a WorldParams flag (same discipline as the flight recorder: with
TPU_FAULT unset update_step runs none of it).  Counterpart of
avida_tpu/utils/faultinject.py, the grammar and every kind kept; the two
device phases are torch.

Spec grammar (config var or environment variable `TPU_FAULT`):

    spec    := fault (";" fault)*
    fault   := kind [":" args] ["@" trigger "=" INT]
    args    := arg ("," arg)*
    arg     := KEY "=" VALUE | VALUE          (bare VALUE -> the kind's
                                               default key, see below)
    trigger := "update" | "chunk"

Kinds (default arg key in brackets):

    crash            raise FaultInjected at a run-loop chunk boundary
                     (an unhandled exception: nonzero exit, no final
                     checkpoint beyond the last auto-save)
    sigkill          SIGKILL our own process at a boundary -- the
                     abrupt host death: no drain, no flush, no atexit
    hang [sec]       stop making progress at a boundary (the heartbeat
                     goes stale; the supervisor's watchdog must kill
                     us).  `hang:sec=5` stalls transiently instead
    corrupt-ckpt [leaf]   after a checkpoint save, flip one seeded
                     payload byte of `state.<leaf>.npy` (default leaf
                     `merit`) in the just-published generation --
                     CRC-detectable corruption at rest
    torn-manifest    after a checkpoint save, truncate the generation's
                     manifest.json at a seeded fraction (a manifest
                     torn mid-write)
    corrupt-digest   after a checkpoint save, flip the manifest's
                     stored `state_digest` (payload CRCs untouched):
                     the loader-corruption class -- bytes verify, the
                     decoded state would not.  Caught by the resume
                     digest verification and `ckpt_tool --verify`
                     (DIGEST MISMATCH), never by CRC
    nan [leaf]       device-side: set `st.<leaf>[cell]` (default leaf
                     `merit`, default cell the injection cell) to NaN
                     at `@update=N` inside the update.  Requires
                     an `@update` trigger; caught by the state auditor
                     and the flight recorder's anomaly events
    bitflip [leaf]   device-side: XOR one bit (default bit 0, the low
                     mantissa bit -- finite, in-bounds, invisible to
                     every auditor invariant) of `st.<leaf>[cell]` at
                     `@update=N` inside the update, modeling a
                     real SDC event.  `bitflip:merit,cell=5,bit=3
                     @update=40`.  Requires `@update`; caught ONLY by
                     the integrity plane's sampled shadow re-execution
                     (TPU_SCRUB_EVERY), because the shadow replay runs
                     the PRISTINE program -- an injected device fault
                     models a transient hardware event, which by
                     definition fires in the live execution only

Triggers: `@update=N` fires at the first chunk boundary whose update
counter is >= N (save kinds: the first save at update >= N); `@chunk=K`
at the K-th boundary of THIS process (1-based).  Boundary kinds default
to the first boundary, save kinds to the first save.  Each fault fires
at most once per process.

Seeding: every fault gets its own `random.Random` stream derived from
(TPU_FAULT_SEED, fault index, fault text), so byte positions and
truncation points are reproducible run-to-run and independent of the
run's own PRNG streams.
"""

from __future__ import annotations

import os
import random
import signal
import time
import zlib

KINDS = ("crash", "sigkill", "hang", "corrupt-ckpt", "torn-manifest",
         "corrupt-digest", "nan", "bitflip")
_DEFAULT_KEY = {"corrupt-ckpt": "leaf", "nan": "leaf", "bitflip": "leaf",
                "hang": "sec"}
_BOUNDARY_KINDS = ("crash", "sigkill", "hang")
_SAVE_KINDS = ("corrupt-ckpt", "torn-manifest", "corrupt-digest")
NAN_LEAVES = ("merit", "fitness")
# the in-bounds SDC kind targets float32 leaves so a low-mantissa flip
# stays finite/non-negative and sails past every audit_state invariant
BITFLIP_LEAVES = ("merit", "fitness")


class FaultInjected(RuntimeError):
    """The `crash` fault kind: a simulated unexpected failure."""


class Fault:
    """One parsed fault: kind, args, optional trigger, its own RNG."""

    def __init__(self, kind: str, args: dict, trigger, text: str):
        self.kind = kind
        self.args = args
        self.trigger = trigger          # None | ("update"|"chunk", int)
        self.text = text
        self.rng: random.Random | None = None
        self.fired = False

    def due(self, update: int, chunk: int) -> bool:
        if self.trigger is None:
            return True
        name, val = self.trigger
        return (update >= val) if name == "update" else (chunk >= val)

    def __repr__(self):
        return f"Fault({self.text!r})"


def _parse_one(text: str) -> Fault:
    part = text
    trigger = None
    if "@" in part:
        part, trig = part.split("@", 1)
        name, eq, val = trig.partition("=")
        if not eq or name not in ("update", "chunk"):
            raise ValueError(
                f"fault {text!r}: trigger must be @update=N or @chunk=K")
        trigger = (name, int(val))
    kind, _, argstr = part.partition(":")
    kind = kind.strip()
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r} in {text!r} "
                         f"(known: {', '.join(KINDS)})")
    args = {}
    if argstr:
        for tok in argstr.split(","):
            k, eq, v = tok.partition("=")
            if eq:
                args[k.strip()] = v.strip()
            elif kind in _DEFAULT_KEY:
                args[_DEFAULT_KEY[kind]] = k.strip()
            else:
                raise ValueError(
                    f"fault {text!r}: kind {kind!r} takes no bare argument")
    if kind in _SAVE_KINDS and trigger is not None \
            and trigger[0] != "update":
        raise ValueError(
            f"fault {text!r}: save-time kinds ({', '.join(_SAVE_KINDS)}) "
            f"fire on checkpoint publishes, which have no chunk index -- "
            f"use @update=N or no trigger (first save)")
    if kind in ("nan", "bitflip"):
        if trigger is None or trigger[0] != "update":
            raise ValueError(f"fault {text!r}: {kind} requires @update=N "
                             f"(it is injected inside the jitted update)")
        leaves = NAN_LEAVES if kind == "nan" else BITFLIP_LEAVES
        leaf = args.get("leaf", "merit")
        if leaf not in leaves:
            raise ValueError(f"fault {text!r}: {kind} leaf must be one of "
                             f"{leaves} (got {leaf!r})")
    if kind == "bitflip":
        bit = int(args.get("bit", 0))
        if not 0 <= bit < 32:
            raise ValueError(f"fault {text!r}: bit must be in [0, 32)")
    if kind == "hang" and "sec" in args:
        float(args["sec"])              # validate now, not at fire time
    return Fault(kind, args, trigger, text)


def parse_spec(spec: str, seed: int = 0) -> list:
    """Parse a full TPU_FAULT spec into seeded Fault objects."""
    faults = []
    parts = [p.strip() for p in spec.split(";")]
    for i, part in enumerate(p for p in parts if p):
        f = _parse_one(part)
        f.rng = random.Random(zlib.crc32(f"{seed}|{i}|{part}".encode()))
        faults.append(f)
    if not faults:
        raise ValueError(f"empty TPU_FAULT spec {spec!r}")
    return faults


def active_spec(cfg) -> str | None:
    """The effective fault spec: the TPU_FAULT config var (settable via
    `-set TPU_FAULT ...`) or, when ABSENT there, the TPU_FAULT
    environment variable (how the supervisor injects per-boot faults
    into its children).  An explicit config value of '-', '' or '0'
    means OFF and wins over the environment -- `-set TPU_FAULT 0` must
    be able to disable a fault exported in the shell."""
    val = cfg.get("TPU_FAULT", None)
    if val is None:
        val = os.environ.get("TPU_FAULT", "")
    val = str(val)
    return val if val not in ("-", "", "0") else None


def nan_param(cfg) -> tuple:
    """The static WorldParams.fault_nan tuple (leaf, cell, update) for a
    `nan:` fault in the active spec, or () -- in which case update_step
    runs none of it."""
    spec = active_spec(cfg)
    if not spec:
        return ()
    for f in parse_spec(spec):
        if f.kind != "nan":
            continue
        leaf = f.args.get("leaf", "merit")
        num_cells = int(cfg.WORLD_X) * int(cfg.WORLD_Y)
        cell = int(f.args.get("cell", num_cells // 2))
        if not 0 <= cell < num_cells:
            raise ValueError(f"nan fault cell {cell} outside [0, {num_cells})")
        return (leaf, cell, int(f.trigger[1]))
    return ()


def nan_phase(params, st, update_no):
    """Device-side NaN injection (called from ops/update.update_step and
    observability/staged.StagedUpdate ONLY when params.fault_nan is
    set): poison one float leaf entry at the trigger update."""
    leaf, cell, at_update = params.fault_nan
    if int(update_no) != at_update:
        return st
    arr = getattr(st, leaf).clone()
    arr[cell] = float("nan")
    return st.replace(**{leaf: arr})


def bitflip_param(cfg) -> tuple:
    """The static WorldParams.fault_bitflip tuple (leaf, cell, bit,
    update) for a `bitflip:` fault in the active spec, or () -- in which
    case update_step runs none of it."""
    spec = active_spec(cfg)
    if not spec:
        return ()
    for f in parse_spec(spec):
        if f.kind != "bitflip":
            continue
        leaf = f.args.get("leaf", "merit")
        num_cells = int(cfg.WORLD_X) * int(cfg.WORLD_Y)
        cell = int(f.args.get("cell", num_cells // 2))
        if not 0 <= cell < num_cells:
            raise ValueError(
                f"bitflip fault cell {cell} outside [0, {num_cells})")
        return (leaf, cell, int(f.args.get("bit", 0)), int(f.trigger[1]))
    return ()


def bitflip_phase(params, st, update_no):
    """Device-side single-bit flip (the modeled SDC event): XOR one bit
    of one float leaf entry at the trigger update, behind the
    params.fault_bitflip gate.  The default bit 0 (low mantissa) keeps
    the value finite and in-bounds -- the corruption class NO audit_state
    invariant can see, which is exactly what the integrity plane's scrub
    exists to catch.  The shadow re-execution strips this gate
    (World._shadow_params): a transient hardware fault fires in the live
    execution only."""
    import torch
    leaf, cell, bit, at_update = params.fault_bitflip
    if int(update_no) != at_update:
        return st
    arr = getattr(st, leaf).clone()
    word = arr[cell:cell + 1].view(torch.int32)
    mask = (1 << bit) - (1 << 32 if bit == 31 else 0)    # int32 bit pattern
    arr[cell:cell + 1] = (word ^ mask).view(arr.dtype)
    return st.replace(**{leaf: arr})


# ---------------------------------------------------------------------------
# host-side corruption helpers (also used directly by tests)
# ---------------------------------------------------------------------------

def corrupt_leaf(gen_path: str, leaf: str = "merit",
                 rng: random.Random | None = None) -> int:
    """Flip one seeded payload byte of state.<leaf>.npy in a published
    checkpoint generation (CRC-detectable at verify/restore time).
    Returns the flipped offset."""
    rng = rng or random.Random(0)
    fpath = os.path.join(gen_path, f"state.{leaf}.npy")
    if not os.path.exists(fpath):
        raise ValueError(f"no state.{leaf}.npy under {gen_path!r}")
    size = os.path.getsize(fpath)
    # aim past the ~128-byte .npy header so the flip lands in the payload
    lo = min(128, max(size - 1, 0))
    pos = rng.randrange(lo, size)
    with open(fpath, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0x40]))
    return pos


def tear_manifest(gen_path: str, rng: random.Random | None = None) -> int:
    """Truncate a generation's manifest.json at a seeded interior
    fraction -- exactly what a crash mid-manifest-write leaves behind.
    Returns the surviving byte count."""
    rng = rng or random.Random(0)
    mpath = os.path.join(gen_path, "manifest.json")
    size = os.path.getsize(mpath)
    keep = int(size * rng.uniform(0.15, 0.85))
    os.truncate(mpath, keep)
    return keep


def corrupt_digest(gen_path: str, rng: random.Random | None = None) -> int:
    """Flip one seeded bit of the manifest's stored `state_digest`
    (written when the integrity plane is armed; a digest-off manifest
    gets a seeded bogus value) while every payload CRC stays intact --
    the at-rest model of the LOADER-corruption class: the bytes verify,
    the state they decode to would not.  Returns the new stored value.
    Caught by the resume digest verification (restore falls back past
    the generation with a `checkpoint_digest_mismatch` journal line)
    and by `ckpt_tool --verify` (DIGEST MISMATCH), never by CRC."""
    import json
    rng = rng or random.Random(0)
    mpath = os.path.join(gen_path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    old = manifest.get("state_digest")
    if old is None:
        new = rng.randrange(1, 1 << 32)
    else:
        new = int(old) ^ (1 << rng.randrange(32))
        if new == int(old):             # unreachable, but stay corrupt
            new = int(old) ^ 1
    manifest["state_digest"] = new
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return new


# ---------------------------------------------------------------------------
# the run-time plan (World hooks)
# ---------------------------------------------------------------------------

class FaultPlan:
    """Parsed faults + fire-once bookkeeping for one process.

    World calls `at_boundary` once per run-loop iteration (after the
    auto-save/audit hooks, so `sigkill@update=N` dies AFTER any save due
    at that boundary) and `at_save` with each just-published generation
    path."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.faults = parse_spec(spec, seed)
        self._chunk = 0

    def at_boundary(self, world):
        self._chunk += 1
        for f in self.faults:
            if f.fired or f.kind not in _BOUNDARY_KINDS \
                    or not f.due(world.update, self._chunk):
                continue
            f.fired = True
            self._execute(f, world)

    def at_save(self, world, gen_path: str):
        for f in self.faults:
            if f.fired or f.kind not in _SAVE_KINDS:
                continue
            if f.trigger is not None and f.trigger[0] == "update" \
                    and world.update < f.trigger[1]:
                continue
            f.fired = True
            from avida_tpu_torch.observability.runlog import emit_event
            if f.kind == "corrupt-ckpt":
                leaf = f.args.get("leaf", "merit")
                pos = corrupt_leaf(gen_path, leaf, f.rng)
                emit_event(world, "fault_injected", kind="corrupt-ckpt",
                           spec=f.text, path=gen_path, leaf=leaf, offset=pos)
            elif f.kind == "corrupt-digest":
                val = corrupt_digest(gen_path, f.rng)
                emit_event(world, "fault_injected", kind="corrupt-digest",
                           spec=f.text, path=gen_path,
                           stored_digest=f"{val:#010x}")
            else:
                keep = tear_manifest(gen_path, f.rng)
                emit_event(world, "fault_injected", kind="torn-manifest",
                           spec=f.text, path=gen_path, kept_bytes=keep)

    def _execute(self, f: Fault, world):
        if f.kind == "sigkill":
            # the abrupt death: no runlog line, no flush -- exactly what
            # a host OOM-kill or machine loss looks like from outside
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)              # unreachable: await delivery
            return
        from avida_tpu_torch.observability.runlog import emit_event
        if f.kind == "crash":
            emit_event(world, "fault_injected", kind="crash", spec=f.text,
                       update=world.update)
            raise FaultInjected(
                f"injected crash at update {world.update} ({f.text})")
        # hang: stop making progress.  The heartbeat file goes stale and
        # the supervisor's watchdog SIGKILLs us; a finite `sec` arg
        # models a transient stall that resolves on its own instead.
        emit_event(world, "fault_injected", kind="hang", spec=f.text,
                   update=world.update)
        sec = float(f.args.get("sec", 0) or 0)
        deadline = time.time() + sec if sec > 0 else None
        while deadline is None or time.time() < deadline:
            time.sleep(0.05 if deadline is not None else 1.0)


def plan_from_config(cfg):
    """World's entry point: a FaultPlan when a spec is active, else
    None (the common case -- zero overhead, no hooks fire)."""
    spec = active_spec(cfg)
    if spec is None:
        return None
    return FaultPlan(spec, seed=int(cfg.get("TPU_FAULT_SEED", 0) or 0))
