"""Native bit-exact run checkpoints (crash-safe save / verified resume).

The counterpart of avida_tpu/utils/checkpoint.py, in the same on-disk
format: a checkpoint written by either package resumes in the other, and
the same arrays give a byte-identical generation (every `.npy` and
sidecar; `manifest.json` apart from `saved_at`).

  * a checkpoint DIRECTORY per generation (`ckpt-<update>`), one `.npy`
    per PopulationState leaf plus the PRNG keys (`prng.key`,
    `prng.run_key`, uint32[2] -- the reference's `jax.random.key_data`),
    a systematics snapshot and a host-counter block;
  * `manifest.json` as the integrity root: per-array CRC32 + shape +
    dtype.  A byte flip or truncation anywhere fails verification;
  * ATOMIC writes: everything lands in a `.tmp-*` sibling, every file is
    fsync'd, then one rename publishes the generation (a crash mid-save
    never clobbers the previous good checkpoint);
  * rolling retention (`TPU_CKPT_KEEP`, default 2) so a corrupt newest
    generation falls back to the previous one.

Resume is BIT-EXACT because the run stream is a pure function of
(`_run_key`, update number) -- ops/update.update_scan folds the update
number into the run key -- so restoring the state, the keys and the
update counter replays the identical trajectory however the run loop
re-chunks the updates.

The generation store (the first half) is numpy only.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib

import numpy as np

MANIFEST = "manifest.json"
FORMAT_VERSION = 1
PREFIX = "ckpt-"


class CheckpointError(RuntimeError):
    """A checkpoint generation failed verification or could not be read."""


class CheckpointMismatchError(CheckpointError):
    """Checkpoint is intact but incompatible with this world's config
    (different grid / memory / instruction-set shape) -- falling back to
    an older generation cannot help, so this is never swallowed."""


class CheckpointManifestError(CheckpointError):
    """manifest.json is torn or unreadable (truncated mid-write by a
    crash, or a JSON decode failure) -- distinguished from a payload CRC
    mismatch so tooling (scripts/ckpt_tool.py --verify) can tell "the
    save died" from "the data rotted".  Recovery is identical: skip the
    generation and fall back."""


# ---------------------------------------------------------------------------
# low-level generation store (pure host / numpy)
# ---------------------------------------------------------------------------

def generation_name(update: int) -> str:
    return f"{PREFIX}{int(update):012d}"


def generation_update(path: str) -> int:
    """Update number encoded in a generation directory name (-1 when the
    name does not carry one).  Works for published `ckpt-*` dirs and the
    crash-window `.old-ckpt-*` asides restore_candidates also scans."""
    name = os.path.basename(path)
    i = name.find(PREFIX)
    if i < 0:
        return -1
    digits = name[i + len(PREFIX):].split(".", 1)[0]
    try:
        return int(digits)
    except ValueError:
        return -1


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def list_generations(base_dir: str) -> list:
    """Paths of all published generations, oldest -> newest."""
    if not os.path.isdir(base_dir):
        return []
    out = [os.path.join(base_dir, d) for d in os.listdir(base_dir)
           if d.startswith(PREFIX)]
    return sorted(out)


def write_generation(base_dir: str, update: int, arrays: dict,
                     host: dict, files: dict | None = None,
                     keep: int = 2, extra: dict | None = None) -> str:
    """Write one checkpoint generation atomically; returns its path.

    arrays: name -> np.ndarray (saved as <name>.npy, CRC'd)
    host:   JSON-able scalar block (stored inside the manifest)
    files:  name -> bytes sidecar blobs (CRC'd like arrays)
    extra:  additional top-level manifest keys (the integrity plane's
            `state_digest`; utils/integrity.py)

    The generation directory only appears (rename) after every byte is
    written and fsync'd; a crash at any earlier point leaves a `.tmp-*`
    sibling that the next save sweeps away.  After publishing, retention
    drops the oldest generations beyond `keep`.
    """
    os.makedirs(base_dir, exist_ok=True)
    final = os.path.join(base_dir, generation_name(update))
    tmp = os.path.join(base_dir,
                       f".tmp-{generation_name(update)}.{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {
        "format": FORMAT_VERSION,
        "update": int(update),
        "saved_at": time.time(),
        "arrays": {},
        "files": {},
        "host": host,
        **(extra or {}),
    }
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        fname = f"{name}.npy"
        fpath = os.path.join(tmp, fname)
        with open(fpath, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["arrays"][name] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc32": _crc32_file(fpath),
        }
    for name, blob in (files or {}).items():
        fpath = os.path.join(tmp, name)
        with open(fpath, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        manifest["files"][name] = {
            "size": len(blob),
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
        }
    mpath = os.path.join(tmp, MANIFEST)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)

    # publish: a same-update re-save replaces the old generation, but the
    # old one is moved ASIDE first and removed only after the rename --
    # a crash at any point leaves either the old or the new generation
    # published (never zero; the aside/tmp siblings are swept next save)
    aside = None
    if os.path.exists(final):
        aside = os.path.join(base_dir,
                             f".old-{generation_name(update)}.{os.getpid()}")
        if os.path.exists(aside):
            shutil.rmtree(aside)
        os.rename(final, aside)
    os.rename(tmp, final)
    _fsync_dir(base_dir)
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)

    # retention + stale tmp/aside sweep
    gens = list_generations(base_dir)
    for old in gens[:-max(int(keep), 1)] if keep else []:
        shutil.rmtree(old, ignore_errors=True)
    for d in os.listdir(base_dir):
        p = os.path.join(base_dir, d)
        if (d.startswith(".tmp-") or d.startswith(".old-")) and p != tmp:
            shutil.rmtree(p, ignore_errors=True)
    return final


def verify_generation(path: str) -> dict:
    """Validate a generation's manifest + every CRC; returns the manifest.
    Raises CheckpointError on any missing/corrupt/truncated piece."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        raise CheckpointError(f"{path}: no {MANIFEST}")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointManifestError(
            f"{path}: torn or unreadable manifest ({e})")
    if manifest.get("format") != FORMAT_VERSION:
        raise CheckpointError(
            f"{path}: unsupported checkpoint format "
            f"{manifest.get('format')!r} (want {FORMAT_VERSION})")
    for name, spec in manifest.get("arrays", {}).items():
        fpath = os.path.join(path, spec["file"])
        if not os.path.exists(fpath):
            raise CheckpointError(f"{path}: missing array file {spec['file']}")
        crc = _crc32_file(fpath)
        if crc != spec["crc32"]:
            raise CheckpointError(
                f"{path}: CRC mismatch on {name} "
                f"({crc:#010x} != {spec['crc32']:#010x})")
    for name, spec in manifest.get("files", {}).items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            raise CheckpointError(f"{path}: missing sidecar {name}")
        if os.path.getsize(fpath) != spec["size"] \
                or _crc32_file(fpath) != spec["crc32"]:
            raise CheckpointError(f"{path}: corrupt sidecar {name}")
    return manifest


def read_generation(path: str) -> tuple:
    """(manifest, arrays, files) with every CRC verified.  Array dtypes
    and shapes are additionally checked against the manifest (a np.save
    header flip that keeps the CRC is impossible, but the belt matches
    the braces)."""
    manifest = verify_generation(path)
    arrays = {}
    for name, spec in manifest["arrays"].items():
        arr = np.load(os.path.join(path, spec["file"]))
        if list(arr.shape) != spec["shape"] or str(arr.dtype) != spec["dtype"]:
            raise CheckpointError(
                f"{path}: array {name} shape/dtype drifted from manifest")
        arrays[name] = arr
    files = {}
    for name in manifest["files"]:
        with open(os.path.join(path, name), "rb") as f:
            files[name] = f.read()
    return manifest, arrays, files


def restore_candidates(base_dir: str) -> list:
    """Generation paths to try on restore, best-first: published
    generations newest-to-oldest, then any `.old-*` aside left by a
    crash inside write_generation's publish window (old generation moved
    aside but the new one not yet renamed in) -- so even that two-rename
    window cannot strand a run without a resumable checkpoint."""
    gens = list(reversed(list_generations(base_dir)))
    if os.path.isdir(base_dir):
        gens += sorted((os.path.join(base_dir, d)
                        for d in os.listdir(base_dir)
                        if d.startswith(".old-")), reverse=True)
    return gens


def quarantine_after(base_dir: str, update: int) -> list:
    """Silent-corruption recovery helper: move every generation saved
    PAST `update` aside to `.bad-*` (invisible to restore_candidates,
    swept later by `ckpt_tool --prune`), so the next resume rolls back
    to the newest generation at or before the last verified update.
    Always leaves at least one generation published -- when every
    generation postdates the verified horizon the OLDEST survives
    (deterministic replay from it is at least self-consistent, and a
    run with zero resumable generations would wedge in exit 66).
    Returns the quarantined paths, newest first."""
    gens = list_generations(base_dir)
    out = []
    for g in reversed(gens):
        if generation_update(g) <= int(update):
            break
        if len(gens) - len(out) <= 1:
            break
        dst = os.path.join(
            base_dir, f".bad-{os.path.basename(g)}.{int(time.time())}")
        try:
            os.rename(g, dst)
            out.append(g)
        except OSError:
            break
    return out


def latest_valid(base_dir: str, on_skip=None) -> tuple:
    """Newest generation that verifies, as (path, manifest).  Corrupt
    generations are skipped newest-to-oldest (on_skip(path, error) is
    called for each).  Raises CheckpointError when none survives."""
    gens = restore_candidates(base_dir)
    if not gens:
        raise CheckpointError(f"no checkpoints under {base_dir!r}")
    last_err = None
    for path in gens:
        try:
            return path, verify_generation(path)
        except CheckpointError as e:
            last_err = e
            if on_skip is not None:
                on_skip(path, e)
    raise CheckpointError(
        f"no valid checkpoint under {base_dir!r} "
        f"({len(gens)} generation(s) all failed; last: {last_err})")


# ---------------------------------------------------------------------------
# World-level save / restore
# ---------------------------------------------------------------------------

_STATE_PREFIX = "state."


def _host_snapshot(world) -> dict:
    """Everything trajectory- or output-relevant that lives on the host:
    update counter, event cursors, the accumulators, the .dat diff
    baselines, the reversion RNG, the telemetry cursor and the flight
    recorder's counters -- the reference's host block, key for key and
    type for type."""
    world._flush_exec()
    host = {
        "update": int(world.update),
        "seed": int(world.cfg.RANDOM_SEED),
        "avida_time": float(world._avida_time),
        "last_ave_gen": float(world._last_ave_gen),
        "deaths_this": int(world._deaths_this),
        "prev_alive": (None if world._prev_alive is None
                       else int(world._prev_alive)),
        "total_births": int(world._total_births),
        "cum_insts": int(world._cum_insts),
        "insts_prev_total": int(world._insts_prev_total),
        "time_prev": int(world._time_prev),
        "last_drain_update": int(world._last_drain_update),
        "events_done_for": world._events_done_for,
        # generation/births event cursors, aligned with world.events order
        # (the live dict is keyed by id(ev), which does not survive a
        # process restart)
        "gen_next": [world._gen_next.get(id(ev)) for ev in world.events],
        "task_exe_prev": (
            np.asarray(world._task_exe_prev, np.int64).tolist()
            if world._task_exe_prev is not None else None),
    }
    if world._revert_on:
        host["revert_rng"] = world._revert_rng.bit_generator.state
    tel = world.telemetry
    if tel is not None and tel._task_prev is not None:
        host["telemetry"] = {
            "task_prev": np.asarray(tel._task_prev, np.int64).tolist(),
            "updates_run": int(tel._updates_run),
        }
    if world.tracer is not None:
        host["tracer"] = world.tracer.to_snapshot()
    return host


def _host_restore(world, host: dict):
    import torch
    f32 = dict(dtype=torch.float32, device=world.device)
    i32 = dict(dtype=torch.int32, device=world.device)
    world.update = int(host["update"])
    world._avida_time = torch.tensor(host["avida_time"], **f32)
    world._last_ave_gen = torch.tensor(host["last_ave_gen"], **f32)
    world._deaths_this = torch.tensor(host["deaths_this"], **i32)
    world._prev_alive = (None if host["prev_alive"] is None
                         else torch.tensor(host["prev_alive"], **i32))
    world._total_births = torch.tensor(host["total_births"],
                                       dtype=torch.int64, device=world.device)
    world._cum_insts = int(host["cum_insts"])
    world._insts_prev_total = int(host["insts_prev_total"])
    world._pending_exec = []
    world._time_prev = int(host["time_prev"])
    world._last_drain_update = int(host["last_drain_update"])
    world._events_done_for = host["events_done_for"]
    world._gen_next = {id(ev): v
                       for ev, v in zip(world.events, host.get("gen_next", []))
                       if v is not None}
    world._nb_pending = None
    world._summary_cache_update = None
    if host.get("task_exe_prev") is not None:
        world._task_exe_prev = np.asarray(host["task_exe_prev"], np.int64)
    if "revert_rng" in host and world._revert_on:
        world._revert_rng.bit_generator.state = host["revert_rng"]
    tel = world.telemetry
    if tel is not None:
        if host.get("telemetry"):
            tel.seed_task_totals(np.asarray(host["telemetry"]["task_prev"],
                                            np.int64))
            tel._updates_run = int(host["telemetry"]["updates_run"])
        # resume continuity: the preempted run's telemetry.jsonl in the
        # same data_dir is appended to, not truncated
        if os.path.exists(os.path.join(world.data_dir, "telemetry.jsonl")):
            tel._log_opened = True
    if world.tracer is not None:
        # the drain counters, and the runlog opened for append
        world.tracer.from_snapshot(host.get("tracer") or {})
        world._trace_pending = None


def key_data(key) -> np.ndarray:
    """A run key (int64[2], two uint32 words) as the reference's
    `jax.random.key_data`: uint32[2]."""
    return key.detach().cpu().numpy().astype(np.uint32)


def save_checkpoint(base_dir: str, world) -> str:
    """Serialize the ENTIRE run state of `world` into a new generation
    under base_dir.  The caller (World.save_checkpoint) drains the
    deferred newborn snapshot first so the systematics snapshot is
    current."""
    from avida_tpu_torch.core.state import state_field_names
    from avida_tpu_torch.utils import integrity

    st = world.state
    if st is None:
        raise CheckpointError("no population state to checkpoint")
    # None-valued fields (the flight-recorder ring, off) have no on-disk
    # representation, as in the reference
    arrays = {_STATE_PREFIX + name: getattr(st, name).detach().cpu().numpy()
              for name in state_field_names()
              if getattr(st, name) is not None}
    arrays["prng.key"] = key_data(world.key)
    arrays["prng.run_key"] = key_data(world._run_key)
    host = _host_snapshot(world)
    files = {}
    if world.systematics is not None:
        files["systematics.json"] = json.dumps(
            world.systematics.to_snapshot()).encode()
    keep = int(world.cfg.get("TPU_CKPT_KEEP", 2))
    extra = None
    if world._digest_on or world._scrub_every:
        # the manifest carries the state digest, recomputed from the very
        # arrays being written: equal to the device digest of the live
        # state (ops/digest.py), and checked again by every resume
        extra = {"state_digest": integrity.digest_arrays(
            integrity.state_arrays_of(arrays))}
    return write_generation(base_dir, world.update, arrays, host,
                            files=files, keep=keep, extra=extra)


def _build_state(world, arrays: dict):
    """Reassemble a PopulationState on the world's device from a
    generation's array dict, checking the field set and the world's
    shape.  A generation written with the flight recorder on (the
    reference's TPU_TRACE) carries the drained trace ring; this package
    runs the recorder off, so the ring is dropped (drained at save, it
    holds nothing)."""
    import torch

    from avida_tpu_torch.core.state import (FIELD_DTYPES, TRACE_RING_FIELDS,
                                            PopulationState,
                                            state_field_names)

    fields = list(state_field_names())
    have = {k[len(_STATE_PREFIX):] for k in arrays
            if k.startswith(_STATE_PREFIX)}
    missing = [f for f in fields if f not in have
               and f not in TRACE_RING_FIELDS]
    extra = sorted(have - set(fields))
    if missing or extra:
        raise CheckpointMismatchError(
            f"checkpoint state fields do not match this build "
            f"(missing {missing[:4]}, unknown {extra[:4]})")
    vals = {}
    for name in fields:
        if name in TRACE_RING_FIELDS:
            vals[name] = None
            continue
        a = arrays[_STATE_PREFIX + name]
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
        if t.dtype != FIELD_DTYPES[name]:
            raise CheckpointMismatchError(
                f"checkpoint field {name!r} has dtype {a.dtype}, this "
                f"build expects {FIELD_DTYPES[name]}")
        # an owned copy on the world's device, never a view of numpy memory
        vals[name] = t.to(world.device)
    st = PopulationState(**vals)
    p = world.params
    if tuple(st.alive.shape) != (p.num_cells,) \
            or tuple(st.tape.shape) != (p.num_cells, p.max_memory):
        raise CheckpointMismatchError(
            f"checkpoint world shape {tuple(st.tape.shape)} does not match "
            f"config ({p.num_cells} cells x {p.max_memory} memory) -- "
            f"resume with the run's original config")
    return st


def _apply(world, manifest: dict, arrays: dict, files: dict):
    from avida_tpu_torch.convert import key_from_data
    from avida_tpu_torch.systematics import GenotypeArbiter

    st = _build_state(world, arrays)
    world.state = st
    world.key = key_from_data(arrays["prng.key"], world.device)
    world._run_key = key_from_data(arrays["prng.run_key"], world.device)
    _host_restore(world, manifest["host"])
    if world.systematics is not None:
        if "systematics.json" in files:
            world.systematics = GenotypeArbiter.from_snapshot(
                json.loads(files["systematics.json"].decode()))
        else:
            # written with systematics off: rebuild an ancestry-free
            # phylogeny from the live population (depth restarts at 0)
            from avida_tpu_torch.observability.runlog import emit_event
            emit_event(world, "checkpoint_no_systematics",
                       detail="rebuilding genotype table from live state; "
                              "phylogenetic depth restarts at 0")
            arb = GenotypeArbiter(world.params.num_cells)
            alive = st.alive.cpu().numpy()
            genomes = st.genome.cpu().numpy()
            lens = st.genome_len.cpu().numpy()
            for c in np.nonzero(alive)[0]:
                arb.classify_seed(int(c), genomes[c, :lens[c]],
                                  update=world.update)
            world.systematics = arb


def restore_checkpoint(base_dir: str, world, at_update: int | None = None
                       ) -> int:
    """Restore `world` from the newest VALID generation under base_dir.

    Corrupt or truncated generations (manifest/CRC failures, a state
    digest that does not recompute) are skipped with an emit_event line,
    falling back to the previous retained one; config-incompatible
    checkpoints raise immediately.  Returns the restored update number.

    at_update pins the restore to the generation saved at that update
    (the batch re-aligns its members on one common update)."""
    from avida_tpu_torch.observability.runlog import emit_event
    from avida_tpu_torch.utils import integrity

    def on_skip(path, err):
        emit_event(world, "checkpoint_corrupt", path=path, error=str(err),
                   detail="falling back to previous retained generation")

    candidates = restore_candidates(base_dir)
    if at_update is not None:
        candidates = [p for p in candidates
                      if generation_update(p) == int(at_update)]
        if not candidates:
            raise CheckpointError(
                f"no generation at update {at_update} under {base_dir!r}")
    last_err = None
    for path in candidates:
        try:
            manifest, arrays, files = read_generation(path)
        except CheckpointMismatchError:
            raise
        except CheckpointError as e:
            last_err = e
            on_skip(path, e)
            continue
        stored = manifest.get("state_digest")
        if stored is not None:
            got = integrity.digest_arrays(integrity.state_arrays_of(arrays))
            if got != int(stored):
                last_err = CheckpointError(
                    f"{path}: state digest mismatch (recomputed "
                    f"{got:#010x} != manifest {int(stored):#010x})")
                emit_event(world, "checkpoint_digest_mismatch", path=path,
                           recomputed=f"{got:#010x}",
                           manifest=f"{int(stored):#010x}",
                           detail="falling back past the generation")
                continue
        _apply(world, manifest, arrays, files)
        emit_event(world, "checkpoint_restored", path=path,
                   update=int(manifest["update"]))
        return int(manifest["update"])
    raise CheckpointError(
        f"no valid checkpoint under {base_dir!r} (last error: {last_err})")
