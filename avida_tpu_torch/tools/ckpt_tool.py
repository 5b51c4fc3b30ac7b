"""Checkpoint directory inspector/verifier/janitor (utils/checkpoint.py).

Counterpart of the reference's scripts/ckpt_tool.py, over the same
on-disk format (a generation either package wrote).  Usage:

    python -m avida_tpu_torch.tools.ckpt_tool <ckpt_dir>
                                  # list generations
    python -m avida_tpu_torch.tools.ckpt_tool <ckpt_dir> --detail
                                  # + census triage column per generation
    python -m avida_tpu_torch.tools.ckpt_tool <ckpt_dir> --verify
                                  # full CRC sweep
    python -m avida_tpu_torch.tools.ckpt_tool <ckpt_dir> --manifest
                                  # dump newest manifest
    python -m avida_tpu_torch.tools.ckpt_tool <ckpt_dir> --prune [--keep N]
                                  # sweep strays + retention overflow
    python -m avida_tpu_torch.tools.ckpt_tool --prune --all ROOT [--keep N]
                                  # one pass over every checkpoint dir
                                  # under ROOT

List mode shows, per generation: update number, save time, array count,
total bytes and a cheap manifest-presence status.  --verify re-reads
every array and sidecar, checking each CRC32 against the manifest -- the
same validation World.resume runs, usable from an ops shell to answer
"can this run be resumed, and from which generation?" without loading
torch or touching the card.  A TORN MANIFEST (truncated mid-write by a
crash: JSON decode failure) is reported distinctly from payload CRC
corruption -- the first means the save died, the second means data
rotted at rest.  Exit status: 0 when at least one generation verifies,
1 otherwise.

--prune removes stranded publish debris (`.tmp-*`, `.bad-*` supervisor
quarantines, and `.old-*` publish asides -- the latter only once a
published generation verifies, because an aside can be the sole
resumable copy after a crash inside the publish window) and any
generation beyond the retention window (--keep N, default TPU_CKPT_KEEP
or 2).  The newest VERIFYING generation is never removed, even when
newer-but-corrupt generations fill the keep window.  Prints every path
it removes; exit 0.

--prune --all walks a whole tree (one checkpoint dir per run under it)
and runs the same sweep on every directory that looks like a checkpoint
dir -- one janitor pass instead of one invocation per run.

--detail appends a triage column sourced from the analytics pipeline's
cheap reader (analyze/pipeline.checkpoint_detail: manifest + two state
arrays + the systematics sidecar, NO Test-CPU evaluation, no torch):
dominant genotype id/units/depth, live organism count and the
tasks-held bitmask.

Nothing here imports torch.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import time


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)
               if os.path.isfile(os.path.join(path, f)))


def verify_status(path: str) -> tuple:
    """(ok, status_line, manifest) for one generation.  Three distinct
    failure vocabularies, because they mean three different things on
    an ops floor: TORN MANIFEST = the save died mid-write, CORRUPT =
    payload bytes rotted at rest (CRC), DIGEST MISMATCH = every byte
    verifies but the state they encode no longer folds to the digest
    the run computed on device -- the loader/at-rest silent-corruption
    class the integrity plane exists for (utils/integrity.py; the
    digest is present when the run had TPU_STATE_DIGEST or
    TPU_SCRUB_EVERY armed)."""
    from avida_tpu_torch.utils.checkpoint import (CheckpointError,
                                                  CheckpointManifestError,
                                                  verify_generation)
    try:
        manifest = verify_generation(path)
    except CheckpointManifestError as e:
        return False, f"TORN MANIFEST -- {e}", None
    except (CheckpointError, OSError) as e:
        return False, f"CORRUPT -- {e}", None
    if manifest.get("state_digest") is not None:
        from avida_tpu_torch.utils.integrity import generation_digest
        try:
            stored, recomputed = generation_digest(path)
        except (OSError, ValueError, KeyError) as e:
            return False, f"DIGEST UNREADABLE -- {e}", None
        if stored != recomputed:
            return False, (f"DIGEST MISMATCH -- recomputed "
                           f"{recomputed:#010x} != manifest "
                           f"{stored:#010x}"), None
        return True, "OK (verified, digest ok)", manifest
    return True, "OK (verified)", manifest


def prune(base: str, keep: int) -> list:
    """Remove stranded `.tmp-*`/`.bad-*` entries, `.old-*` publish
    asides, and published generations beyond the newest `keep`.
    Returns removed paths.

    Safety: an `.old-*` aside can be the ONLY resumable copy -- a crash
    inside write_generation's two-rename publish window leaves the old
    generation moved aside and nothing published, and
    restore_candidates() resumes from exactly that aside.  Asides are
    therefore only swept once at least one PUBLISHED generation
    verifies (the same condition under which the engine's own post-save
    sweep runs)."""
    from avida_tpu_torch.utils.checkpoint import (CheckpointError,
                                                  list_generations,
                                                  verify_generation)
    removed = []
    if not os.path.isdir(base):
        return removed
    newest_valid = None
    for gen in reversed(list_generations(base)):
        try:
            verify_generation(gen)
            newest_valid = gen
            break
        except (CheckpointError, OSError):
            continue
    for d in sorted(os.listdir(base)):
        if d.startswith((".tmp-", ".bad-")) \
                or (d.startswith(".old-") and newest_valid is not None):
            p = os.path.join(base, d)
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    gens = list_generations(base)
    for old in gens[:-max(int(keep), 1)]:
        if old == newest_valid:
            # retention must never delete the only generation a resume
            # can actually use (newer ones may all be corrupt)
            continue
        shutil.rmtree(old, ignore_errors=True)
        removed.append(old)
    return removed


_GEN_ENTRY_RE = re.compile(r"^(\.(tmp|bad|old)-)?ckpt-\d{12}")


def _is_ckpt_entry(name: str) -> bool:
    """A published generation (`ckpt-<12 digits>`) or its publish/
    quarantine debris.  Deliberately strict about the digit format: a
    run DIRECTORY merely named `ckpt-something` must not make its
    parent look like a checkpoint dir (prune would rmtree whole runs as
    'retention overflow')."""
    return _GEN_ENTRY_RE.match(name) is not None


def prune_all(base: str, keep: int) -> dict:
    """Walk `base` and prune every directory that looks like a
    checkpoint dir (published generations or stranded
    `.tmp-*`/`.bad-*`/`.old-*` debris in the engine's naming).  The
    one-pass janitor for a tree of runs, each with its own checkpoint
    dir.  Returns {ckpt_dir: removed_paths}."""
    swept = {}
    for root, dirs, _files in os.walk(base):
        if any(_is_ckpt_entry(d) for d in dirs):
            swept[root] = prune(root, keep)
            dirs[:] = []        # generations hold only files: done here
    return swept


def main(argv=None) -> int:
    from avida_tpu_torch.utils.checkpoint import MANIFEST, list_generations

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("--")]
    if not args:
        print(__doc__)
        return 1
    base = args[0]
    do_verify = "--verify" in argv
    do_manifest = "--manifest" in argv
    do_detail = "--detail" in argv

    if "--all" in argv and "--prune" not in argv:
        print("--all only applies to --prune")
        return 2
    if "--prune" in argv:
        if "--keep" in argv:
            i = argv.index("--keep")
            if i + 1 >= len(argv) or not argv[i + 1].isdigit():
                print("--keep needs an integer argument")
                return 2
            keep = int(argv[i + 1])
            args.remove(argv[i + 1])    # not a directory operand
        else:
            keep = int(os.environ.get("TPU_CKPT_KEEP", 2))
        if not args:
            print(__doc__)
            return 1
        base = args[0]
        if "--all" in argv:
            swept = prune_all(base, keep)
            total = 0
            for ckdir in sorted(swept):
                for p in swept[ckdir]:
                    print(f"pruned {p}")
                total += len(swept[ckdir])
                print(f"{ckdir}: {len(swept[ckdir])} path(s) removed, "
                      f"{len(list_generations(ckdir))} generation(s) "
                      f"kept")
            print(f"{total} path(s) removed across "
                  f"{len(swept)} checkpoint dir(s)")
            return 0
        removed = prune(base, keep)
        for p in removed:
            print(f"pruned {p}")
        print(f"{len(removed)} path(s) removed, "
              f"{len(list_generations(base))} generation(s) kept")
        return 0

    gens = list_generations(base)
    if not gens:
        print(f"no checkpoint generations under {base!r}")
        return 1

    any_ok = False
    for path in gens:
        name = os.path.basename(path)
        if do_verify:
            ok, status, manifest = verify_status(path)
        else:
            try:
                with open(os.path.join(path, MANIFEST)) as f:
                    manifest = json.load(f)
                ok, status = True, "present"
            except (OSError, json.JSONDecodeError) as e:
                ok, status, manifest = False, f"TORN MANIFEST -- {e}", None
        if not ok:
            print(f"{name}: {status}")
            continue
        any_ok = True
        saved = time.strftime("%Y-%m-%d %H:%M:%S",
                              time.localtime(manifest.get("saved_at", 0)))
        detail = ""
        if do_detail and manifest.get("state_digest") is not None:
            detail += f", digest {int(manifest['state_digest']):#010x}"
        if do_detail:
            from avida_tpu_torch.analyze.pipeline import checkpoint_detail
            try:
                d = checkpoint_detail(path)
            except Exception as e:      # triage stays best-effort: a
                d = None                # bad sidecar must not kill list
                detail += f", detail unavailable ({e})"
            if d is not None:
                dom = ("-" if d["dominant_gid"] is None else
                       f"gid {d['dominant_gid']} x{d['dominant_units']} "
                       f"depth {d['dominant_depth']}")
                mask = d["tasks_mask"]
                detail += (f", live {d['live']}, dominant {dom}, tasks "
                           + ("-" if mask is None else
                              f"{mask:#x} ({bin(mask).count('1')})"))
        print(f"{name}: update {manifest.get('update')}, saved {saved}, "
              f"{len(manifest.get('arrays', {}))} arrays, "
              f"{_dir_bytes(path) / 1e6:.2f} MB, {status}{detail}")

    if do_manifest and any_ok:
        for path in reversed(gens):
            if do_verify:
                ok, _, manifest = verify_status(path)
                if not ok:
                    continue
            else:
                try:
                    manifest = json.load(open(os.path.join(path, MANIFEST)))
                except Exception:
                    continue
            print(json.dumps(manifest, indent=1))
            break
    return 0 if any_ok else 1


if __name__ == "__main__":
    sys.exit(main())
