"""Persistent program-cache inspector/verifier/janitor
(utils/compilecache.py -- the ckpt_tool sibling for program-cache roots).
Counterpart of the reference's scripts/cache_tool.py.

Usage:
    python -m avida_tpu_torch.tools.cache_tool DIR            # list entries
    python -m avida_tpu_torch.tools.cache_tool DIR --verify   # CRC sweep
    python -m avida_tpu_torch.tools.cache_tool DIR --prune [--keep N]
                                                       # retention + debris
    python -m avida_tpu_torch.tools.cache_tool --prune --all SPOOL [--keep N]
                                                       # every cache root
                                                       # under a tree

DIR is a cache root (TPU_COMPILE_CACHE_DIR, a fleet's SPOOL/compile-cache,
or avida_tpu_torch/_build by default); the port's entries sit under its
kernels-torch/ subdirectory, so the reference's entries in the same root
are neither listed nor pruned.

List mode shows, per entry: short key, the nvcc release and arch it was
built with, the source-digest prefix, total bytes and age.  Everything
comes from the manifest -- no torch import, no device touch.

--verify re-reads every entry's libcycles.so and ptxas.txt against the
manifest CRC32s -- the integrity half of what ops/cycles.py checks before
it loads a library.  The OTHER half (a stale nvcc release, arch or source
digest) needs the live toolchain and is enforced at load time with a
journaled `compile_cache` event; list mode shows the recorded fields so
an operator can spot a drifted store by eye.  Exit 0 when every entry
verifies, 1 otherwise.

--prune keeps the newest --keep N entries (default 0 = drop all) and
sweeps `.tmp-*`/`.old-*` publish debris; --prune --all walks a tree and
prunes every cache root in it.  The cache is a pure performance artifact
-- pruning can never lose run state, only re-pay an nvcc build.
"""

from __future__ import annotations

import json
import os
import sys
import time

from avida_tpu_torch.utils import compilecache


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n}B"


def _fmt_age(sec: float) -> str:
    if sec < 120:
        return f"{sec:.0f}s"
    if sec < 7200:
        return f"{sec / 60:.0f}m"
    if sec < 172800:
        return f"{sec / 3600:.1f}h"
    return f"{sec / 86400:.1f}d"


def _entry_row(path: str) -> str:
    name = os.path.basename(path)
    try:
        with open(os.path.join(path, compilecache.MANIFEST)) as f:
            m = json.load(f)
    except (OSError, ValueError) as e:
        return f"{name[:12]}  UNREADABLE MANIFEST ({e})"
    size = sum(spec.get("size", 0) for spec in m.get("files", {}).values())
    age = _fmt_age(max(time.time() - float(m.get("created_at", 0)), 0))
    return (f"{name[:12]}  {m.get('tag', '?'):<8} nvcc={m.get('nvcc', '?')}"
            f" arch={m.get('arch', '?')}"
            f" code={str(m.get('code', '?'))[:8]}"
            f" {_fmt_bytes(size):>8}  {age:>6} old")


def list_dir(root: str) -> int:
    entries = compilecache.list_entries(root)
    if not entries:
        print(f"no cache entries under {root!r}")
        return 1
    print(f"{len(entries)} entr{'y' if len(entries) == 1 else 'ies'} "
          f"under {root}:")
    for p in reversed(entries):                  # newest first
        print("  " + _entry_row(p))
    return 0


def verify_dir(root: str) -> int:
    entries = compilecache.list_entries(root)
    if not entries:
        print(f"no cache entries under {root!r}")
        return 1
    bad = 0
    for p in entries:
        try:
            compilecache.verify_entry(p)
            print(f"  OK       {os.path.basename(p)[:16]}")
        except compilecache.CompileCacheError as e:
            bad += 1
            print(f"  CORRUPT  {os.path.basename(p)[:16]}: {e}")
    print(f"{len(entries) - bad}/{len(entries)} entries verify")
    return 0 if bad == 0 else 1


def prune_dir(root: str, keep: int) -> int:
    removed = compilecache.prune(root, keep=keep)
    for p in removed:
        print(f"  removed {p}")
    kept = len(compilecache.list_entries(root))
    print(f"pruned {len(removed)} path(s), kept {kept} under {root}")
    return 0


def prune_all(tree: str, keep: int) -> int:
    """One janitor pass over every cache root under a tree (a fleet
    spool holds one shared SPOOL/compile-cache plus whatever per-job
    roots specs routed)."""
    found = 0
    for dirpath, dirnames, _ in os.walk(tree):
        dirnames[:] = [d for d in dirnames
                       if not d.startswith((".tmp-", ".old-"))]
        if compilecache.looks_like_cache_dir(dirpath):
            found += 1
            prune_dir(dirpath, keep)
            dirnames[:] = []            # entries are leaves; don't recurse
    if not found:
        print(f"no compile-cache dirs under {tree!r}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    keep = 0
    verify = prune = all_mode = False
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--verify":
            verify = True
        elif a == "--prune":
            prune = True
        elif a == "--all":
            all_mode = True
        elif a == "--keep" and i + 1 < len(argv):
            keep = int(argv[i + 1])
            i += 1
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            paths.append(a)
        i += 1
    if len(paths) != 1:
        print(__doc__)
        return 2
    root = paths[0]
    if prune and all_mode:
        return prune_all(root, keep)
    if prune:
        return prune_dir(root, keep)
    if verify:
        return verify_dir(root)
    return list_dir(root)


if __name__ == "__main__":
    sys.exit(main())
