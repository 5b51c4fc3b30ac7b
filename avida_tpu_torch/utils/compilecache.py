"""Persistent program cache: the cycle library in a verified on-disk store.

Counterpart of avida_tpu/utils/compilecache.py.  The reference stores
serialized XLA executables, one per program shape; this package compiles
one program, the cycle kernels' shared library (ops/cycles.py: csrc/*.cu
built by nvcc), and that library serves every world shape, chunk length
and serve width.  So an entry is keyed by `cycles.source_digest()` alone
(the sources, the flags and the compilation units), and a cold child that
finds its sibling's entry loads it in milliseconds instead of paying the
nvcc build.

The store keeps the reference's discipline:

  * every entry is published atomically (a `.tmp-*` sibling, fsync, one
    rename) with a manifest of per-file sizes and CRC32s -- a flipped
    byte, a truncation or a torn publish fails verification, is
    journaled as a `compile_cache` event and rebuilt; a corrupt library
    is never loaded;
  * an intact entry built by another toolchain (another nvcc release,
    another arch, other flags or units, another source digest) is
    refused as stale, journaled and rebuilt;
  * `TPU_COMPILE_CACHE=0` (env var or config var -- either kills) turns
    the store off: every process builds into a private temporary
    directory, reads nothing, stores nothing, and the counters stay at 0.

Layout: `<root>/kernels-torch/<key>/{libcycles.so, ptxas.txt,
manifest.json}`.  The port's entries sit in their own subdirectory, so a
root (a fleet's SPOOL/compile-cache) can hold both packages' stores and
neither package's list_entries / --verify / --prune sees the other's.
The root resolves as config TPU_COMPILE_CACHE_DIR, then the env var, then
this package's `_build/` directory (the reference's default is
~/.cache/avida_tpu/compile).

Nothing here imports torch: tools/cache_tool.py lists, verifies and
prunes a store from an operator's shell.  ops/cycles.py drives the build
and the load, and checks the device's arch.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import shutil
import time
import zlib

from avida_tpu_torch.utils.checkpoint import _crc32_file, _fsync_dir

MANIFEST = "manifest.json"
LIB_FILE = "libcycles.so"
PTXAS_FILE = "ptxas.txt"
LOCK_FILE = ".lock"      # in the store: write_entry's publish lock
FORMAT = "avida-torch-kernel-cache-v1"
STORE = "kernels-torch"
DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


class CompileCacheError(RuntimeError):
    """An entry failed verification (truncated/corrupt/unreadable)."""


class CompileCacheMiss(CompileCacheError):
    """No entry at this key: the ordinary cold path."""


class CompileCacheStale(CompileCacheError):
    """An intact entry built by another toolchain or source version:
    refused, journaled, then overwritten by the fresh build."""


# ---------------------------------------------------------------------------
# process-level counters (the observability side)
# ---------------------------------------------------------------------------

_counters = {
    "hits": 0,                  # libraries loaded from a verified entry
    "misses": 0,                # libraries built fresh (entry absent)
    "errors": 0,                # corrupt/stale/store-failure fallbacks
    "load_ms": 0.0,
    "compile_ms": 0.0,
    "store_ms": 0.0,
}


def cache_load_count() -> int:
    """Libraries this process loaded from the store (0 or 1: one library
    a process) -- a serve child's `cache_loads`."""
    return _counters["hits"]


def cache_miss_count() -> int:
    return _counters["misses"]


def counters() -> dict:
    return dict(_counters)


def record(field: str, amount=1):
    """Add to one counter (ops/cycles.py's hook)."""
    _counters[field] += amount


def reset_for_tests():
    """Clear the counters (tests simulate a fresh process)."""
    for k in _counters:
        _counters[k] = 0 if isinstance(_counters[k], int) else 0.0


def prom_families() -> list:
    """The avida_compile_cache_* exposition families, render_families
    shaped, in the reference's names, types and order.  Empty when the
    process never touched the store, so runs with the cache off publish
    byte-identical metrics files."""
    c = _counters
    if not (c["hits"] or c["misses"] or c["errors"]):
        return []
    return [
        ("avida_compile_cache_hits_total", "counter",
         "cycle libraries loaded from the persistent compile cache",
         c["hits"]),
        ("avida_compile_cache_misses_total", "counter",
         "cycle libraries built fresh by nvcc (cache entry absent)",
         c["misses"]),
        ("avida_compile_cache_errors_total", "counter",
         "corrupt/stale/store-failure fallbacks (each journaled as a "
         "compile_cache event)", c["errors"]),
        ("avida_compile_cache_load_ms_total", "counter",
         "milliseconds spent verifying and loading cached libraries",
         round(c["load_ms"], 1)),
        ("avida_compile_cache_compile_ms_total", "counter",
         "milliseconds spent in fresh nvcc builds on cache misses",
         round(c["compile_ms"], 1)),
    ]


# ---------------------------------------------------------------------------
# configuration: kill switch + cache root resolution
# ---------------------------------------------------------------------------

def enabled(cfg=None) -> bool:
    """TPU_COMPILE_CACHE=0 anywhere -- environment OR config -- is a
    hard kill switch; the cache is on only when neither side disables
    it (config default 1)."""
    if os.environ.get("TPU_COMPILE_CACHE", "1") == "0":
        return False
    if cfg is not None and not int(cfg.get("TPU_COMPILE_CACHE", 1)):
        return False
    return True


def cache_dir(cfg=None) -> str:
    """Config TPU_COMPILE_CACHE_DIR beats env beats this package's
    `_build/`.  The fleet orchestrator points children at
    SPOOL/compile-cache so sibling children share one store."""
    if cfg is not None:
        d = str(cfg.get("TPU_COMPILE_CACHE_DIR", "-") or "-")
        if d not in ("-", ""):
            return d
    d = os.environ.get("TPU_COMPILE_CACHE_DIR", "")
    if d:
        return d
    return DEFAULT_ROOT


# ---------------------------------------------------------------------------
# the on-disk entry store
# ---------------------------------------------------------------------------

def store_path(root: str) -> str:
    """The port's store under a cache root."""
    return os.path.join(root, STORE)


def entry_path(root: str, key: str) -> str:
    return os.path.join(store_path(root), key)


def list_entries(root: str) -> list:
    """Paths of all published entries under one cache root, sorted
    oldest-first by mtime."""
    store = store_path(root)
    if not os.path.isdir(store):
        return []
    out = []
    for name in os.listdir(store):
        p = os.path.join(store, name)
        if name.startswith((".tmp-", ".old-")) or not os.path.isdir(p):
            continue
        if os.path.exists(os.path.join(p, MANIFEST)):
            out.append(p)
    return sorted(out, key=lambda p: (os.path.getmtime(p), p))


# the manifest fields that decide whether an existing same-key entry is
# EQUIVALENT to what is about to be published (write_entry's skip test)
# -- the same set _verify_toolchain enforces at load time
TOOLCHAIN_FIELDS = ("nvcc", "arch", "flags", "units", "code")


def write_entry(root: str, key: str, files: dict, meta: dict) -> str:
    """Atomically publish one entry ({name: bytes} plus the toolchain
    fields in `meta`): tmp sibling, fsync everything, one rename.  A
    same-key entry that already verifies AND matches this publish's
    toolchain fields is left untouched -- two sibling children building
    concurrently is the normal fleet warm-up, and yanking the winner's
    entry from under a third child mid-load would journal a false
    corruption.  Corrupt or stale entries are replaced."""
    store = store_path(root)
    os.makedirs(store, exist_ok=True)
    final = entry_path(root, key)
    if _equivalent(final, meta):
        return final                    # a sibling already published it
    tmp = os.path.join(store, f".tmp-{key}.{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "format": FORMAT,
        "key": key,
        "created_at": time.time(),
        "files": {},
        **meta,
    }
    for name, blob in files.items():
        fpath = os.path.join(tmp, name)
        with open(fpath, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        manifest["files"][name] = {
            "size": len(blob),
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
        }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    # the second look and the swap hold the store's lock: siblings that
    # built together finish their nvcc within moments of each other, and
    # the one that publishes second must neither fail its rename onto the
    # first one's entry nor move that intact entry aside while the first
    # one loads it
    with _publish_lock(store):
        if _equivalent(final, meta):
            shutil.rmtree(tmp, ignore_errors=True)
            return final
        aside = None
        if os.path.exists(final):
            aside = os.path.join(store, f".old-{key}.{os.getpid()}")
            if os.path.exists(aside):
                shutil.rmtree(aside)
            os.rename(final, aside)
        os.rename(tmp, final)
        _fsync_dir(store)
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)
    _sweep_debris(store)
    return final


def _equivalent(path: str, meta: dict) -> bool:
    """Does the entry at `path` verify and carry `meta`'s toolchain
    fields (write_entry's skip test)?"""
    if not os.path.isdir(path):
        return False
    try:
        existing = verify_entry(path)
    except CompileCacheError:
        return False                    # corrupt/foreign: replaced
    return all(existing.get(f) == meta.get(f) for f in TOOLCHAIN_FIELDS)


@contextlib.contextmanager
def _publish_lock(store: str):
    """The store's publish lock (an flock on `store/.lock`): one
    publisher at a time decides whether to swap its entry in.  Loads
    take no lock; an intact entry is never swapped out under them."""
    with open(os.path.join(store, LOCK_FILE), "a") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)


# another process's in-flight .tmp- entry must survive the janitor: the
# fleet points every child at one SPOOL/compile-cache.  Own-pid debris
# is always stale (swept only after our own publish); foreign debris
# only once it is old enough that its writer is surely dead or wedged.
_DEBRIS_MAX_AGE_SEC = 3600.0


def _sweep_debris(store: str) -> list:
    removed = []
    mine = f".{os.getpid()}"
    now = time.time()
    for d in os.listdir(store):
        if not d.startswith((".tmp-", ".old-")):
            continue
        p = os.path.join(store, d)
        if not d.endswith(mine):
            try:
                if now - os.path.getmtime(p) < _DEBRIS_MAX_AGE_SEC:
                    continue            # possibly another writer, live
            except OSError:
                continue
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    return removed


def verify_entry(path: str) -> dict:
    """Manifest + CRC sweep of one entry; returns the manifest.
    Raises CompileCacheError on any missing/truncated/corrupt piece."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        raise CompileCacheError(f"{path}: no {MANIFEST}")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CompileCacheError(f"{path}: torn or unreadable manifest ({e})")
    if not isinstance(manifest, dict):
        raise CompileCacheError(f"{path}: torn manifest (not an object)")
    if manifest.get("format") != FORMAT:
        raise CompileCacheStale(
            f"{path}: entry format {manifest.get('format')!r} "
            f"(want {FORMAT})")
    files = manifest.get("files", {})
    if LIB_FILE not in files:
        raise CompileCacheError(f"{path}: manifest lists no {LIB_FILE}")
    for name, spec in files.items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            raise CompileCacheError(f"{path}: missing {name}")
        if os.path.getsize(fpath) != spec["size"]:
            raise CompileCacheError(f"{path}: truncated {name}")
        crc = _crc32_file(fpath)
        if crc != spec["crc32"]:
            raise CompileCacheError(
                f"{path}: CRC mismatch on {name} "
                f"({crc:#010x} != {spec['crc32']:#010x})")
    return manifest


_LABELS = {"nvcc": "nvcc release", "arch": "arch", "flags": "nvcc flags",
           "units": "compilation units", "code": "source digest"}


def _verify_toolchain(path: str, manifest: dict, current: dict):
    """The loud invalidation gate: refuse an intact entry whose toolchain
    fields differ from `current` (the running process's: ops/cycles.
    toolchain).  A field `current` cannot know (None: no nvcc on the
    path, no device to ask) is not checked."""
    for field in TOOLCHAIN_FIELDS:
        have = current.get(field)
        if have is None:
            continue
        want = manifest.get(field)
        if want != have:
            raise CompileCacheStale(
                f"{path}: stale {_LABELS[field]} ({want!r} != {have!r})")


def load_entry(root: str, key: str, current: dict) -> str:
    """The path of one verified, toolchain-current entry, its mtime
    refreshed (prune keeps the most recently USED entries).  Raises
    CompileCacheMiss, CompileCacheError or CompileCacheStale."""
    path = entry_path(root, key)
    if not os.path.isdir(path):
        raise CompileCacheMiss(f"{path}: no entry")
    manifest = verify_entry(path)
    _verify_toolchain(path, manifest, current)
    try:
        os.utime(path)
    except OSError:
        pass
    return path


def prune(root: str, keep: int = 0) -> list:
    """Drop entries beyond the newest `keep` (0 = drop all), plus stale
    .tmp-/.old- publish debris (through _sweep_debris's live-writer age
    guard).  "Newest" is by directory mtime, which load_entry refreshes.
    Returns removed paths."""
    removed = []
    store = store_path(root)
    if not os.path.isdir(store):
        return removed
    entries = list_entries(root)
    drop = entries if keep <= 0 else entries[:-keep]
    for p in drop:
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    removed += _sweep_debris(store)
    return removed


def looks_like_cache_dir(path: str) -> bool:
    """Does `path` hold at least one of the port's entries (under its
    kernels-torch store)?  cache_tool --all's tree-walk screen."""
    store = store_path(path)
    if not os.path.isdir(store):
        return False
    for name in os.listdir(store):
        mpath = os.path.join(store, name, MANIFEST)
        try:
            if os.path.exists(mpath):
                with open(mpath) as f:
                    if json.load(f).get("format") == FORMAT:
                        return True
        except (OSError, ValueError, AttributeError):
            continue
    return False


def note(log, **fields):
    """Journal one cache action through `log(**fields)` (World /
    ServeBatch pass a runlog emit_event shim); never raises."""
    if log is None:
        return
    try:
        log(**fields)
    except Exception:
        pass
