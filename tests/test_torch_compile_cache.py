"""The port's program cache (avida_tpu_torch/utils/compilecache.py and the
cycle library's load in ops/cycles.py).

Held against the reference's avida_tpu/utils/compilecache.py on the same
inputs, for the host-only plumbing the two share: the kill switch and the
root's resolution over a grid of env and config values, which publish
debris the janitor keeps, which entries a retention prune drops by mtime,
and the names, types and order of the exposition families at equal
counters.  The reference's AOT path (serialized XLA executables) is not
an oracle for the port's library and is not used.

Port-only: this machine has no nvcc and no card, so the build step is a
stand-in compiler writing a dummy library (fixed bytes, BUILDS counted as
nvcc runs are) and the ctypes load is stubbed (it records what it was
given).  The cases: store, verify and load; a flipped byte, a truncation,
a missing file and a torn manifest refused; a changed nvcc release, arch
or source digest refused as stale; a miss, then a hit in a fresh process
with no build; a corrupt or stale entry rebuilt and republished, never
loaded; an unwritable root (it runs and journals store_failed); the cache
off by env and by config (nothing stored, no family); the World's journal
hook into telemetry.jsonl and the exporters' families; a serve child's
cache_loads.

Tolerance: exact (booleans, paths, names, counts, bytes).
"""

import json
import os
import time
import zlib

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu.utils import compilecache as rcc  # noqa: E402
from avida_tpu_torch.ops import cycles  # noqa: E402
from avida_tpu_torch.utils import compilecache as cc  # noqa: E402

LIB_BYTES = bytes(range(256)) * 64          # the stand-in library
RELEASE = "release 12.8, V12.8.93"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Cfg(dict):
    """A config stand-in: the two knobs, read through .get."""


def fresh_process():
    """What a new process starts with: no library, zero counters."""
    cycles._lib = None
    cycles._lib_path = None
    cycles.CACHE_ACTION = None
    cycles.BUILDS = 0
    cc.reset_for_tests()


@pytest.fixture
def fake(monkeypatch):
    """The stand-in compiler and loader; yields the list of (path, bytes)
    the stubbed ctypes load was handed."""
    monkeypatch.delenv("TPU_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("TPU_COMPILE_CACHE_DIR", raising=False)

    def compile_(out_dir):
        cycles.BUILDS += 1
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, cc.LIB_FILE)
        with open(path, "wb") as f:
            f.write(LIB_BYTES)
        with open(os.path.join(out_dir, cc.PTXAS_FILE), "w") as f:
            f.write("ptxas info    : Used 111 registers\n")
        return path

    bound = []

    def bind(path):
        with open(path, "rb") as f:
            bound.append((path, f.read()))
        return object()

    monkeypatch.setattr(cycles, "_compile", compile_)
    monkeypatch.setattr(cycles, "_bind", bind)
    monkeypatch.setattr(cycles, "nvcc_release", lambda: RELEASE)
    monkeypatch.setattr(cycles, "device_arch", lambda: cycles.ARCH)
    fresh_process()
    yield bound
    fresh_process()


def journal():
    events = []
    return events, (lambda **f: events.append(f))


def entry_of(root):
    return cc.entry_path(root, cycles.source_digest())


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

ENV_GRID = [(sw, d) for sw in (None, "0", "1") for d in (None, "/envroot")]


@pytest.mark.parametrize("env_switch,env_dir", ENV_GRID)
def test_enabled_and_cache_dir_equal_reference(monkeypatch, env_switch,
                                               env_dir):
    for name, val in (("TPU_COMPILE_CACHE", env_switch),
                      ("TPU_COMPILE_CACHE_DIR", env_dir)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    cfgs = [None] + [Cfg(TPU_COMPILE_CACHE=on, TPU_COMPILE_CACHE_DIR=d)
                     for on in (0, 1) for d in ("-", "", "/cfgroot")]
    for cfg in cfgs:
        assert cc.enabled(cfg) == rcc.enabled(cfg), cfg
        ref = rcc.cache_dir(cfg)
        got = cc.cache_dir(cfg)
        if ref.endswith(os.path.join("avida_tpu", "compile")):
            # the reference's per-user default is its own
            assert got == cc.DEFAULT_ROOT, cfg
        else:
            assert got == ref, cfg
    assert cc.DEFAULT_ROOT.endswith(os.path.join("avida_tpu_torch",
                                                 "_build"))


def _age(path, sec):
    t = time.time() - sec
    os.utime(path, (t, t))


def test_sweep_debris_keeps_what_the_reference_keeps(tmp_path):
    pid = os.getpid()
    names = {f".tmp-a.{pid}": 0, f".old-a.{pid}": 5000,
             ".tmp-b.1": 10, ".old-b.1": 10, ".tmp-c.2": 7200,
             ".old-c.2": 3700, "entry": 7200, ".hidden": 7200}
    kept = {}
    for which, root in (("ref", tmp_path / "ref"),
                        ("port", tmp_path / "port" / cc.STORE)):
        for n, age in names.items():
            os.makedirs(root / n)
            _age(root / n, age)
        mod = rcc if which == "ref" else cc
        removed = mod._sweep_debris(str(root))
        kept[which] = (sorted(os.listdir(root)),
                       sorted(os.path.basename(p) for p in removed))
    assert kept["port"] == kept["ref"]
    assert ".tmp-b.1" in kept["port"][0] and ".tmp-c.2" not in kept["port"][0]


def _entries(root, names, manifest):
    for age, n in enumerate(names):
        os.makedirs(root / n)
        with open(root / n / "manifest.json", "w") as f:
            json.dump(manifest, f)
        _age(root / n, 100 * (len(names) - age))


@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_prune_drops_what_the_reference_drops(tmp_path, keep):
    names = ["e1", "e2", "e3", "e4"]
    out = {}
    for which, base, store in (
            ("ref", tmp_path / "ref", tmp_path / "ref"),
            ("port", tmp_path / "port", tmp_path / "port" / cc.STORE)):
        mod = rcc if which == "ref" else cc
        _entries(store, names, {"format": mod.FORMAT})
        os.makedirs(store / f".tmp-x.{os.getpid()}")
        assert [os.path.basename(p) for p in mod.list_entries(str(base))] \
            == names
        removed = mod.prune(str(base), keep=keep)
        out[which] = ([os.path.basename(p) for p in removed],
                      sorted(os.listdir(store)),
                      mod.looks_like_cache_dir(str(base)))
    assert out["port"] == out["ref"]


def test_prom_families_equal_reference():
    try:
        assert cc.prom_families() == [] == rcc.prom_families()
        vals = {"hits": 1, "misses": 2, "errors": 1, "load_ms": 12.34,
                "compile_ms": 20012.5, "store_ms": 3.0}
        rcc._counters.update(vals)
        cc._counters.update(vals)
        got, ref = cc.prom_families(), rcc.prom_families()
        assert [f[:2] for f in got] == [f[:2] for f in ref]
        assert [f[3] for f in got] == [f[3] for f in ref]
        assert len(got) == 5
    finally:
        rcc.reset_for_tests()
        cc.reset_for_tests()


# ---------------------------------------------------------------------------
# the port's store and the library's load
# ---------------------------------------------------------------------------

def test_store_verify_and_load(fake, tmp_path):
    root = str(tmp_path / "root")
    events, log = journal()
    path = cycles.build(Cfg(TPU_COMPILE_CACHE_DIR=root), log)
    entry = entry_of(root)
    assert path == os.path.join(entry, cc.LIB_FILE)
    assert fake == [(path, LIB_BYTES)]
    m = cc.verify_entry(entry)
    assert m["key"] == cycles.source_digest() == m["code"]
    assert (m["nvcc"], m["arch"]) == (RELEASE, "sm_90a")
    assert m["flags"] == list(cycles.NVCC_FLAGS)
    assert m["units"] == [[k, list(f)] for k, f in cycles.UNITS]
    assert m["files"][cc.LIB_FILE] == {
        "size": len(LIB_BYTES), "crc32": zlib.crc32(LIB_BYTES)}
    assert set(m["files"]) == {cc.LIB_FILE, cc.PTXAS_FILE}
    assert [e["action"] for e in events] == ["compile", "store"]
    assert {e["tag"] for e in events} == {"cycles"}
    assert cycles.BUILDS == 1 and cycles.CACHE_ACTION == "miss"
    c = cc.counters()
    assert (c["hits"], c["misses"], c["errors"]) == (0, 1, 0)
    assert cycles.resources() == {}        # ptxas.txt read from the entry
    assert [os.path.basename(p) for p in cc.list_entries(root)] \
        == [cycles.source_digest()]
    assert cc.looks_like_cache_dir(root)


def test_miss_then_hit_in_a_fresh_process(fake, tmp_path):
    root = str(tmp_path / "root")
    cycles.load(Cfg(TPU_COMPILE_CACHE_DIR=root))
    fresh_process()
    old = time.time() - 3600
    os.utime(entry_of(root), (old, old))
    events, log = journal()
    cycles.load(Cfg(TPU_COMPILE_CACHE_DIR=root), log)
    assert cycles.BUILDS == 0 and cycles.CACHE_ACTION == "hit"
    assert [e["action"] for e in events] == ["load"]
    assert events[0]["key"] == cycles.source_digest() and events[0]["ms"] >= 0
    assert cc.cache_load_count() == 1 and cc.cache_miss_count() == 0
    assert os.path.getmtime(entry_of(root)) > old + 60    # a load touches
    fams = {f[0]: f[3] for f in cc.prom_families()}
    assert fams["avida_compile_cache_hits_total"] == 1
    assert fams["avida_compile_cache_misses_total"] == 0
    # later callers reuse the loaded library whatever their config
    cycles.load(Cfg(TPU_COMPILE_CACHE=0))
    assert len(fake) == 2 and cycles.BUILDS == 0


def _damage(entry, how):
    lib = os.path.join(entry, cc.LIB_FILE)
    if how == "flip":
        with open(lib, "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0x40]))
    elif how == "truncate":
        with open(lib, "r+b") as f:
            f.truncate(1000)
    elif how == "missing":
        os.remove(os.path.join(entry, cc.PTXAS_FILE))
    elif how == "torn":
        with open(os.path.join(entry, cc.MANIFEST), "w") as f:
            f.write('{"format": "avida-torch-kernel-cache-v1", "fi')
    else:
        with open(os.path.join(entry, cc.MANIFEST)) as f:
            m = json.load(f)
        m[how] = "other"
        with open(os.path.join(entry, cc.MANIFEST), "w") as f:
            json.dump(m, f)


@pytest.mark.parametrize("how", ["flip", "truncate", "missing", "torn"])
def test_damaged_entry_is_refused(fake, tmp_path, how):
    root = str(tmp_path / "root")
    cycles.load(Cfg(TPU_COMPILE_CACHE_DIR=root))
    _damage(entry_of(root), how)
    with pytest.raises(cc.CompileCacheError) as e:
        cc.verify_entry(entry_of(root))
    assert not isinstance(e.value, (cc.CompileCacheMiss,
                                    cc.CompileCacheStale))
    with pytest.raises(cc.CompileCacheError):
        cc.load_entry(root, cycles.source_digest(), cycles.toolchain())


@pytest.mark.parametrize("field", ["nvcc", "arch", "code"])
def test_changed_toolchain_is_stale(fake, tmp_path, field):
    root = str(tmp_path / "root")
    cycles.load(Cfg(TPU_COMPILE_CACHE_DIR=root))
    key = cycles.source_digest()
    cur = cycles.toolchain()
    assert cc.load_entry(root, key, cur) == entry_of(root)
    with pytest.raises(cc.CompileCacheStale) as e:
        cc.load_entry(root, key, dict(cur, **{field: "other"}))
    assert cc._LABELS[field] in str(e.value)
    # a field this process cannot know (no nvcc, no card) is not checked
    assert cc.load_entry(root, key, dict(cur, **{field: None})) \
        == entry_of(root)


@pytest.mark.parametrize("how,action", [("flip", "corrupt"),
                                        ("truncate", "corrupt"),
                                        ("torn", "corrupt"),
                                        ("nvcc", "stale"),
                                        ("arch", "stale")])
def test_bad_entry_is_rebuilt_and_republished(fake, tmp_path, how, action):
    root = str(tmp_path / "root")
    cycles.load(Cfg(TPU_COMPILE_CACHE_DIR=root))
    _damage(entry_of(root), how)
    fresh_process()
    fake.clear()
    events, log = journal()
    path = cycles.build(Cfg(TPU_COMPILE_CACHE_DIR=root), log)
    assert [e["action"] for e in events] == [action, "compile", "store"]
    assert events[0]["error"]
    assert cycles.BUILDS == 1 and cycles.CACHE_ACTION == "rebuilt"
    c = cc.counters()
    assert (c["hits"], c["misses"], c["errors"]) == (0, 1, 1)
    # only the fresh build was ever loaded, from the republished entry
    assert fake == [(path, LIB_BYTES)]
    assert path == os.path.join(entry_of(root), cc.LIB_FILE)
    cc.verify_entry(entry_of(root))
    assert not [d for d in os.listdir(cc.store_path(root))
                if d.startswith((".tmp-", ".old-"))]


def test_unwritable_root_still_runs(fake, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    root = str(blocker / "root")
    events, log = journal()
    path = cycles.build(Cfg(TPU_COMPILE_CACHE_DIR=root), log)
    assert [e["action"] for e in events] == ["compile", "store_failed"]
    assert cycles.BUILDS == 1 and cycles.CACHE_ACTION == "store_failed"
    assert fake == [(path, LIB_BYTES)]
    assert not path.startswith(str(tmp_path))      # the private build
    assert cc.counters()["errors"] == 1


@pytest.mark.parametrize("by", ["env", "config"])
def test_cache_off_reads_and_stores_nothing(fake, tmp_path, monkeypatch,
                                            by):
    root = tmp_path / "root"
    # an entry that would hit, were the store read
    cycles.load(Cfg(TPU_COMPILE_CACHE_DIR=str(root)))
    before = {p: os.path.getmtime(p) for p in cc.list_entries(str(root))}
    fresh_process()
    fake.clear()
    cfg = Cfg(TPU_COMPILE_CACHE_DIR=str(root))
    if by == "env":
        monkeypatch.setenv("TPU_COMPILE_CACHE", "0")
    else:
        cfg["TPU_COMPILE_CACHE"] = 0
    events, log = journal()
    path = cycles.build(cfg, log)
    assert events == [] and cycles.CACHE_ACTION == "off"
    assert cycles.BUILDS == 1 and fake == [(path, LIB_BYTES)]
    assert not path.startswith(str(root))
    assert cc.counters() == {"hits": 0, "misses": 0, "errors": 0,
                             "load_ms": 0.0, "compile_ms": 0.0,
                             "store_ms": 0.0}
    assert cc.prom_families() == []
    assert {p: os.path.getmtime(p)
            for p in cc.list_entries(str(root))} == before


def test_write_entry_leaves_an_equal_sibling(tmp_path):
    root = str(tmp_path)
    meta = {"nvcc": RELEASE, "arch": "sm_90a", "flags": [], "units": [],
            "code": "abc"}
    files = {cc.LIB_FILE: b"one"}
    first = cc.write_entry(root, "k", files, meta)
    created = cc.verify_entry(first)["created_at"]
    assert cc.write_entry(root, "k", {cc.LIB_FILE: b"two"}, meta) == first
    assert cc.verify_entry(first)["created_at"] == created
    cc.write_entry(root, "k", {cc.LIB_FILE: b"two"}, dict(meta, nvcc="x"))
    m = cc.verify_entry(first)
    assert m["nvcc"] == "x" and m["files"][cc.LIB_FILE]["size"] == 3


@pytest.mark.parametrize("theirs", ["intact", "corrupt"])
def test_write_entry_after_a_sibling_published_meanwhile(tmp_path,
                                                          monkeypatch,
                                                          theirs):
    """Siblings that built together publish moments apart: one that lands
    its entry while this publish writes its .tmp- sibling wins if it is
    intact (no failed rename onto it, no swap under a loader) and is
    replaced if it is corrupt."""
    root, other = str(tmp_path / "root"), str(tmp_path / "other")
    meta = {"nvcc": RELEASE, "arch": "sm_90a", "flags": [], "units": [],
            "code": "abc"}
    final = cc.entry_path(root, "k")
    real, landed = cc._fsync_dir, []

    def sibling_lands(path):
        real(path)
        if os.path.basename(path).startswith(".tmp-") and not landed:
            landed.append(path)
            sib = cc.write_entry(other, "k", {cc.LIB_FILE: LIB_BYTES}, meta)
            if theirs == "corrupt":
                _damage(sib, "flip")
            os.rename(sib, final)

    monkeypatch.setattr(cc, "_fsync_dir", sibling_lands)
    ours = LIB_BYTES[::-1]
    assert cc.write_entry(root, "k", {cc.LIB_FILE: ours}, meta) == final
    with open(os.path.join(final, cc.LIB_FILE), "rb") as f:
        assert f.read() == (LIB_BYTES if theirs == "intact" else ours)
    cc.verify_entry(final)
    assert sorted(os.listdir(cc.store_path(root))) == [cc.LOCK_FILE, "k"]


def _publish_at_once(root, barrier, blob, meta):
    barrier.wait()
    cc.write_entry(root, "k", {cc.LIB_FILE: blob}, meta)


def test_concurrent_publishers_leave_one_intact_entry(tmp_path):
    import multiprocessing
    root = str(tmp_path)
    meta = {"nvcc": RELEASE, "arch": "sm_90a", "flags": [], "units": [],
            "code": "abc"}
    ctx = multiprocessing.get_context("fork")
    barrier = ctx.Barrier(4)
    procs = [ctx.Process(target=_publish_at_once,
                         args=(root, barrier, bytes([n]) * 4096, meta))
             for n in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
    assert [p.exitcode for p in procs] == [0] * 4
    entry = cc.entry_path(root, "k")
    assert cc.verify_entry(entry)["files"][cc.LIB_FILE]["size"] == 4096
    assert cc.list_entries(root) == [entry]
    assert sorted(os.listdir(cc.store_path(root))) == [cc.LOCK_FILE, "k"]


# ---------------------------------------------------------------------------
# the World's journal hook, the exporters, a serve child
# ---------------------------------------------------------------------------

def _cpu_world(data_dir, **over):
    from avida_tpu_torch.world import World
    base = dict(WORLD_X=4, WORLD_Y=4, RANDOM_SEED=3, TPU_SYSTEMATICS=0)
    base.update(over)
    return World(overrides=list(base.items()), data_dir=str(data_dir),
                 device="cpu")


def test_world_journals_into_telemetry_and_exports_families(
        fake, tmp_path, monkeypatch):
    root = tmp_path / "root"
    w = _cpu_world(tmp_path / "d", TPU_TELEMETRY=1, TPU_METRICS=1,
                   TPU_COMPILE_CACHE_DIR=str(root))
    w.run(max_updates=1)
    assert cc.prom_families() == []
    with open(tmp_path / "d" / "metrics.prom") as f:
        assert "avida_compile_cache" not in f.read()
    # the card's route: the first update reaches the kernel
    monkeypatch.setattr(w, "device", torch.device("cuda"))
    w._kernel_checked = False
    w._load_kernel()
    monkeypatch.undo()
    assert cycles.CACHE_ACTION == "miss" and len(fake) == 1
    w.run(max_updates=2)
    recs = [json.loads(line) for line in
            open(tmp_path / "d" / "telemetry.jsonl")]
    got = [r["action"] for r in recs if r.get("event") == "compile_cache"]
    assert got == ["compile", "store"]
    with open(tmp_path / "d" / "metrics.prom") as f:
        text = f.read()
    assert "avida_compile_cache_misses_total 1" in text
    assert "avida_compile_cache_hits_total 0" in text


def test_serve_child_counts_cache_loads(fake, tmp_path, capsys):
    from avida_tpu_torch.__main__ import main
    root = str(tmp_path / "root")
    cycles.load(Cfg(TPU_COMPILE_CACHE_DIR=root))
    fresh_process()
    cycles.load(Cfg(TPU_COMPILE_CACHE_DIR=root))     # a warm child's hit
    d = tmp_path
    with open(d / "ctl.json", "w") as f:
        json.dump({"width": 2, "shutdown": True, "members": [
            {"name": "t", "seed": 3, "data_dir": str(d / "t"),
             "ckpt_dir": str(d / "ck"), "max_updates": 2}]}, f)
    rc = main(["--serve-worlds", str(d / "ctl.json"), "-set", "WORLD_X",
               "4", "-set", "WORLD_Y", "4", "-set", "TPU_CKPT_EVERY", "2",
               "-set", "TPU_METRICS", "1", "-set", "TPU_SYSTEMATICS", "0",
               "--device", "cpu", "-d", str(d / "batch")])
    assert rc == 0
    with open(d / "batch" / "serve.json") as f:
        st = json.load(f)
    assert (st["cache_loads"], st["compiles"]) == (1, 0)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (summary["cache_hits"], summary["cache_misses"],
            summary["builds"]) == (1, 0, 0)
    with open(d / "batch" / "metrics.prom") as f:
        assert "avida_compile_cache_hits_total 1" in f.read()
