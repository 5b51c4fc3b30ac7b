"""Persistence in the port (utils/checkpoint.py, World.save_checkpoint /
resume, the .dat trims, MultiWorld checkpoints, --resume) against the
reference's (avida_tpu/utils/checkpoint.py and its World).

  * the generation store: the port's write_generation writes the very
    bytes the reference's does (every .npy and sidecar; manifest.json
    apart from saved_at), and the port's copies of the reference's store
    cases (byte flip, truncation, torn or empty manifest, fallback,
    retention, stale tmp, same-update re-save, .dat append and trim);
  * world resumes across the packages on the micro-step engine
    (TPU_USE_PALLAS=2), systematics off and on: a reference generation
    resumed in the port and a port generation resumed in the reference,
    at an update inside a chunk, continue as the reference's
    uninterrupted run -- the state field by field, every .dat byte
    (apart from the header's date line) and the generation written at
    the end (systematics.json included);
  * one kernel-route case (TPU_USE_PALLAS=1, the plain version against
    the reference's interpret mode), two updates after the resume;
  * a W = 3 batch saved and resumed, equal to its uninterrupted run and
    to its members' solo generations;
  * `python -m avida_tpu_torch --device cpu` stopped by SIGTERM and
    continued with --resume.

Tolerance: exact.  The newborn ring's record rows past its cursor are
scratch whose contents depend on where drains fell (a resume re-chunks),
so they are compared only up to nb_count, as the reference's own resume
tests do.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu.utils import checkpoint as rckpt  # noqa: E402

from avida_tpu_torch.utils import checkpoint as ckpt_mod  # noqa: E402
from avida_tpu_torch.utils import output as output_mod  # noqa: E402


# ---------------------------------------------------------------------------
# the generation store
# ---------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(3)
    return {
        "state.a": np.arange(37, dtype=np.int32),
        "state.b": rng.random((5, 9)).astype(np.float32),
        "state.c": rng.integers(0, 2, 64).astype(bool),
        "state.d": rng.integers(-128, 127, (4, 7)).astype(np.int8),
        "state.e": rng.integers(0, 255, (3, 11)).astype(np.uint8),
        "state.f": np.full((), -5, np.int32),
        "prng.key": np.asarray([0, 11], np.uint32),
    }


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    m.pop("saved_at")
    return m


NB_SCRATCH = ("nb_genome", "nb_len", "nb_cell", "nb_parent", "nb_update")


def _assert_same_generation(a, b, rechunked=False):
    """Two generations: the same files byte for byte and the same
    manifest apart from saved_at.  rechunked=True compares a resumed
    run's generation with an uninterrupted run's: the newborn ring's
    record rows only up to the cursor (so not their CRCs or the state
    digest), and not the two host values that depend on where chunks
    fell, in the reference as here: avida_time, a float32 sum of each
    chunk's sum, and events_done_for, the update of the last loop
    iteration."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    skip = {f"state.{n}.npy" for n in NB_SCRATCH} if rechunked else set()
    for name in os.listdir(a):
        if name == "manifest.json":
            continue
        if name in skip:
            cnt = int(np.load(os.path.join(a, "state.nb_count.npy")))
            va = np.load(os.path.join(a, name))
            vb = np.load(os.path.join(b, name))
            assert va.shape == vb.shape and va.dtype == vb.dtype, name
            assert va[:cnt].tobytes() == vb[:cnt].tobytes(), name
            continue
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    ma, mb = _manifest(a), _manifest(b)
    if rechunked:
        for name in skip:
            ma["arrays"][name[:-4]].pop("crc32")
            mb["arrays"][name[:-4]].pop("crc32")
        for m in (ma, mb):
            m.pop("state_digest", None)
            m["host"].pop("avida_time")
            m["host"].pop("events_done_for")
    assert ma == mb


@pytest.mark.parametrize("extra", [None, {"state_digest": 123456789}])
def test_generation_bytes_equal_reference(tmp_path, extra):
    """Same arrays, host block, sidecars and extra keys: the same files,
    byte for byte, and the same manifest apart from saved_at."""
    host = {"update": 12, "avida_time": 1.5, "gen_next": [None, 3.0],
            "prev_alive": None, "events_done_for": 11}
    files = {"systematics.json": b'{"threshold": 3}'}
    a = rckpt.write_generation(str(tmp_path / "r"), 12, _arrays(), host,
                               files=files, keep=2, extra=extra)
    b = ckpt_mod.write_generation(str(tmp_path / "p"), 12, _arrays(), host,
                                  files=files, keep=2, extra=extra)
    assert os.path.basename(a) == os.path.basename(b)
    _assert_same_generation(a, b)


def test_generation_write_verify_roundtrip(tmp_path):
    base = str(tmp_path / "ck")
    arrays = _arrays()
    host = {"update": 12, "avida_time": 1.5, "gen_next": [None, 3.0]}
    path = ckpt_mod.write_generation(base, 12, arrays, host, keep=2)
    assert os.path.basename(path) == "ckpt-000000000012"
    manifest, back, files = ckpt_mod.read_generation(path)
    assert manifest["update"] == 12
    assert manifest["host"] == json.loads(json.dumps(host))
    for name, arr in arrays.items():
        np.testing.assert_array_equal(back[name], arr)
        assert back[name].dtype == arr.dtype
    assert not [d for d in os.listdir(base) if d.startswith(".tmp-")]


def test_byte_flip_detected(tmp_path):
    path = ckpt_mod.write_generation(str(tmp_path / "ck"), 1, _arrays(), {})
    target = os.path.join(path, "state.b.npy")
    blob = bytearray(open(target, "rb").read())
    blob[len(blob) // 2] ^= 0x01
    open(target, "wb").write(bytes(blob))
    with pytest.raises(ckpt_mod.CheckpointError, match="CRC mismatch"):
        ckpt_mod.verify_generation(path)


def test_truncation_detected(tmp_path):
    path = ckpt_mod.write_generation(str(tmp_path / "ck"), 1, _arrays(), {})
    target = os.path.join(path, "state.a.npy")
    blob = open(target, "rb").read()
    open(target, "wb").write(blob[: len(blob) // 2])
    with pytest.raises(ckpt_mod.CheckpointError, match="CRC mismatch"):
        ckpt_mod.verify_generation(path)
    os.remove(target)
    with pytest.raises(ckpt_mod.CheckpointError, match="missing"):
        ckpt_mod.verify_generation(path)


def test_fallback_to_previous_generation(tmp_path):
    base = str(tmp_path / "ck")
    ckpt_mod.write_generation(base, 10, _arrays(), {"u": 10}, keep=3)
    newest = ckpt_mod.write_generation(base, 20, _arrays(), {"u": 20},
                                       keep=3)
    target = os.path.join(newest, "state.c.npy")
    blob = bytearray(open(target, "rb").read())
    blob[-1] ^= 0xFF
    open(target, "wb").write(bytes(blob))
    skipped = []
    path, manifest = ckpt_mod.latest_valid(
        base, on_skip=lambda p, e: skipped.append(p))
    assert manifest["update"] == 10
    assert skipped == [newest]


def test_rolling_retention(tmp_path):
    base = str(tmp_path / "ck")
    for u in (1, 2, 3, 4):
        ckpt_mod.write_generation(base, u, _arrays(), {}, keep=2)
    names = sorted(os.path.basename(p)
                   for p in ckpt_mod.list_generations(base))
    assert names == ["ckpt-000000000003", "ckpt-000000000004"]


def test_stale_tmp_swept(tmp_path):
    base = str(tmp_path / "ck")
    os.makedirs(os.path.join(base, ".tmp-ckpt-000000000099.1234"))
    ckpt_mod.write_generation(base, 5, _arrays(), {}, keep=2)
    assert not [d for d in os.listdir(base) if d.startswith(".tmp-")]


@pytest.mark.parametrize("cut", [3, 0])
def test_resume_falls_back_past_torn_manifest(tmp_path, cut):
    """A manifest.json torn mid-write (to a third, or empty) raises
    CheckpointManifestError and the scan falls back."""
    base = str(tmp_path / "ck")
    good = ckpt_mod.write_generation(base, 10, _arrays(), {"u": 10}, keep=3)
    newest = ckpt_mod.write_generation(base, 20, _arrays(), {"u": 20},
                                       keep=3)
    mpath = os.path.join(newest, ckpt_mod.MANIFEST)
    os.truncate(mpath, os.path.getsize(mpath) // cut if cut else 0)
    with pytest.raises(ckpt_mod.CheckpointManifestError):
        ckpt_mod.verify_generation(newest)
    skipped = []
    path, manifest = ckpt_mod.latest_valid(
        base, on_skip=lambda p, e: skipped.append((p, e)))
    assert path == good and manifest["update"] == 10
    assert [p for p, _ in skipped] == [newest]
    assert isinstance(skipped[0][1], ckpt_mod.CheckpointManifestError)


def test_same_update_resave_keeps_a_recoverable_generation(tmp_path):
    base = str(tmp_path / "ck")
    ckpt_mod.write_generation(base, 7, _arrays(), {"v": 1}, keep=2)
    path = ckpt_mod.write_generation(base, 7, _arrays(), {"v": 2}, keep=2)
    assert ckpt_mod.verify_generation(path)["host"] == {"v": 2}
    assert len(ckpt_mod.list_generations(base)) == 1
    aside = os.path.join(base, ".old-ckpt-000000000007.999")
    os.rename(path, aside)
    assert ckpt_mod.list_generations(base) == []
    found, manifest = ckpt_mod.latest_valid(base)
    assert found == aside and manifest["host"] == {"v": 2}
    ckpt_mod.write_generation(base, 8, _arrays(), {}, keep=2)
    assert not [d for d in os.listdir(base) if d.startswith(".old-")]


def test_quarantine_after_keeps_one(tmp_path):
    base = str(tmp_path / "ck")
    for u in (5, 10, 15):
        ckpt_mod.write_generation(base, u, _arrays(), {}, keep=5)
    moved = ckpt_mod.quarantine_after(base, 5)
    assert [ckpt_mod.generation_update(p) for p in moved] == [15, 10]
    assert [ckpt_mod.generation_update(p)
            for p in ckpt_mod.list_generations(base)] == [5]
    assert ckpt_mod.quarantine_after(base, 0) == []


def test_datfile_append_on_resume(tmp_path):
    path = str(tmp_path / "x.dat")
    f = output_mod.DatFile(path, "T", ["col a"])
    f.write_row([1, 2.5])
    f.close()
    with output_mod.append_existing():
        f2 = output_mod.DatFile(path, "T", ["col a"])
        f2.write_row([2, 3.5])
        f2.close()
        fresh = output_mod.DatFile(str(tmp_path / "y.dat"), "T", ["col a"])
        fresh.close()
    lines = open(path).read().splitlines()
    assert lines.count("# T") == 1
    rows = [ln for ln in lines if ln and not ln.startswith("#")]
    assert rows == ["1 2.5 ", "2 3.5 "]
    assert open(str(tmp_path / "y.dat")).read().startswith("# T")
    f3 = output_mod.DatFile(path, "T", ["col a"])
    f3.close()
    rows = [ln for ln in open(path).read().splitlines()
            if ln and not ln.startswith("#")]
    assert rows == []


def test_trim_stale_rows_on_resume(tmp_path):
    from avida_tpu_torch.observability.runlog import trim_update_records
    d = str(tmp_path)
    with open(os.path.join(d, "average.dat"), "w") as f:
        f.write("# header\n\n5 1.0 \n10 2.0 \n15 3.0 \n20 4.0 \n")
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("15 not a dat file\n")
    output_mod.trim_dat_rows(d, 10)
    rows = [ln.split()[0] for ln in open(os.path.join(d, "average.dat"))
            if ln.strip() and not ln.startswith("#")]
    assert rows == ["5"]
    assert open(os.path.join(d, "notes.txt")).read() == "15 not a dat file\n"
    tj = os.path.join(d, "telemetry.jsonl")
    with open(tj, "w") as f:
        f.write(json.dumps({"record": "meta", "seed": 1}) + "\n")
        f.write(json.dumps({"record": "update", "update": 9}) + "\n")
        f.write(json.dumps({"record": "update", "update": 11}) + "\n")
        f.write('{"record": "update", "upda')
    trim_update_records(tj, 10)
    recs = [json.loads(ln) for ln in open(tj)]
    assert [r.get("update") for r in recs] == [None, 9]
    trim_update_records(os.path.join(d, "missing.jsonl"), 10)


# ---------------------------------------------------------------------------
# worlds: resumes across the packages
# ---------------------------------------------------------------------------

VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5, AVE_TIME_SLICE=100,
            TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0, TPU_CKPT_FINAL=1)
DATS = ("average", "count", "tasks", "time")


def _events(sysm):
    ev = ["u begin InjectAll"] + [f"u 0:4:end Print{d.capitalize()}Data"
                                  for d in DATS]
    return ev + (["u 0:4:end PrintDominantData"] if sysm else [])


def _ref_world(vals, data_dir, ckpt_dir, sysm):
    from avida_tpu.config import AvidaConfig
    from avida_tpu.config.events import parse_event_line
    from avida_tpu.world import World as RefWorld
    cfg = AvidaConfig()
    for k, v in dict(vals, TPU_CKPT_DIR=str(ckpt_dir)).items():
        cfg.set(k, v)
    w = RefWorld(cfg=cfg, data_dir=str(data_dir))
    w.events = [parse_event_line(e) for e in _events(sysm)]
    return w


def _port_world(vals, data_dir, ckpt_dir, sysm):
    from avida_tpu_torch import convert
    from avida_tpu_torch.world import World
    w = World(cfg=convert.config_from_dict(
        dict(vals, TPU_CKPT_DIR=str(ckpt_dir))), data_dir=str(data_dir),
        device="cpu")
    w.events = []
    for e in _events(sysm):
        w.add_event(e)
    return w


def _gen(ckpt_dir, update):
    return os.path.join(str(ckpt_dir), ckpt_mod.generation_name(update))


def _assert_same_dats(a, b):
    names = sorted(f for f in os.listdir(a) if f.endswith(".dat"))
    assert names and names == sorted(f for f in os.listdir(b)
                                     if f.endswith(".dat"))
    for name in names:
        la = open(os.path.join(a, name)).read().splitlines()
        lb = open(os.path.join(b, name)).read().splitlines()
        assert len(la) == len(lb) > 2, name
        assert la[:1] + la[2:] == lb[:1] + lb[2:], name     # dates differ


def _resume_copy(src_data, src_ckpt, dst):
    """A new run directory holding a copy of a stopped run's .dat files
    and checkpoint generations."""
    shutil.copytree(src_data, dst / "dat")
    shutil.copytree(src_ckpt, dst / "ck")
    return dst / "dat", dst / "ck"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STOP, END = 6, 9         # 6 lies inside the uninterrupted run's 4-8


@pytest.mark.parametrize("sysm", [0, 1])
def test_resume_across_packages_micro_step(tmp_path, sysm):
    """TPU_USE_PALLAS=2.  Both packages run 0 -> STOP and write the same
    generation, byte for byte.  The port resumes the reference's
    generation and the reference resumes the port's; both continue to
    END and write the same END generation and .dat files, byte for
    byte, and these equal the reference's uninterrupted 0 -> END run's:
    the state field by field, the keys, systematics.json, the host
    counters and every .dat row."""
    vals = dict(VALS, TPU_USE_PALLAS=2, TPU_SYSTEMATICS=sysm)
    a = _ref_world(vals, tmp_path / "a", tmp_path / "ca", sysm)
    a.run(max_updates=STOP)
    b = _port_world(vals, tmp_path / "b", tmp_path / "cb", sysm)
    b.run(max_updates=STOP)
    assert int(b._total_births) > 0
    assert (b.systematics is not None) == bool(sysm)
    _assert_same_generation(_gen(tmp_path / "ca", STOP),
                            _gen(tmp_path / "cb", STOP))

    # reference generation -> port; port generation -> reference
    dp, cp = _resume_copy(tmp_path / "a", tmp_path / "ca", tmp_path / "p")
    p = _port_world(vals, dp, cp, sysm)
    assert p.resume() == STOP
    p.run(max_updates=END)
    dq, cq = _resume_copy(tmp_path / "b", tmp_path / "cb", tmp_path / "q")
    q = _ref_world(vals, dq, cq, sysm)
    assert q.resume() == STOP
    q.run(max_updates=END)
    _assert_same_generation(_gen(cq, END), _gen(cp, END))
    _assert_same_dats(dq, dp)

    u = _ref_world(vals, tmp_path / "u", tmp_path / "cu", sysm)
    u.run(max_updates=END)
    _assert_same_generation(_gen(tmp_path / "cu", END), _gen(cp, END),
                            rechunked=True)
    _assert_same_dats(tmp_path / "u", dp)


def test_resume_across_packages_kernel_route(tmp_path):
    """TPU_USE_PALLAS=1 (packed engine): the port's generation at update 4
    resumed by the reference (interpret mode) and by the port, two
    updates each: the same update-6 generation, byte for byte."""
    vals = dict(VALS, TPU_USE_PALLAS=1, TPU_SYSTEMATICS=0)
    b = _port_world(vals, tmp_path / "b", tmp_path / "cb", 0)
    b.run(max_updates=4)
    dp, cp = _resume_copy(tmp_path / "b", tmp_path / "cb", tmp_path / "p")
    dq, cq = _resume_copy(tmp_path / "b", tmp_path / "cb", tmp_path / "q")
    p = _port_world(vals, dp, cp, 0)
    assert p.resume() == 4
    p.run(max_updates=6)
    q = _ref_world(vals, dq, cq, 0)
    assert q.resume() == 4
    q.run(max_updates=6)
    _assert_same_generation(_gen(cq, 6), _gen(cp, 6))
    _assert_same_dats(dq, dp)


def test_multiworld_save_resume(tmp_path):
    """A W = 3 batch with per-world checkpoint dirs: each member's
    generation at STOP is byte for byte its solo run's; the batch resumed
    from them (aligned on the common update) continues as the
    uninterrupted batch, member by member."""
    from avida_tpu_torch import convert
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    from avida_tpu_torch.world import World
    vals = dict(VALS, WORLD_X=6, WORLD_Y=6, TPU_USE_PALLAS=1,
                TPU_SYSTEMATICS=1)
    ov = [(k, v) for k, v in vals.items() if k != "RANDOM_SEED"]
    seeds = [1, 2, 3]

    def batch(tag):
        mw = MultiWorld.from_seeds(seeds, overrides=ov,
                                   data_dir=str(tmp_path / tag),
                                   ckpt_dir=str(tmp_path / f"c{tag}"),
                                   device="cpu")
        for w in mw.worlds:
            w.events = []
            for e in _events(1):
                w.add_event(e)
        return mw

    a = batch("a")
    a.run(max_updates=STOP)
    solo = World(cfg=convert.config_from_dict(dict(
        vals, RANDOM_SEED=2, TPU_CKPT_DIR=str(tmp_path / "cs"))),
        data_dir=str(tmp_path / "s"), device="cpu")
    solo.events = []
    for e in _events(1):
        solo.add_event(e)
    solo.run(max_updates=STOP)
    _assert_same_generation(_gen(tmp_path / "cs", STOP),
                            _gen(tmp_path / "ca" / "w001", STOP))

    shutil.copytree(tmp_path / "a", tmp_path / "r")
    shutil.copytree(tmp_path / "ca", tmp_path / "cr")
    r = batch("r")
    assert r.resume() == STOP
    r.run(max_updates=END)
    u = batch("u")
    u.run(max_updates=END)
    for name in r.names:
        _assert_same_generation(_gen(tmp_path / "cu" / name, END),
                                _gen(tmp_path / "cr" / name, END),
                                rechunked=True)
        _assert_same_dats(tmp_path / "u" / name, tmp_path / "r" / name)


def test_resume_cli_after_sigterm(tmp_path):
    """`python -m avida_tpu_torch --device cpu` with TPU_CKPT_DIR, sent
    SIGTERM once its first auto-save is on disk: exit 0 with a final
    generation; `--resume` then runs to the end (TPU_CKPT_FINAL) and its
    end generation and .dat files equal an uninterrupted CLI run's."""
    import signal
    import subprocess
    import sys
    import time

    def cli(data, ck, *extra):
        return [sys.executable, "-m", "avida_tpu_torch", "--device", "cpu",
                "-s", "5", "-d", str(data), "-set", "WORLD_X", "6",
                "-set", "WORLD_Y", "6", "-set", "TPU_SYSTEMATICS", "0",
                "-set", "TPU_CKPT_DIR", str(ck), "-set", "TPU_CKPT_FINAL",
                "1", "-set", "TPU_MAX_STRETCH", "2", *extra]

    env = dict(os.environ, PYTHONPATH=os.getcwd())
    ck = tmp_path / "ck"
    proc = subprocess.Popen(cli(tmp_path / "d", ck, "-u", "400", "-set",
                                "TPU_CKPT_EVERY", "2"),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    t0 = time.time()
    while not ckpt_mod.list_generations(str(ck)):
        assert proc.poll() is None and time.time() - t0 < 120
        time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err.decode()[-2000:]
    rep = json.loads(out.decode().strip().splitlines()[-1])
    assert rep["preempted"] and rep["updates"] < 400
    stop = rep["updates"]
    assert ckpt_mod.generation_update(
        ckpt_mod.list_generations(str(ck))[-1]) == stop
    end = stop + 3
    r = subprocess.run(cli(tmp_path / "d", ck, "-u", str(end), "--resume"),
                       env=env, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert json.loads(r.stdout.decode().splitlines()[-1])["updates"] == end
    r = subprocess.run(cli(tmp_path / "u", tmp_path / "cku", "-u", str(end)),
                       env=env, capture_output=True, timeout=300)
    assert r.returncode == 0
    _assert_same_generation(_gen(tmp_path / "cku", end), _gen(ck, end),
                            rechunked=True)
    _assert_same_dats(tmp_path / "u", tmp_path / "d")


def test_resume_cli_exit_codes(tmp_path):
    """--resume over an empty directory starts fresh (exit 0); over
    generations that all fail verification exits 66."""
    import contextlib
    import io

    from avida_tpu_torch.__main__ import main
    common = ["-u", "2", "-set", "WORLD_X", "4", "-set", "WORLD_Y", "4",
              "-set", "TPU_SYSTEMATICS", "0", "--device", "cpu", "-d",
              str(tmp_path / "d")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(common + ["--resume", str(tmp_path / "none")]) == 0
    ck = tmp_path / "ck"
    path = ckpt_mod.write_generation(str(ck), 1, _arrays(), {})
    os.truncate(os.path.join(path, "manifest.json"), 0)
    with contextlib.redirect_stdout(out):
        assert main(common + ["--resume", str(ck)]) == 66


def test_resume_drops_a_drained_trace_ring_and_refuses_other_shapes(
        tmp_path):
    """A generation written with the flight recorder on (the reference's
    TPU_TRACE: the drained trace ring among the state arrays) resumes
    with the ring dropped; a generation of another world shape raises
    CheckpointMismatchError instead of falling back."""
    vals = dict(VALS, WORLD_X=4, WORLD_Y=4, TPU_USE_PALLAS=2,
                TPU_SYSTEMATICS=0)
    w = _port_world(vals, tmp_path / "d", tmp_path / "ck", 0)
    w.process_events()
    path = w.save_checkpoint()
    manifest, arrays, files = ckpt_mod.read_generation(path)
    cap = 8
    ring = {"state.tr_update": np.zeros(cap, np.int32),
            "state.tr_cell": np.zeros(cap, np.int32),
            "state.tr_code": np.zeros(cap, np.int32),
            "state.tr_payload": np.zeros(cap, np.int32),
            "state.tr_count": np.zeros((), np.int32)}
    ckpt_mod.write_generation(str(tmp_path / "tr"), 0, dict(arrays, **ring),
                              manifest["host"], files=files)
    v = _port_world(vals, tmp_path / "d2", tmp_path / "tr", 0)
    assert v.resume() == 0
    assert v.state.tr_code is None
    assert int(v.state.alive.sum()) == int(w.state.alive.sum())
    big = _port_world(dict(vals, WORLD_X=6), tmp_path / "d3",
                      tmp_path / "ck", 0)
    with pytest.raises(ckpt_mod.CheckpointMismatchError, match="shape"):
        big.resume()
