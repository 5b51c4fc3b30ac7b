"""analyze/pipeline.py (checkpoint analytics), TPU_ANALYTICS and
`python -m avida_tpu_torch -a / --analyze` against the reference's
avida_tpu/analyze/pipeline.py and avida_tpu/__main__.py.

A 6x6 world of five injected ancestors (systematics on, the micro-step
engine, TPU_USE_PALLAS 2) runs 8 updates with TPU_ANALYTICS=1,
checkpoints every 4 updates and at the end, in each package, plus a port
run with TPU_ANALYTICS=0.  Both packages' Test CPU is replaced by one
shared numpy stand-in (test_torch_analyze.stand_in) for the whole
module, so the census, the knockout sweeps and the lineage replay cost
no sandbox gestations; the stand-in is a function of the genome alone,
so what differs between the packages is their own pipeline code.  The
true Test CPU is held to the reference in test_torch_testcpu.py.

  * the live analytics journal and analytics.prom equal the reference's
    (apart from wall-clock times), and the trajectory with analytics on
    equals the one with it off, field by field;
  * `--analyze CKPT_DIR` over the reference-written checkpoints (and over
    a copy whose newest generation is corrupt, where both fall back to
    the previous one) writes census.dat, knockout.dat and lineage.dat
    equal byte for byte (date line pinned), the same journal record and
    the same summary;
  * bare `-a` runs ANALYZE_FILE; a CKPT_DIR that is not a directory
    exits 2.

Tolerance: exact.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import avida_tpu.analyze.testcpu as rtestcpu  # noqa: E402
from avida_tpu.__main__ import main as ref_main  # noqa: E402
from avida_tpu.analyze import pipeline as rpl  # noqa: E402
from avida_tpu.config import AvidaConfig  # noqa: E402
from avida_tpu.core.state import state_field_names  # noqa: E402
from avida_tpu.world import World as RefWorld  # noqa: E402

import avida_tpu_torch.analyze.testcpu as ttestcpu  # noqa: E402
from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.__main__ import main as port_main  # noqa: E402
from avida_tpu_torch.analyze import pipeline as tpl  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

from test_torch_analyze import stand_in  # noqa: E402
from test_torch_placement import assert_states_equal  # noqa: E402

VALS = dict(WORLD_X=6, WORLD_Y=6, TPU_MAX_MEMORY=200, RANDOM_SEED=3,
            AVE_TIME_SLICE=100, TPU_USE_PALLAS=2, TPU_CKPT_EVERY=4,
            TPU_CKPT_FINAL=1, TPU_CKPT_AUDIT=0,
            TPU_ANALYTICS_KNOCKOUT_TOP=2, TPU_MAX_STRETCH=4)
SEEDS = (10, 11, 20, 21, 27)
CLI_SET = ["-set", "WORLD_X", "6", "-set", "WORLD_Y", "6",
           "-set", "AVE_TIME_SLICE", "100"]
# per-record fields that are wall-clock readings
CLOCK = ("time", "census_ms", "knockout_ms", "lineage_ms")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _stand_in():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (rtestcpu, ttestcpu):
            mp.setattr(mod, "evaluate_genomes", stand_in)
        mp.setattr(time, "asctime", lambda *a: "Thu Jan  1 00:00:00 1970")
        yield


def _run(make, tmp, analytics):
    vals = dict(VALS, TPU_ANALYTICS=analytics,
                TPU_CKPT_DIR=os.path.join(tmp, "ck"))
    w = make(vals, os.path.join(tmp, "data"))
    w.events = []
    for c in SEEDS:
        w.inject(cell=c)
    w.run(max_updates=8)
    return w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")

    def ref_world(vals, data):
        cfg = AvidaConfig()
        for k, v in vals.items():
            cfg.set(k, v)
        return RefWorld(cfg=cfg, data_dir=data)

    def port_world(vals, data):
        return World(cfg=convert.config_from_dict(vals), data_dir=data,
                     device="cpu")

    return {"ref": _run(ref_world, str(tmp / "ref"), 1),
            "on": _run(port_world, str(tmp / "on"), 1),
            "off": _run(port_world, str(tmp / "off"), 0),
            "tmp": tmp}


def _journal(path):
    recs = [json.loads(ln) for ln in open(path)]
    for r in recs:
        for k in CLOCK:
            r.pop(k)
    return recs


def _prom(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("avida_analytics_heartbeat_timestamp")]


def test_live_analytics_equals_reference(runs):
    """TPU_ANALYTICS=1: the port's trajectory, journal (three censuses:
    updates 4 and 8 and the exit) and analytics.prom equal the
    reference's."""
    ref, on = runs["ref"], runs["on"]
    assert_states_equal(ref.state, on.state, "analytics on")
    a = _journal(os.path.join(ref.data_dir, "analysis", "analytics.jsonl"))
    b = _journal(os.path.join(on.data_dir, "analysis", "analytics.jsonl"))
    assert a == b and [r["update"] for r in b] == [4, 8, 8]
    assert b[-1]["genotypes"] > 1 and b[-1]["knockout_sweeps"] >= 1
    assert _prom(os.path.join(ref.data_dir, "analytics.prom")) == \
        _prom(os.path.join(on.data_dir, "analytics.prom"))


def test_analytics_leaves_trajectory_identical(runs):
    """TPU_ANALYTICS=1 and =0 give the same state field by field and the
    same run key; only the on run publishes analytics."""
    on, off = runs["on"], runs["off"]
    a, b = convert.state_to_arrays(on.state), convert.state_to_arrays(
        off.state)
    for k in state_field_names():
        assert (a[k] is None and b[k] is None) or \
            a[k].tobytes() == b[k].tobytes(), k
    assert on._run_key.tolist() == off._run_key.tolist()
    assert not os.path.exists(os.path.join(off.data_dir, "analytics.prom"))


def _cli_both(ck, tmp, capsys):
    """--analyze CKPT_DIR through both CLIs; returns their outputs and
    data dirs after asserting them equal."""
    out = {}
    for name, main, extra in (("ref", ref_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        d = os.path.join(tmp, name)
        assert main(["--analyze", ck, "-d", d] + CLI_SET + extra) == 0
        out[name] = (capsys.readouterr(), d)
    (r_io, rd), (t_io, td) = out["ref"], out["port"]
    assert r_io.out == t_io.out and "census" in t_io.out
    for f in ("census.dat", "knockout.dat", "lineage.dat"):
        a = open(os.path.join(rd, "analysis", f), "rb").read()
        assert a == open(os.path.join(td, "analysis", f), "rb").read(), f
    assert _journal(os.path.join(rd, "analysis", "analytics.jsonl")) == \
        _journal(os.path.join(td, "analysis", "analytics.jsonl"))
    assert _prom(os.path.join(rd, "analytics.prom")) == \
        _prom(os.path.join(td, "analytics.prom"))
    return r_io, t_io, td


def test_analyze_cli_equals_reference(runs, tmp_path, capsys):
    """--analyze over the reference-written checkpoints: the newest
    generation (update 8), every table and record equal; the loader's
    tables and the triage summary equal the reference's."""
    ck = os.path.join(runs["ref"].data_dir, "..", "ck")
    _, _, td = _cli_both(ck, str(tmp_path), capsys)
    (rec,) = _journal(os.path.join(td, "analysis", "analytics.jsonl"))
    assert rec["update"] == 8 and rec["knockout_sweeps"] > 0
    r, t = rpl.load_run_tables(ck), tpl.load_run_tables(ck)
    for f in ("update", "path", "rebuilt"):
        assert getattr(r, f) == getattr(t, f)
    for f in ("alive", "genome", "genome_len", "task_counts"):
        assert np.asarray(getattr(r, f)).tobytes() == \
            getattr(t, f).tobytes()
    assert r.arbiter.to_snapshot() == t.arbiter.to_snapshot()
    assert rpl.checkpoint_detail(t.path) == tpl.checkpoint_detail(t.path)


def test_analyze_cli_corrupt_generation_falls_back(runs, tmp_path, capsys):
    """A corrupt newest generation: both CLIs skip it, name it on
    stderr, and analyze the one before, as a resume would."""
    from avida_tpu_torch.utils import checkpoint as ckpt_mod
    ck = str(tmp_path / "ck")
    shutil.copytree(os.path.join(runs["ref"].data_dir, "..", "ck"), ck)
    newest = ckpt_mod.list_generations(ck)[-1]
    gpath = os.path.join(newest, "state.genome.npy")
    blob = bytearray(open(gpath, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(gpath, "wb").write(bytes(blob))
    r_io, t_io, td = _cli_both(ck, str(tmp_path), capsys)
    assert "skipping corrupt" in t_io.err and newest in t_io.err
    (rec,) = _journal(os.path.join(td, "analysis", "analytics.jsonl"))
    resume_path, _ = ckpt_mod.latest_valid(ck)
    assert rec["source"] == resume_path and rec["update"] == 4


def test_analyze_flag_forms(runs, tmp_path, capsys):
    """Bare -a runs the config dir's analyze.cfg through the analyze VM
    (its DETAIL file equals the reference's); -a with a token that is
    not a directory exits 2 with the reference's message."""
    from avida_tpu_torch.utils.spop import _seq_to_string
    from test_torch_testcpu import genomes
    cdir = tmp_path / "cfg"
    cdir.mkdir()
    (cdir / "avida.cfg").write_text("WORLD_X 4\nWORLD_Y 4\n")
    seq = _seq_to_string(genomes()["nand"])
    (cdir / "analyze.cfg").write_text(
        f"LOAD_SEQUENCE {seq}\nRECALCULATE\n"
        "DETAIL d.dat id fitness merit gestation_time viable\n")
    files = []
    for name, main, extra in (("ref", ref_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / name
        assert main(["-c", str(cdir), "-a", "-d", str(d)] + extra) == 0
        files.append((d / "d.dat").read_bytes())
    assert files[0] == files[1]
    assert port_main(["-a", str(tmp_path / "nope"), "--device", "cpu"]) == 2
    assert "is not a checkpoint directory" in capsys.readouterr().err
