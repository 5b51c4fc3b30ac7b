"""The port's run-output tools against the reference's scripts, on the
same port-produced inputs: avida_tpu_torch.tools.trace_tool against
scripts/trace_tool.py (to-chrome, summary and from-chrome over a small
port world's telemetry.jsonl with the flight recorder on; fleet over a
spool the port's orchestrator wrote), tools.perf_tool against
scripts/perf_tool.py (report over a TPU_PROFILE=1 port data dir; diff
--gate over pairs of the repo's BENCH_r0*.json; campaign refused by name
until the port has a bench), tools.analyze_tool against `python -m
avida_tpu_torch --analyze` and scripts/analyze_tool.py over one port
checkpoint directory, and exit 66 on a directory with no valid
generation; tools.cache_tool against scripts/cache_tool.py on a root
holding both packages' stores.

Inputs: a 5x5 world (RANDOM_SEED 7, systematics off) for 6 updates under
TPU_TELEMETRY + TPU_TRACE; a 5x5 world for 8 updates under TPU_PROFILE +
TPU_METRICS; a 6x6 world (five ancestors, micro-step engine) for 8
updates checkpointing every 4 with the Test CPU replaced by
test_torch_analyze.stand_in in both packages; the port orchestrator's
mixed spool of test_torch_fleet plus a metrics ring and an alert
journal written by the port's history and records modules.

Tolerance: exact -- exit codes, the written trace / JSONL documents, and
every printed line equal (temporary roots replaced by one token).
"""

import json
import os
import subprocess
import sys
import time

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import analyze_tool as rat  # noqa: E402
import cache_tool as rct  # noqa: E402
import perf_tool as rpt  # noqa: E402
import trace_tool as rtt  # noqa: E402

import avida_tpu.analyze.testcpu as rtestcpu  # noqa: E402
import avida_tpu_torch.analyze.testcpu as ttestcpu  # noqa: E402
from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.observability import history as thistory  # noqa: E402
from avida_tpu_torch.observability.records import \
    append_record as tappend  # noqa: E402
from avida_tpu_torch.tools import analyze_tool as tat  # noqa: E402
from avida_tpu_torch.tools import cache_tool as tct  # noqa: E402
from avida_tpu_torch.tools import perf_tool as tpt  # noqa: E402
from avida_tpu_torch.tools import trace_tool as ttt  # noqa: E402
from avida_tpu_torch.utils import compilecache as tcc  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

from test_torch_analyze import stand_in  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_world(data_dir, **over):
    vals = dict(WORLD_X=5, WORLD_Y=5, RANDOM_SEED=7, TPU_SYSTEMATICS=0)
    vals.update(over)
    return World(cfg=convert.config_from_dict(vals), data_dir=str(data_dir),
                 device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runs")
    w = port_world(tmp / "tel", TPU_TELEMETRY=1, TPU_TRACE=1)
    w.run(max_updates=6)
    w = port_world(tmp / "prof", TPU_PROFILE=1, TPU_METRICS=1,
                   TPU_TRACE=1, TPU_MAX_STRETCH=2)
    w.run(max_updates=8)
    return tmp


def both(capsys, fn_ref, fn_port, *per_side):
    """Each tool's (rc, stdout, stderr) on its own side's arguments."""
    out = {}
    for name, fn, args in (("ref", fn_ref, per_side[0]),
                           ("port", fn_port, per_side[1])):
        capsys.readouterr()
        rc = fn(args)
        io = capsys.readouterr()
        out[name] = (rc, io.out, io.err)
    return out


def masked(res, *roots):
    rc, out, err = res
    for r in roots:
        out, err = out.replace(str(r), "<root>"), err.replace(str(r),
                                                             "<root>")
    return rc, out, err


# ---------------------------------------------------------------------------
# trace_tool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", ["tel", "prof"])
def test_trace_tool_to_chrome_and_back_equal_reference(runs, tmp_path,
                                                       capsys, run):
    log = str(runs / run / "telemetry.jsonl")
    recs = [json.loads(ln) for ln in open(log)]
    assert any(r.get("record") == "trace" and r["events"] for r in recs)
    assert any(r.get("record") == "update" for r in recs) == (run == "tel")
    docs = {}
    for side, mod in (("ref", rtt), ("port", ttt)):
        os.makedirs(tmp_path / side)
        out = str(tmp_path / side / "trace.json")
        back = str(tmp_path / side / "trace.jsonl")
        capsys.readouterr()
        assert mod.main(["to-chrome", log, "-o", out]) == 0
        assert mod.main(["from-chrome", out, "-o", back]) == 0
        assert mod.main(["summary", log]) == 0
        printed = capsys.readouterr().out.replace(str(tmp_path / side),
                                                  "<root>")
        docs[side] = (json.load(open(out)), open(back).read(), printed)
    assert docs["port"] == docs["ref"]
    chrome, back, printed = docs["port"]
    assert "events total" in printed and len(chrome["traceEvents"]) > 10
    drained = [r for r in recs if r.get("record") == "trace"]
    assert [json.loads(ln)["update"] for ln in back.splitlines()] \
        == sorted({r["update"] for r in drained if r["events"]})


def port_spool(root):
    """The port orchestrator's mixed spool (every job state), plus a
    metrics ring with perf phases and an alert that fired and resolved
    for one job, and an unresolved fleet-level alert."""
    import test_supervisor as ts
    from test_torch_fleet import PKGS, _mixed_spool
    spool = _mixed_spool(PKGS["port"], root, ts.FakeClock())
    data = os.path.join(spool, "ok", "data")
    os.makedirs(data, exist_ok=True)
    ring = thistory.hist_path(os.path.join(data, "metrics.prom"))
    for k, t in enumerate((1000.5, 1001.0, 1001.5)):
        thistory.append_sample(ring, {
            "avida_update": 4 * (k + 1),
            'avida_perf_phase_ms{phase="cycles"}': 3.0 + k,
            'avida_perf_phase_ms{phase="birth"}': 1.0}, now=t)
    for path, rule, states in (
            (os.path.join(data, "alerts.jsonl"), "stalled",
             ((1000.7, "firing"), (1001.2, "resolved"))),
            (os.path.join(spool, "alerts.jsonl"), "crash_storm",
             ((1000.9, "firing"),))):
        for t, state in states:
            tappend(path, {"record": "alert", "rule": rule,
                           "state": state, "time": t, "severity": "page",
                           "value": 1.0})
    return spool


def test_trace_tool_fleet_equals_reference(tmp_path, capsys):
    spool = port_spool(tmp_path)
    res = both(capsys, rtt.main, ttt.main,
               ["fleet", spool, "-o", str(tmp_path / "ref.json")],
               ["fleet", spool, "-o", str(tmp_path / "port.json")])
    assert res["ref"][0] == res["port"][0] == 0
    assert res["ref"][1].replace("ref.json", "port.json") == res["port"][1]
    ref = json.load(open(tmp_path / "ref.json"))
    got = json.load(open(tmp_path / "port.json"))
    assert got == ref
    names = {e["name"] for e in got["traceEvents"]}
    assert {"alert:stalled", "alert:crash_storm (unresolved)",
            "avida_update"} <= names
    assert "ok" in got["otherData"]["jobs"]


# ---------------------------------------------------------------------------
# perf_tool
# ---------------------------------------------------------------------------

def test_perf_tool_report_equals_reference(runs, capsys):
    d = str(runs / "prof")
    assert os.path.exists(os.path.join(d, "perf.jsonl"))
    res = both(capsys, rpt.main, tpt.main, ["report", d], ["report", d])
    assert res["port"] == res["ref"]
    assert res["port"][0] == 0 and "probe timeline" in res["port"][1]
    empty = os.path.join(str(runs), "tel")      # no attribution data
    res = both(capsys, rpt.main, tpt.main, ["report", empty],
               ["report", empty])
    assert res["port"] == res["ref"] and res["port"][0] == 1


DIFFS = [(["BENCH_r01.json", "BENCH_r02.json", "--gate"], 3),
         (["BENCH_r01.json", "BENCH_r02.json", "--gate", "--force"], 0),
         (["BENCH_r02.json", "BENCH_r01.json", "--gate", "--force"], 4),
         (["BENCH_r02.json", "BENCH_r01.json", "--force"], 0),
         (["BENCH_r04.json", "BENCH_r03.json", "--gate", "--force",
           "--tol", "0.5", "--verbose"], None),
         (["BENCH_r05.json", "missing.json"], 2)]


@pytest.mark.parametrize("args,want", DIFFS)
def test_perf_tool_diff_equals_reference(capsys, monkeypatch, args, want):
    monkeypatch.chdir(REPO)
    res = both(capsys, rpt.main, tpt.main, ["diff"] + args, ["diff"] + args)
    assert res["port"] == res["ref"]
    if want is not None:
        assert res["port"][0] == want


def test_perf_tool_campaign_refused_by_name(capsys):
    assert tpt.main(["campaign", "--arms", "headline"]) == 2
    err = capsys.readouterr().err
    assert "campaign" in err and "ROADMAP item 8" in err


# ---------------------------------------------------------------------------
# analyze_tool
# ---------------------------------------------------------------------------

ANA = dict(WORLD_X=6, WORLD_Y=6, TPU_MAX_MEMORY=200, RANDOM_SEED=3,
           AVE_TIME_SLICE=100, TPU_USE_PALLAS=2, TPU_CKPT_EVERY=4,
           TPU_CKPT_FINAL=1, TPU_CKPT_AUDIT=0, TPU_MAX_STRETCH=4)
ANA_SET = ["-set", "WORLD_X", "6", "-set", "WORLD_Y", "6",
           "-set", "AVE_TIME_SLICE", "100"]


@pytest.fixture
def stand_in_cpu(monkeypatch):
    for mod in (rtestcpu, ttestcpu):
        monkeypatch.setattr(mod, "evaluate_genomes", stand_in)
    monkeypatch.setattr(time, "asctime", lambda *a: "Thu Jan  1 00:00:00 1970")


def test_analyze_tool_equals_cli_and_reference(tmp_path, capsys,
                                               stand_in_cpu):
    from avida_tpu_torch.__main__ import main as port_main
    ck = str(tmp_path / "ck")
    w = World(cfg=convert.config_from_dict(dict(ANA, TPU_CKPT_DIR=ck)),
              data_dir=str(tmp_path / "run"), device="cpu")
    w.events = []
    for c in (10, 11, 20, 21, 27):
        w.inject(cell=c)
    w.run(max_updates=8)
    out = {}
    for name, fn, argv in (
            ("tool", tat.main, [ck, "--device", "cpu"]),
            ("cli", port_main, ["--analyze", ck, "--device", "cpu"]),
            ("ref", rat.main, [ck])):
        d = str(tmp_path / name)
        capsys.readouterr()
        rc = fn(argv + ["-d", d, "-v"] + ANA_SET)
        io = capsys.readouterr()
        files = {f: open(os.path.join(d, "analysis", f), "rb").read()
                 for f in ("census.dat", "knockout.dat", "lineage.dat")}
        out[name] = (rc, io.out.replace(d, "<d>"), files)
    assert out["tool"] == out["cli"] == out["ref"]
    assert out["tool"][0] == 0 and "census" in out["tool"][1]


def test_analyze_tool_no_valid_generation_exits_66(tmp_path, capsys):
    ck = tmp_path / "ck"
    os.makedirs(ck / "gen_000004")
    (ck / "gen_000004" / "manifest.json").write_text("{torn")
    res = both(capsys, rat.main, tat.main,
               [str(ck), "-d", str(tmp_path / "r")] + ANA_SET,
               [str(ck), "-d", str(tmp_path / "t"), "--device", "cpu"]
               + ANA_SET)
    assert res["ref"][0] == res["port"][0] == 66


# ---------------------------------------------------------------------------
# cache_tool
# ---------------------------------------------------------------------------

def test_cache_tool_sees_only_its_own_store(tmp_path, capsys):
    """One root holding both packages' stores: each tool lists, verifies
    and prunes its own entries alone, with the reference's exit codes;
    a flipped byte makes --verify exit 1."""
    root = str(tmp_path / "compile-cache")
    meta = {"nvcc": "release 12.8, V12.8.93", "arch": "sm_90a",
            "flags": [], "units": [], "code": "0123abcd4567", "tag": "cycles"}
    tcc.write_entry(root, "0123abcd4567", {tcc.LIB_FILE: b"x" * 4096,
                                           tcc.PTXAS_FILE: b"ptxas\n"},
                    meta)
    os.makedirs(os.path.join(root, "refkey"))
    with open(os.path.join(root, "refkey", "manifest.json"), "w") as f:
        json.dump({"format": "avida-compile-cache-v1", "files": {},
                   "tag": "update_scan", "created_at": time.time()}, f)
    res = both(capsys, rct.main, tct.main, [root], [root])
    assert (res["ref"][0], res["port"][0]) == (0, 0)
    assert "refkey" in res["ref"][1] and "0123abcd" not in res["ref"][1]
    assert "0123abcd4567" in res["port"][1] and "refkey" not in res["port"][1]
    assert "nvcc=release 12.8, V12.8.93 arch=sm_90a code=0123abcd" \
        in res["port"][1]
    res = both(capsys, rct.main, tct.main, [root, "--verify"],
               [root, "--verify"])
    assert (res["ref"][0], res["port"][0]) == (0, 0)
    lib = os.path.join(tcc.entry_path(root, "0123abcd4567"), tcc.LIB_FILE)
    with open(lib, "r+b") as f:
        f.write(b"y")
    assert tct.main([root, "--verify"]) == 1
    assert "CORRUPT" in capsys.readouterr().out
    for mod in (tct, rct):                     # no arguments: usage, 2
        assert mod.main([]) == 2
    res = both(capsys, rct.main, tct.main,
               ["--prune", "--all", str(tmp_path)],
               ["--prune", "--all", str(tmp_path)])
    assert (res["ref"][0], res["port"][0]) == (0, 0)
    assert tcc.list_entries(root) == [] and not os.path.exists(
        os.path.join(root, "refkey"))
    empty = str(tmp_path / "none")
    res = both(capsys, rct.main, tct.main, [empty], [empty])
    assert masked(res["port"], empty) == masked(res["ref"], empty)
    assert res["port"][0] == 1


# ---------------------------------------------------------------------------
# no torch in an operator's shell
# ---------------------------------------------------------------------------

_NO_TORCH = r"""
import runpy, sys
for argv in ({tel}, {report}, {diff}, {cache}):
    sys.argv = list(argv)
    try:
        runpy.run_module(argv[0], run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, 1), (argv, e.code)
print("TORCH", "torch" in sys.modules)
"""


def test_run_tools_run_as_modules_without_torch(runs, tmp_path):
    tool = "avida_tpu_torch.tools."
    code = _NO_TORCH.format(
        tel=(tool + "trace_tool", "summary",
             str(runs / "tel" / "telemetry.jsonl")),
        report=(tool + "perf_tool", "report", str(runs / "prof")),
        diff=(tool + "perf_tool", "diff", "BENCH_r01.json",
              "BENCH_r02.json", "--force"),
        cache=(tool + "cache_tool", str(tmp_path)))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "TORCH False" in res.stdout and "events total" in res.stdout
