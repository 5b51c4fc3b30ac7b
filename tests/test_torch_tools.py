"""The port's ops tools against the reference's scripts:
`avida_tpu_torch.tools.ckpt_tool` and scripts/ckpt_tool.py on checkpoint
directories the port wrote (a torn manifest, a corrupted leaf, a digest
that no longer recomputes, `.bad-*` / `.tmp-*` / `.old-*` debris), and
`avida_tpu_torch.tools.metrics_tool` and scripts/metrics_tool.py on the
history rings of a port run and of a supervised run; neither port tool
loading torch, nor cache_tool and perf_tool run beside them
(test_torch_run_tools.py holds those to the reference).

Inputs: a 4x4 port world (RANDOM_SEED 3, systematics on, TPU_STATE_DIGEST
1) saving every 2 updates to 8, keeping every generation; its
metrics.hist.jsonl with the clock pinned; a supervisor.hist.jsonl of a
fake-child supervised run; a ring whose update counter stalls.  Each tool
runs on its own copy of the same directory.

Tolerance: exact -- exit codes, the removed paths and every printed line
equal (the directory root replaced by one token).
"""

import os
import shutil
import subprocess
import sys
import time

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu_torch.tools import ckpt_tool as tck  # noqa: E402
from avida_tpu_torch.tools import metrics_tool as tmt  # noqa: E402
from avida_tpu_torch.utils import faultinject as tfi  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import ckpt_tool as rck  # noqa: E402
import metrics_tool as rmt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = 1_700_000_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    """root/run/ck: generations 2..8 of a port world, then damaged: a
    corrupted merit leaf at 4, a torn manifest at 6, a digest that no
    longer recomputes at 2, and the debris a crash or a supervisor
    leaves; root/other/ck: a second run's directory (for --all); the
    run's data dir with its history ring."""
    from avida_tpu_torch.observability import profiler
    from avida_tpu_torch.utils import integrity
    from avida_tpu_torch.world import World
    # the process's digest and profiler counters reach the ring's
    # samples: a worker that digested earlier would fire
    # integrity_mismatch in `watch`
    integrity.reset_for_tests()
    profiler.reset_for_tests()
    root = tmp_path_factory.mktemp("tools")
    ck = root / "run" / "ck"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: PINNED)
        w = World(overrides=[("WORLD_X", "4"), ("WORLD_Y", "4"),
                             ("RANDOM_SEED", "3"), ("TPU_CKPT_DIR", str(ck)),
                             ("TPU_CKPT_EVERY", "2"), ("TPU_CKPT_KEEP", "10"),
                             ("TPU_STATE_DIGEST", "1"), ("TPU_METRICS", "1"),
                             ("TPU_MAX_STRETCH", "2")],
                  data_dir=str(root / "run" / "data"), device="cpu")
        w.run(max_updates=8)
    shutil.copytree(ck, root / "other" / "ck")
    gen = {u: str(ck / f"ckpt-{u:012d}") for u in (2, 4, 6, 8)}
    tfi.corrupt_leaf(gen[4], "merit", tfi.parse_spec("corrupt-ckpt",
                                                     seed=1)[0].rng)
    tfi.tear_manifest(gen[6], tfi.parse_spec("torn-manifest",
                                             seed=1)[0].rng)
    tfi.corrupt_digest(gen[2], tfi.parse_spec("corrupt-digest",
                                              seed=1)[0].rng)
    for d in (".tmp-ckpt-000000000010.1", ".old-ckpt-000000000002.2",
              ".bad-ckpt-000000000006.3"):
        os.makedirs(ck / d)
        os.makedirs(root / "other" / "ck" / d)
    (root / "run" / "ckpt-seedrun").mkdir()
    return root


def _run_tool(main, argv, root, capsys):
    rc = main([a.replace("{root}", str(root)) for a in argv])
    out = capsys.readouterr().out.replace(str(root), "<root>")
    return rc, out


CKPT_CASES = {
    "list": ["{root}/run/ck"],
    "verify": ["{root}/run/ck", "--verify"],
    "manifest": ["{root}/run/ck", "--manifest"],
    "verify_manifest": ["{root}/run/ck", "--verify", "--manifest"],
    "detail": ["{root}/run/ck", "--detail"],
    "prune": ["{root}/run/ck", "--prune"],
    "prune_keep": ["--prune", "--keep", "1", "{root}/run/ck"],
    "prune_all": ["--prune", "--all", "{root}", "--keep", "3"],
    "all_without_prune": ["--all", "{root}"],
    "keep_without_int": ["{root}/run/ck", "--prune", "--keep"],
    "no_generations": ["{root}/run/data"],
    "other_verify": ["{root}/other/ck", "--verify"],
}


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_ckpt_tool_equals_reference(port_tree, tmp_path, capsys, case):
    """Each mode of the tool on its own copy of the port's tree: the
    same exit code, printed lines and removed paths as the reference
    script's."""
    got = {}
    for name, mod in (("ref", rck), ("port", tck)):
        root = tmp_path / name
        shutil.copytree(port_tree, root)
        rc, out = _run_tool(mod.main, CKPT_CASES[case], root, capsys)
        left = sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, dirs, files in os.walk(root) for f in dirs)
        got[name] = (rc, out, left)
    assert got["port"] == got["ref"]
    rc, out, left = got["port"]
    if case == "verify":
        assert rc == 0 and "TORN MANIFEST" in out and "CRC mismatch" in out
        assert "DIGEST MISMATCH" in out and "OK (verified, digest ok)" in out
    elif case == "prune":
        assert "pruned <root>/run/ck/.bad-ckpt-000000000006.3" in out
        assert not [d for d in left if d.startswith("run/ck/.")]
    elif case == "prune_all":
        assert "checkpoint dir(s)" in out and "run/ckpt-seedrun" in left
    elif case == "detail":
        assert "dominant gid" in out
    elif case in ("all_without_prune", "keep_without_int"):
        assert rc == 2
    elif case == "no_generations":
        assert rc == 1


def test_ckpt_tool_prune_helpers_equal_reference(port_tree, tmp_path):
    """prune() and prune_all() return the same removed paths."""
    got = {}
    for name, mod in (("ref", rck), ("port", tck)):
        root = tmp_path / name
        shutil.copytree(port_tree, root)
        removed = mod.prune(str(root / "run" / "ck"), keep=2)
        swept = mod.prune_all(str(root), keep=1)
        got[name] = [os.path.relpath(p, root) for p in removed] + sorted(
            (os.path.relpath(k, root), [os.path.relpath(p, root) for p in v])
            for k, v in swept.items())
    assert got["port"] == got["ref"] and got["port"]


def _rings(root):
    """The port run's heartbeat ring, a supervised run's counter ring and
    a ring whose update counter stalls, each in a data dir of its own."""
    from avida_tpu_torch.observability import history
    from avida_tpu_torch.service.supervisor import (Supervisor,
                                                    SupervisorConfig)
    stalled = root / "stalled"
    os.makedirs(stalled)
    for i in range(15):
        history.append_sample(str(stalled / "metrics.hist.jsonl"),
                              {"avida_update": 80.0},
                              now=PINNED - 70 + i * 5)

    class Done:
        returncode = 0

        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

    sup_dir = root / "sup"
    sup = Supervisor(["-d", str(sup_dir), "-set", "TPU_CKPT_DIR",
                      str(root / "sup_ck")],
                     cfg=SupervisorConfig(poll_sec=0.0),
                     env={}, spawn=lambda argv, env, logf: Done(),
                     sleep=lambda s: None)
    assert sup.run() == 0
    return {"run": root / "run" / "data", "stalled": stalled,
            "sup": sup_dir}


METRICS_CASES = {
    "query": ["query", "{run}", "avida_update"],
    "query_window": ["query", "{run}", "avida_update", "--window", "600"],
    "query_births": ["query", "{run}", "avida_births_total"],
    "query_missing": ["query", "{run}", "no_such_family"],
    "query_sup": ["query", "{sup}", "avida_supervisor_boots_total",
                  "--ring", "supervisor"],
    "watch_once": ["watch", "{run}", "--once"],
    "watch_stalled": ["watch", "{stalled}", "--once"],
    "watch_sup": ["watch", "{sup}", "--once"],
    "rules": ["rules", "{run}"],
    "prune": ["prune", "{run}", "--keep-bytes", "512"],
    "no_rings": ["query", "{sup}/nowhere", "avida_update"],
}


@pytest.mark.parametrize("case", list(METRICS_CASES))
def test_metrics_tool_equals_reference(port_tree, tmp_path, monkeypatch,
                                       capsys, case):
    """Each subcommand on its own copy of the same rings, the clock
    pinned: the same exit code and output as the reference script's."""
    monkeypatch.setattr(time, "time", lambda: PINNED + 1.0)
    got = {}
    for name, mod in (("ref", rmt), ("port", tmt)):
        root = tmp_path / name
        shutil.copytree(port_tree, root)
        dirs = _rings(root)
        argv = [a.format(**{k: str(v) for k, v in dirs.items()})
                for a in METRICS_CASES[case]]
        rc = mod.main(argv)
        got[name] = (rc, capsys.readouterr().out.replace(str(root),
                                                          "<root>"))
    assert got["port"] == got["ref"]
    rc = got["port"][0]
    assert rc == {"query_missing": 1, "watch_stalled": 3,
                  "no_rings": 1}.get(case, 0), got["port"]
    if case == "query":
        assert "count" in got["port"][1] and "rate_per_sec" in got["port"][1]


_NO_TORCH = r"""
import runpy, sys
sys.argv = ["metrics_tool", "rules"]
try:
    runpy.run_module("avida_tpu_torch.tools.metrics_tool", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
sys.argv = ["ckpt_tool", {ck!r}, "--verify", "--manifest"]
try:
    runpy.run_module("avida_tpu_torch.tools.ckpt_tool", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
for argv in (["cache_tool", {ck!r}, "--prune", "--all"],
             ["perf_tool", "diff", "BENCH_r01.json", "BENCH_r02.json",
              "--force"]):
    sys.argv = argv
    try:
        runpy.run_module("avida_tpu_torch.tools." + argv[0],
                         run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (argv, e.code)
print("TORCH", "torch" in sys.modules)
"""


def test_tools_run_as_modules_without_torch(port_tree):
    res = subprocess.run(
        [sys.executable, "-c",
         _NO_TORCH.format(ck=str(port_tree / "other" / "ck"))],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "TORCH False" in res.stdout and "OK (verified" in res.stdout
