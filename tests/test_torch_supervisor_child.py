"""Supervised port runs with real child processes on the CPU: a child
SIGKILLed at a chunk boundary past its last save is relaunched with
--resume and its final generation equals, array for array, that of an
uninterrupted in-process run of the reference's World (avida_tpu, its
kernel route in interpret mode).  The drills of the reference's
tests/test_chaos.py that take a child per failure -- the hang watchdog,
a corrupted and a torn generation, a NaN rolled back -- run under the
`slow` marker, as the reference's own do.

Inputs: an 8x8 world (seed 11, TPU_MAX_MEMORY 256, AVE_TIME_SLICE 100,
the packed engine, chunks of 2 updates, saves every 4) for 12 updates,
children on `--device cpu` with one thread.

Tolerance: exact -- every array of the final generation equal; exit
codes, failure classes and counters as stated.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu_torch.observability.exporter import read_metrics  # noqa: E402
from avida_tpu_torch.service.supervisor import (Supervisor,  # noqa: E402
                                                SupervisorConfig)
from avida_tpu_torch.utils import checkpoint as ckpt_mod  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
UPDATES = 12
_SETS = [
    ("WORLD_X", "8"), ("WORLD_Y", "8"), ("TPU_MAX_MEMORY", "256"),
    ("AVE_TIME_SLICE", "100"), ("TPU_MAX_STEPS_PER_UPDATE", "100"),
    ("TPU_SYSTEMATICS", "0"), ("TPU_MAX_STRETCH", "2"),
    ("TPU_CKPT_EVERY", "4"), ("TPU_CKPT_FINAL", "1"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread, as the children run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(data, ck, extra=()):
    argv = ["-s", str(SEED), "-u", str(UPDATES), "-d", str(data),
            "-set", "TPU_CKPT_DIR", str(ck), "--device", "cpu"]
    for name, value in _SETS + list(extra):
        argv += ["-set", name, value]
    return argv


def _env():
    env = dict(os.environ)
    env.pop("TPU_FAULT", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cfg(**kw):
    base = dict(watchdog_sec=120.0, poll_sec=0.1, grace_sec=300.0,
                max_retries=4, backoff_base=0.05, backoff_cap=0.2,
                healthy_sec=1e9, seed=3)
    base.update(kw)
    return SupervisorConfig(**base)


def _final(ck):
    gens = ckpt_mod.list_generations(str(ck))
    assert gens, f"no generations under {ck}"
    manifest, arrays, _ = ckpt_mod.read_generation(gens[-1])
    return manifest, arrays


def _run_uninterrupted(base, extra=()):
    """The same world run by the reference in this process to the end,
    its final state published through TPU_CKPT_FINAL: the reference's
    kernel route (TPU_USE_PALLAS 1, the Pallas kernel in interpret
    mode), on one shard, writing no program cache."""
    from avida_tpu.world import World
    ck = base / "ck"
    w = World(overrides=[("RANDOM_SEED", str(SEED)),
                         ("TPU_CKPT_DIR", str(ck)),
                         ("TPU_USE_PALLAS", "1"), ("TPU_KERNEL_SHARDS", "1"),
                         ("TPU_COMPILE_CACHE", "0")] + _SETS + list(extra),
              data_dir=str(base / "data"))
    w.run(max_updates=UPDATES)
    manifest, arrays = _final(ck)
    assert manifest["update"] == UPDATES
    return arrays


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    return _run_uninterrupted(tmp_path_factory.mktemp("uninterrupted"))


def _assert_equal(ck, ref):
    manifest, arrays = _final(ck)
    assert manifest["update"] == UPDATES
    assert set(arrays) == set(ref)
    for name in sorted(arrays):
        np.testing.assert_array_equal(arrays[name], ref[name],
                                      err_msg=f"array {name}")


def _records(data):
    return [json.loads(line)
            for line in open(os.path.join(data, "supervisor.jsonl"))]


def test_supervised_sigkill_resumes_equal_to_uninterrupted(tmp_path,
                                                            uninterrupted):
    """`python -m avida_tpu_torch --supervise --fault-plan
    sigkill@update=5 ...`: boot 0 dies at the update-6 boundary, past
    the save at 4; boot 1 resumes from 4 and replays to 12."""
    data, ck = tmp_path / "data", tmp_path / "ck"
    env = _env()
    env.update(TPU_SUPERVISE_POLL_SEC="0.1", TPU_SUPERVISE_BACKOFF_BASE="0.05",
               TPU_SUPERVISE_BACKOFF_CAP="0.1")
    res = subprocess.run(
        [sys.executable, "-m", "avida_tpu_torch", "--supervise",
         "--fault-plan", "sigkill@update=5"] + _argv(data, ck),
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = _records(data)
    assert [r["class"] for r in recs if r["event"] == "exit"] \
        == ["crash", "success"]
    assert [r["fault"] for r in recs if r["event"] == "launch"] \
        == ["sigkill@update=5", ""]
    assert [r["event"] for r in recs] \
        == ["launch", "exit", "backoff", "launch", "exit", "done"]
    assert not any("xla_fallback" in r for r in recs)
    log = open(data / "supervised.log").read()
    assert "checkpoint_restored" in log and "update=4" in log
    report = json.loads(log.strip().splitlines()[-1])
    assert report["device"] == "cpu" and report["updates"] == UPDATES
    m = read_metrics(str(data / "supervisor.prom"))
    assert m["avida_supervisor_boots_total"] == 2
    assert m['avida_supervisor_failures_total{class="crash"}'] == 1
    _assert_equal(ck, uninterrupted)


def _supervise(tmp_path, plan, extra=(), cfg=None):
    data, ck = tmp_path / "data", tmp_path / "ck"
    sup = Supervisor(_argv(data, ck, extra), fault_plan=plan,
                     cfg=cfg or _cfg(), env=_env())
    return sup, sup.run(), data, ck


@pytest.mark.slow
def test_hang_watchdog_kill_and_resume(tmp_path, uninterrupted):
    """Every generation kept: the retention prune's unlinks of freshly
    fsynced files can take seconds on some file systems, and would stall
    the heartbeat of the run's last chunk past the 4 s watchdog."""
    sup, rc, data, ck = _supervise(tmp_path, ["hang@chunk=3"],
                                   extra=(("TPU_CKPT_KEEP", "8"),),
                                   cfg=_cfg(watchdog_sec=4.0))
    assert rc == 0
    assert sup.failures["hang"] == 1 and sup.watchdog_kills == 1
    kills = [r for r in _records(data) if r["event"] == "watchdog_kill"]
    assert kills and kills[0]["reason"] == "stale heartbeat"
    _assert_equal(ck, uninterrupted)


@pytest.mark.slow
def test_corrupt_generation_skipped_and_classified(tmp_path, uninterrupted):
    sup, rc, data, ck = _supervise(
        tmp_path, ["corrupt-ckpt:leaf=merit@update=8;sigkill@update=9"])
    assert rc == 0
    assert sup.failures["crash"] == 1 and sup.failures["corrupt_ckpt"] == 1
    assert sup.ckpt_fallbacks == 1
    log = open(data / "supervised.log").read()
    assert "checkpoint_corrupt" in log and "checkpoint_restored" in log
    _assert_equal(ck, uninterrupted)


@pytest.mark.slow
def test_torn_manifest_generation_skipped(tmp_path, uninterrupted):
    sup, rc, data, ck = _supervise(
        tmp_path, ["torn-manifest@update=8;sigkill@update=9"])
    assert rc == 0
    log = open(data / "supervised.log").read()
    assert "checkpoint_corrupt" in log
    assert "torn or unreadable manifest" in log
    _assert_equal(ck, uninterrupted)


@pytest.mark.slow
def test_nan_rollback_recovery(tmp_path):
    """An armed nan: fault takes the world off the packed engine (both
    packages refuse it there), so the drill and its uninterrupted run
    both take the per-update engine (TPU_PACKED_CHUNK 0): then only the
    fault itself tells the boots apart."""
    engine = (("TPU_PACKED_CHUNK", "0"),)
    ref = _run_uninterrupted(tmp_path / "uninterrupted", engine)
    sup, rc, data, ck = _supervise(
        tmp_path, ["nan:merit@update=6"],
        extra=engine + (("TPU_AUDIT_EVERY", "2"), ("TPU_CKPT_EVERY", "2")))
    assert rc == 0
    assert sup.failures["audit_violation"] == 1 and sup.rollbacks == 1
    assert [d for d in os.listdir(ck) if d.startswith(".bad-")]
    assert "rollback" in [r["event"] for r in _records(data)]
    _assert_equal(ck, ref)
