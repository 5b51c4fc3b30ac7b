"""Telemetry (TPU_TELEMETRY) against avida_tpu's: telemetry.jsonl
against the reference's, the counters against the .dat files, the
budget-tail counters and the scheduler's block statistics, and a
disabled world that writes nothing (StagedUpdate against update_step:
tests/test_torch_staged.py).

Inputs: budget vectors drawn from seeded numpy generators; an 8x8 world
(RANDOM_SEED 5, AVE_TIME_SLICE 100, InjectAll: births from the fourth
update) on the micro-step engine in both packages.

Tolerance: exact -- state fields, counters and every telemetry record
field but the timing fields (wall_ms, phases) and the device meta
(time, platform, device, num_devices).
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.observability import counters as rcounters  # noqa: E402
from avida_tpu.ops import scheduler as rsched  # noqa: E402
from avida_tpu.ops import update as rupdate  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.observability import counters as tcounters  # noqa: E402
from avida_tpu_torch.ops import scheduler as tsched  # noqa: E402
from avida_tpu_torch.ops import update as tupdate  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

from test_torch_world import _pair  # noqa: E402

VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5, AVE_TIME_SLICE=100,
            TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0)
DEVICE_META = ("time", "platform", "device", "num_devices")
TIMING = ("wall_ms", "phases")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["record"] == kind]


def _dat_rows(path):
    with open(path) as f:
        return {int(r[0]): [int(float(x)) for x in r]
                for r in (line.split() for line in f)
                if r and not r[0].startswith("#")}


def test_telemetry_world_equals_reference_and_dat_files(tmp_path):
    """Eight updates with TPU_TELEMETRY=1 on the micro-step engine: the
    state and every telemetry.jsonl record equal the reference's but the
    timing fields and the device meta; each update record's executed,
    births and task triggers equal the count.dat and tasks_exe.dat rows
    of the same update, and its dispatch mix sums to the executed
    count."""
    vals = dict(VALS, TPU_USE_PALLAS=2, TPU_TELEMETRY=1)
    events = ["u begin InjectAll", "u 0:1:end PrintCountData",
              "u 0:1:end PrintTasksExeData"]
    ref, port = _pair(tmp_path, vals, events)
    assert ref.run(max_updates=8) == port.run(max_updates=8)
    from test_torch_world import _assert_same_state
    _assert_same_state(ref, port, 8)
    out = {}
    for side in ("ref", "port"):
        path = tmp_path / side / "telemetry.jsonl"
        meta = _records(path, "meta")
        ups = _records(path, "update")
        assert len(meta) == 1 and len(ups) == 8
        for k in DEVICE_META:
            meta[0].pop(k)
        for r in ups:
            for k in TIMING:
                r.pop(k)
        out[side] = (meta, ups)
    assert out["ref"] == out["port"]
    assert out["port"][0][0]["interpret_path"] == "xla_while_loop"
    count = _dat_rows(tmp_path / "port" / "count.dat")
    tasks = _dat_rows(tmp_path / "port" / "tasks_exe.dat")
    births = 0
    for r in out["port"][1]:
        c, u = r["counters"], r["update"]
        if u + 1 in count:                 # printed before update u + 1
            assert count[u + 1][1] == c["executed"]
            assert count[u + 1][8] == c["births"]
            assert tasks[u + 1][1:] == c["task_triggers"]
        assert sum(c["dispatch_mix"]) == c["executed"]
        births += c["births"]
    assert births == int(port._total_births) > 0
    rec = _records(tmp_path / "port" / "telemetry.jsonl", "update")[-1]
    assert {"schedule", "while_loop", "bank", "birth_flush",
            "counters"} <= set(rec["phases"])


@pytest.mark.parametrize("n,block", [(8, 4), (100, 32), (1000, 128),
                                     (37, 37), (256, 64)])
def test_budget_tail_and_block_statistics_equal_reference(n, block):
    """budget_tail, block_budget_histogram and block_skip_fraction on
    seeded grant vectors (zeros and a long tail among them); the
    reference's hand-checked case first."""
    g0 = [1, 2, 3, 4, 10, 0, 0, 0]
    t = tcounters.budget_tail(torch.tensor(g0, dtype=torch.int32), 4)
    assert (int(t["granted_sum"]), int(t["ceiling_sum"]),
            int(t["block_max_max"])) == (20, 56, 10)
    rng = np.random.default_rng(n)
    g = np.where(rng.random(n) < 0.3, 0,
                 rng.geometric(0.02, n)).astype(np.int32)
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    want = rcounters.budget_tail(jg, block)
    got = tcounters.budget_tail(tg, block)
    for k in want:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    for a, b in zip(rsched.block_budget_histogram(jg, block),
                    tsched.block_budget_histogram(tg, block)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    a = np.asarray(rsched.block_skip_fraction(jg, block))
    b = tsched.block_skip_fraction(tg, block).numpy()
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    words = np.asarray([5, 3, 2], np.int64)
    assert tupdate.total_insts_exact(words) == \
        rupdate.total_insts_exact(words)


def test_disabled_world_writes_no_files(tmp_path):
    """With every observability switch off a run writes only its .dat
    files: no telemetry.jsonl, metrics.prom, perf.jsonl or history
    ring, and none of the hosts is built."""
    w = World(cfg=convert.config_from_dict(dict(VALS, TPU_USE_PALLAS=2)),
              device="cpu", data_dir=str(tmp_path / "d"))
    w.events = []
    w.add_event("u begin InjectAll")
    w.add_event("u 0:1:end PrintCountData")
    w.run(max_updates=2)
    assert (w.telemetry, w.tracer, w.exporter, w.profiler, w.faults) == \
        (None,) * 5
    assert sorted(os.listdir(tmp_path / "d")) == ["count.dat"]


def test_cli_flags_arm_the_plane(tmp_path):
    """`--profile-dir DIR --trace` on the command line: telemetry on (the
    meta and update records), a torch.profiler trace of the first
    update in DIR/trace.json, the flight recorder and its heartbeat."""
    from avida_tpu_torch.__main__ import main
    d, prof = tmp_path / "d", tmp_path / "prof"
    assert main(["-u", "2", "-set", "WORLD_X", "4", "-set", "WORLD_Y", "4",
                 "-set", "TPU_PROFILE_UPDATES", "1", "--device", "cpu",
                 "-d", str(d), "--profile-dir", str(prof), "--trace"]) == 0
    assert len(_records(d / "telemetry.jsonl", "meta")) == 1
    assert len(_records(d / "telemetry.jsonl", "update")) == 2
    assert json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert (d / "metrics.prom").exists()
