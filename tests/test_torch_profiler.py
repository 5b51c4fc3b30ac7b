"""The chunk profiler (TPU_PROFILE, observability/profiler.py) and the
measurers behind it (observability/harness.py): the resident footprints
against avida_tpu's byte for byte, an armed run's trajectory against an
unarmed one's, what an armed run writes (perf.jsonl, the avida_perf_*
families, the `--status` perf line) and what an unarmed one does not,
and the harness's measurers on small worlds.

Inputs: 8x8 InjectAll soups (RANDOM_SEED 5, AVE_TIME_SLICE 100, births
in the fourth update) on the kernel route's plain version; the
reference's state rebuilt from the port's arrays.

Tolerance: exact -- footprint dicts and state fields equal.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.config import AvidaConfig as RefConfig  # noqa: E402
from avida_tpu.core.state import PopulationState as RefState  # noqa: E402
from avida_tpu.observability import profiler as rprof  # noqa: E402
from avida_tpu.world import World as RefWorld  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.core.state import stack_states  # noqa: E402
from avida_tpu_torch.observability import exporter as texporter  # noqa: E402
from avida_tpu_torch.observability import harness  # noqa: E402
from avida_tpu_torch.observability import profiler as tprof  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5, AVE_TIME_SLICE=100,
            TPU_SYSTEMATICS=0, TPU_USE_PALLAS=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_plane():
    """The plane's counters are per process: start and leave each test
    with them empty."""
    tprof.reset_for_tests()
    yield
    tprof.reset_for_tests()


def _world(data_dir, **extra):
    w = World(cfg=convert.config_from_dict(dict(VALS, **extra)),
              device="cpu", data_dir=str(data_dir))
    w.events = []
    w.add_event("u begin InjectAll")
    return w


def _ref_params(**extra):
    cfg = RefConfig()
    for k, v in dict(VALS, TPU_USE_PALLAS=1, TPU_KERNEL_SHARDS=1,
                     **extra).items():
        cfg.set(k, v)
    return RefWorld(cfg=cfg).params


@pytest.mark.parametrize("extra,W", [
    ({}, 1), ({"TPU_PACKED_BITS": 1}, 1), ({}, 3),
    ({"TPU_PACKED_BITS": 1, "TPU_MAX_MEMORY": 500}, 2),
])
def test_footprints_equal_reference(tmp_path, extra, W):
    """packed_planes_footprint for the configuration, and state_footprint
    of a run's state (and of W stacked copies, named) with and
    without params, equal the reference's on the same arrays."""
    w = _world(tmp_path, **extra)
    w.run(max_updates=2)
    rp = _ref_params(**extra)
    n = w.params.num_cells
    assert tprof.packed_planes_footprint(w.params, n, W) == \
        rprof.packed_planes_footprint(rp, n, W)
    arrays = convert.state_to_arrays(w.state)
    if W == 1:
        st, names = w.state, None
        rst = RefState(**{k: None if v is None else jnp.asarray(v)
                          for k, v in arrays.items()})
    else:
        st, names = stack_states([w.state] * W), [f"w{k}" for k in range(W)]
        rst = RefState(**{k: None if v is None
                          else jnp.asarray(np.stack([v] * W))
                          for k, v in arrays.items()})
    for params in (None, (w.params, rp)):
        got = tprof.state_footprint(st, names=names, num_ghosts=1,
                                    params=params and params[0])
        want = rprof.state_footprint(rst, names=names, num_ghosts=1,
                                     params=params and params[1])
        assert got == want


def test_armed_run_equals_unarmed_and_publishes(tmp_path):
    """Four updates with TPU_PROFILE=1 (and TPU_METRICS=1) against the
    same run unarmed: every field equal; the armed run wrote perf.jsonl
    records with the packed engine's phases and the footprint, its
    metrics.prom carries the avida_perf_* families and `--status` a perf
    line; the unarmed run wrote neither."""
    on = _world(tmp_path / "on", TPU_PROFILE=1, TPU_METRICS=1,
                TPU_MAX_STRETCH=2)
    off = _world(tmp_path / "off", TPU_MAX_STRETCH=2)
    on.run(max_updates=4)
    off.run(max_updates=4)
    a, b = convert.state_to_arrays(on.state), convert.state_to_arrays(
        off.state)
    for k in a:
        assert (a[k] is None) == (b[k] is None), k
        if a[k] is not None:
            assert a[k].tobytes() == b[k].tobytes(), k
    assert int(on._total_births) > 0
    recs = tprof.read_perf_records(str(tmp_path / "on"))
    assert len(recs) >= 2 and recs[-1]["final"]
    first = recs[0]
    assert set(first["phases"]) == {"pack", "scan.schedule", "scan.kernel",
                                    "scan.bank", "scan.flush", "scan.stats",
                                    "unpack"}
    assert first["state_bytes"] > first["state_live_bytes"] > 0
    assert first["packed_planes"]["packed_bits"] == 0
    assert "device_memory" not in first and "programs" not in first
    metrics = texporter.read_metrics(str(tmp_path / "on" / "metrics.prom"))
    assert metrics["avida_perf_chunks_total"] == 2
    assert 'avida_perf_phase_ms{phase="scan.kernel"}' in metrics
    assert texporter.format_status(metrics).splitlines()[-1].startswith(
        "perf        chunk ")
    assert not os.path.exists(tmp_path / "off")         # nothing written


def test_harness_measurers(tmp_path):
    """profile_phases (the staged update), measure_packed_chunk,
    measure_packed_phases, and the batch's measure_multiworld and
    measure_multiworld_phases (the folded micro-step engine) on small
    evolved worlds: every phase timed, positive totals, and the batch
    split summing to one share."""
    w = _world(tmp_path, WORLD_X=4, WORLD_Y=4)
    w.run(max_updates=1)
    phases, st, granted = harness.profile_phases(
        w.params, w.state, w.neighbors, w._run_key, reps=1, warmup=1,
        update0=1)
    assert granted > 0 and {"schedule", "pack", "kernel", "unpack",
                            "birth_flush"} <= set(phases)
    ms, _ = harness.measure_packed_chunk(w.params, w.state, w.neighbors,
                                         w._run_key, updates=2, reps=1)
    assert ms > 0
    t = harness.measure_packed_phases(w.params, w.state, w.neighbors,
                                      w._run_key, reps=1)
    assert set(t) == {f"{n}_ms" for n in harness._PACKED_PHASES}
    micro = [_world(tmp_path / f"m{s}", TPU_USE_PALLAS=2, RANDOM_SEED=s,
                    AVE_TIME_SLICE=10) for s in (1, 2)]
    for m in micro:
        m.process_events()
    sts = [m.state for m in micro]
    keys = [m._run_key for m in micro]
    ms, _ = harness.measure_multiworld(micro[0].params, sts, None, keys,
                                       updates=1, reps=1)
    assert ms > 0
    t = harness.measure_multiworld_phases(micro[0].params, sts, None, keys,
                                          reps=1)
    assert set(t) == {"pre_ms", "cycles_ms", "post_ms", "cycle_loop_share"}
    assert 0 < t["cycle_loop_share"] < 1
