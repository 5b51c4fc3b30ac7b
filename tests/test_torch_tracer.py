"""The flight recorder (TPU_TRACE) against avida_tpu's: the ring append
(ops/update._trace_append), the drain (observability/tracer.py), a traced
world on the micro-step engine with the offspring reversion test's host
events, and the recorder's off = on trajectory.

Inputs are drawn from seeded numpy generators; the world is the
reversion test's (tests/test_torch_reversion.py: 10x10, AVE_TIME_SLICE
100, an InjectAll soup, both packages' Test CPU replaced by one shared
numpy stand-in) with TPU_TRACE=1.

Tolerance: exact -- ring words, drained records and state fields equal.
"""

import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import avida_tpu.analyze.testcpu as rtestcpu  # noqa: E402
from avida_tpu.config import AvidaConfig  # noqa: E402
from avida_tpu.config.events import parse_event_line  # noqa: E402
from avida_tpu.core.state import state_field_names  # noqa: E402
from avida_tpu.observability import tracer as rtracer  # noqa: E402
from avida_tpu.ops import update as rupdate  # noqa: E402
from avida_tpu.world import World as RefWorld  # noqa: E402

import avida_tpu_torch.analyze.testcpu as ttestcpu  # noqa: E402
from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.observability import tracer as ttracer  # noqa: E402
from avida_tpu_torch.ops import update as tupdate  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

from test_torch_analyze import stand_in  # noqa: E402
from test_torch_placement import assert_states_equal  # noqa: E402

VALS = dict(WORLD_X=10, WORLD_Y=10, TPU_MAX_MEMORY=320, RANDOM_SEED=9,
            AVE_TIME_SLICE=100, TPU_MAX_STEPS_PER_UPDATE=100,
            COPY_MUT_PROB=0.02, TPU_SYSTEMATICS=0, TPU_USE_PALLAS=2,
            TPU_TRACE=1, TPU_TRACE_CAP=512, REVERT_FATAL=1.0,
            REVERT_DETRIMENTAL=0.5, STERILIZE_DETRIMENTAL=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Ring:
    """The five ring fields behind the `replace` both packages call."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def replace(self, **kw):
        return _Ring(**dict(self.__dict__, **kw))


def _rings(cap, rng):
    vals = {n: rng.integers(-5, 50, cap).astype(np.int32)
            for n in ("tr_update", "tr_cell", "tr_code", "tr_payload")}
    count = np.int32(rng.integers(0, 3 * cap))
    ref = _Ring(**{k: jnp.asarray(v) for k, v in vals.items()},
                tr_count=jnp.int32(count))
    port = _Ring(**{k: torch.from_numpy(v.copy()) for k, v in vals.items()},
                 tr_count=torch.tensor(count, dtype=torch.int32))
    return ref, port


@pytest.mark.parametrize("cap,n,appends", [
    (16, 10, 3),          # fits, then wraps
    (8, 40, 2),           # one batch wider than the ring (pre-drop)
    (32, 32, 6),          # many wraps
    (5, 3, 8),
])
def test_trace_append_equals_reference(cap, n, appends):
    """Appends of random masks, cells, codes and payloads from a random
    cursor: ring words and cursor equal after every append, overflow and
    the wider-than-ring batch included."""
    rng = np.random.default_rng(cap * 1000 + n)
    params = types.SimpleNamespace(trace_cap=cap)
    ref, port = _rings(cap, rng)
    for i in range(appends):
        mask = rng.random(n) < 0.6
        cells = rng.integers(0, 1000, n).astype(np.int32)
        pays = rng.integers(-9, 9, n).astype(np.int32)
        code = int(rng.integers(1, 7))
        ref = rupdate._trace_append(params, ref, jnp.asarray(mask),
                                    jnp.asarray(cells), code,
                                    jnp.asarray(pays), 40 + i)
        port = tupdate._trace_append(params, port, torch.from_numpy(mask),
                                     torch.from_numpy(cells), code,
                                     torch.from_numpy(pays), 40 + i)
        for f in ("tr_update", "tr_cell", "tr_code", "tr_payload",
                  "tr_count"):
            a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (i, f)


@pytest.mark.parametrize("count", [0, 7, 16, 17, 40, 160])
def test_ring_order_and_drain_equal_reference(tmp_path, count):
    """ring_order, and the drain of a ring holding `count` events (past
    the cap of 16 the oldest drop): the runlog lines, the drop count on
    the window's first record and the per-code totals, host events
    merged."""
    cap = 16
    assert ttracer.ring_order(count, cap).tolist() == \
        rtracer.ring_order(count, cap).tolist()
    rng = np.random.default_rng(count)
    ring = {"tr_update": rng.integers(0, 5, cap).astype(np.int32),
            "tr_cell": rng.integers(-1, 99, cap).astype(np.int32),
            "tr_code": rng.integers(1, 7, cap).astype(np.int32),
            "tr_payload": rng.integers(0, 1 << 20, cap).astype(np.int32),
            "tr_count": np.int32(count)}
    host = [(2, 5, ttracer.EV_REVERT, 3), (9, 1, ttracer.EV_STERILIZE, 2)]
    out = {}
    for name, mod, conv in (
            ("ref", rtracer, jnp.asarray),
            ("port", ttracer, lambda a: torch.from_numpy(np.array(a)))):
        world = types.SimpleNamespace(data_dir=str(tmp_path / name),
                                      telemetry=None, _dat_append=False)
        rec = mod.FlightRecorder(world)
        snap = {k: conv(v) for k, v in ring.items()}
        snap.update(update_at=10, host_events=list(host))
        rec.drain(snap)
        rec.close()
        path = tmp_path / name / "telemetry.jsonl"
        out[name] = (path.read_text() if path.exists() else None,
                     rec.to_snapshot())
    assert out["ref"] == out["port"]
    assert out["port"][1]["dropped_total"] == max(count - cap, 0)


def _both_traced(tmp_path, seed_line):
    """The reversion test's pair of worlds with the recorder on: the
    reference run to update 3 from `seed_line`, its state (rings
    included), update, reversion draws and drained records carried into
    a port world."""
    cfg = AvidaConfig()
    for k, v in VALS.items():
        cfg.set(k, v)
    ref = RefWorld(cfg=cfg, data_dir=str(tmp_path / "ref"))
    ref.events = [parse_event_line(seed_line)]
    ref.run(max_updates=3)
    port = World(cfg=convert.config_from_dict(VALS),
                 data_dir=str(tmp_path / "port"), device="cpu")
    port.events = []
    port.state = convert.state_from_arrays(
        {k: (None if getattr(ref.state, k) is None
             else np.asarray(getattr(ref.state, k)))
         for k in state_field_names()})
    port.update = ref.update
    port._revert_rng.bit_generator.state = \
        ref._revert_rng.bit_generator.state
    port.tracer.from_snapshot(ref.tracer.to_snapshot())
    return ref, port


def _trace_lines(path, since=3):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r["record"] == "trace"
            and r["update"] >= since]


def test_traced_reversion_world_equals_reference(tmp_path, monkeypatch):
    """Two updates of the traced InjectAll soup on the micro-step engine
    with reversion (shared Test CPU records): every field after each
    update, the drained {"record": "trace"} lines of updates 3-4
    and the recorder's totals equal the reference's; births, deaths,
    first tasks and the reversion's revert / sterilize host events are
    among them; metrics.prom carries the trace counters."""
    for mod in (rtestcpu, ttestcpu):
        monkeypatch.setattr(mod, "evaluate_genomes", stand_in)
    ref, port = _both_traced(tmp_path, "u begin InjectAll")
    for u in (4, 5):
        ref.run(max_updates=u)
        port.run(max_updates=u)
        assert_states_equal(ref.state, port.state, u)
    a = _trace_lines(tmp_path / "ref" / "telemetry.jsonl")
    b = _trace_lines(tmp_path / "port" / "telemetry.jsonl")
    assert a == b and len(b) == 2
    snap = port.tracer.to_snapshot()
    assert snap["code_totals"] == ref.tracer.to_snapshot()["code_totals"]
    codes = {c for r in b for _, c, _ in r["events"]}
    assert {ttracer.EV_BIRTH, ttracer.EV_DEATH, ttracer.EV_REVERT,
            ttracer.EV_STERILIZE} <= codes
    assert port.exporter is not None
    prom = (tmp_path / "port" / "metrics.prom").read_text()
    assert "avida_trace_events_total" in prom


def test_trace_on_equals_off(tmp_path):
    """The recorder changes no trajectory: the same port world with and
    without TPU_TRACE, on the micro-step engine and on the kernel route
    (the packed row-space body against the fused one), every field but
    the ring equal after 4 updates (births in the fourth)."""
    from avida_tpu_torch.core.state import TRACE_RING_FIELDS
    for pallas in (2, 0):
        runs = []
        for trace in (1, 0):
            vals = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5,
                        AVE_TIME_SLICE=100, TPU_SYSTEMATICS=0,
                        TPU_USE_PALLAS=pallas, TPU_TRACE=trace)
            w = World(cfg=convert.config_from_dict(vals), device="cpu",
                      data_dir=str(tmp_path / f"p{pallas}t{trace}"))
            w.events = []
            w.add_event("u begin InjectAll")
            w.run(max_updates=4)
            runs.append(w)
        on, off = runs
        assert int(on._total_births) > 0
        got = convert.state_to_arrays(on.state)
        want = convert.state_to_arrays(off.state)
        for k in got:
            if k in TRACE_RING_FIELDS:
                assert want[k] is None and got[k] is not None
                continue
            assert (got[k] is None) == (want[k] is None), k
            if got[k] is not None:
                assert got[k].tobytes() == want[k].tobytes(), (pallas, k)
        if pallas == 0:
            assert on.engine_report()["sub_path"] == "row-space"
            assert off.engine_report()["sub_path"] == "fused"
