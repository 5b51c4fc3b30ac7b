"""A world with TPU_FAULT's device kinds armed against avida_tpu's: a NaN
merit and a bit flipped in a fitness word, with the flight recorder on,
on the micro-step engine (the armed faults keep the run off the packed
chunk, in both packages).

Inputs: an 8x8 InjectAll soup (RANDOM_SEED 5, AVE_TIME_SLICE 100, births
in the fourth update), TPU_USE_PALLAS 2 in both packages.

Tolerance: exact -- every state field after each update and the drained
trace records.
"""

import json

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_world import _assert_same_state, _pair  # noqa: E402

VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5, AVE_TIME_SLICE=100,
            TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0,
            TPU_USE_PALLAS=2, TPU_TRACE=1, TPU_MAX_STRETCH=1,
            TPU_FAULT="nan:merit,cell=5@update=2;"
                      "bitflip:fitness,cell=7,bit=3@update=3")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fault_world_equals_reference(tmp_path):
    """Five updates: every field after each, the NaN at update 2 (the
    merit anomaly on cell 5 in the trace) and the flipped fitness bit
    at update 3 in both packages, the same engine report, and the same
    trace records."""
    ref, port = _pair(tmp_path, VALS, ["u begin InjectAll"])
    assert port.params.fault_nan == ("merit", 5, 2)
    assert port.params.fault_bitflip == ("fitness", 7, 3, 3)
    assert port.engine_report()["fallback_reason"].startswith(
        "Pallas cycle kernel off")
    for u in range(1, 6):
        ref.run(max_updates=u)
        port.run(max_updates=u)
        _assert_same_state(ref, port, u)
    recs = {}
    for side in ("ref", "port"):
        with open(tmp_path / side / "telemetry.jsonl") as f:
            recs[side] = [json.loads(line) for line in f]
    assert recs["ref"] == recs["port"]
    assert [5, 5, 1] in next(r["events"] for r in recs["port"]
                             if r["update"] == 2)
    assert torch.isnan(port.state.merit[5])
