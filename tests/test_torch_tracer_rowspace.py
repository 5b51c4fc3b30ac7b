"""The packed chunk's row-space body (ops/packed_chunk.py, taken under
TPU_TRACE or TPU_PACKED_FUSED=0): a traced kernel-route world against
avida_tpu's in interpret mode, the one fast cross-check (the row-space
body against the fused one: tests/test_torch_rowspace.py).

Inputs: an 8x8 InjectAll soup (RANDOM_SEED 5, AVE_TIME_SLICE 100:
births from the fourth update), TPU_USE_PALLAS 1 and TPU_KERNEL_SHARDS
1 in the reference (its interpret mode), the plain kernel version in the
port.

Tolerance: exact -- every state field, ring words and drained records.
"""

import json

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu.ops import packed_chunk as rpk  # noqa: E402

from test_torch_world import _assert_same_state, _pair  # noqa: E402

VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5, AVE_TIME_SLICE=100,
            TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1,
            TPU_COMPILE_CACHE=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_traced_row_space_world_equals_reference(tmp_path):
    """Eight updates in one chunk on the row-space body with TPU_TRACE=1
    (the reference in interpret mode): every field, ring included, and
    the drained trace records equal; the metrics heartbeat is
    published."""
    ref, port = _pair(tmp_path, dict(VALS, TPU_TRACE=1),
                      ["u begin InjectAll"])
    assert ref.run(max_updates=8) == port.run(max_updates=8)
    _assert_same_state(ref, port, 8)
    rep = port.engine_report()
    assert rep["sub_path"] == "row-space"
    assert rep == rpk.engine_report(ref.params)
    recs = {}
    for side in ("ref", "port"):
        with open(tmp_path / side / "telemetry.jsonl") as f:
            recs[side] = [json.loads(line) for line in f]
    assert recs["ref"] == recs["port"]
    births = sum(1 for r in recs["port"] for _, c, _ in r["events"]
                 if c == 1)
    assert births == int(port._total_births) > 0
    assert (tmp_path / "port" / "metrics.prom").exists()
