"""StagedUpdate (observability/staged.py), the phase-fenced update that
telemetry runs, against update_step: on the micro-step engine and on the
kernel route, with the flight recorder and a device fault armed.

Inputs: evolved port states (an 8x8 InjectAll soup, RANDOM_SEED 5,
AVE_TIME_SLICE 100, run 3 updates; births from the fourth), the same
update keys to both.  update_step itself is held against avida_tpu in
the per-update engine's tests; telemetry.jsonl against the reference's
in tests/test_torch_telemetry.py.

Tolerance: exact -- every state field and the executed counts.
"""

import pytest

torch = pytest.importorskip("torch")

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.observability.staged import StagedUpdate  # noqa: E402
from avida_tpu_torch.observability.timeline import Timeline  # noqa: E402
from avida_tpu_torch.ops import update as tupdate  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5, AVE_TIME_SLICE=100,
            TPU_SYSTEMATICS=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _evolved(pallas, extra=None, updates=3):
    w = World(cfg=convert.config_from_dict(dict(
        VALS, TPU_USE_PALLAS=pallas, **(extra or {}))), device="cpu")
    w.events = []
    w.add_event("u begin InjectAll")
    w.run(max_updates=updates)
    return w


@pytest.mark.parametrize("pallas,extra", [
    (2, {}),                                       # micro-step engine
    (0, {}),                                       # kernel route
    (0, {"TPU_TRACE": 1, "TPU_FAULT": "nan:merit,cell=9@update=4"}),
    (2, {"TPU_FAULT": "bitflip:fitness,cell=3,bit=4@update=4"}),
])
def test_staged_update_equals_update_step(pallas, extra):
    """Two updates of an evolved world through StagedUpdate and through
    update_step with the same keys: every field equal, the executed
    counts equal; on the micro-step engine the dispatch mix sums to the
    executed count.  With the recorder and a fault armed, the staged
    trace and fault phases run as update_step's."""
    w = _evolved(pallas, extra)
    staged = StagedUpdate(w.params, w.neighbors)
    assert staged.kernel == (pallas == 0)
    a = b = w.state
    for u in (w.update, w.update + 1):
        key = prng.fold_in(w._run_key, u)
        a, ex_a, mix, _, _ = staged.run(a, key, u, Timeline("cpu"))
        b, ex_b = tupdate.update_step(w.params, b, key, u, w.neighbors)
        assert int(ex_a) == int(ex_b) > 0
        if pallas == 2 and not extra:
            assert int(mix.sum()) == int(ex_a)
        got, want = convert.state_to_arrays(a), convert.state_to_arrays(b)
        for k in got:
            assert (got[k] is None) == (want[k] is None), k
            if got[k] is not None:
                assert got[k].tobytes() == want[k].tobytes(), (u, k)
