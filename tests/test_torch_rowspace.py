"""The packed chunk's row-space body (ops/packed_chunk.py, taken under
TPU_TRACE or TPU_PACKED_FUSED=0) against its fused body: solo, and a
stacked batch on the row-space body with the flight recorder armed
(update_step_packed_worlds' trace gates) against the fused batch and
against a member's solo traced run.  The fused body itself is held
against avida_tpu in tests/test_torch_world.py, the traced row-space
world in tests/test_torch_tracer_rowspace.py.

Inputs: 8x8 InjectAll soups (RANDOM_SEED 5 and 6, AVE_TIME_SLICE 100:
births in the fourth update) on the kernel route's plain version.

Tolerance: exact -- every state field (the ring where both have one)
and the per-update vectors.
"""

import pytest

torch = pytest.importorskip("torch")

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.core.state import (TRACE_RING_FIELDS,  # noqa: E402
                                        stack_states, unstack_states)
from avida_tpu_torch.ops import update as tupdate  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5, AVE_TIME_SLICE=100,
            TPU_SYSTEMATICS=0, TPU_USE_PALLAS=0)
UPDATES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup(vals, seed):
    w = World(cfg=convert.config_from_dict(dict(vals, RANDOM_SEED=seed)),
              device="cpu")
    w.events = []
    w.add_event("u begin InjectAll")
    w.process_events()
    return w


def _assert_equal(a, b, skip=()):
    got, want = convert.state_to_arrays(a), convert.state_to_arrays(b)
    for k in got:
        if k in skip:
            continue
        assert (got[k] is None) == (want[k] is None), k
        if got[k] is not None:
            assert got[k].tobytes() == want[k].tobytes(), k


def test_row_space_body_equals_fused_solo():
    """TPU_PACKED_FUSED=0 against the fused body: every field and the
    per-update vectors, births among them."""
    w_f, w_r = _soup(VALS, 5), _soup(dict(VALS, TPU_PACKED_FUSED=0), 5)
    assert w_r.engine_report()["sub_path"] == "row-space"
    assert w_f.engine_report()["sub_path"] == "fused"
    st_f, out_f = tupdate.update_scan(w_f.params, w_f.state, UPDATES,
                                      w_f._run_key, 0, w_f.neighbors)
    st_r, out_r = tupdate.update_scan(w_r.params, w_r.state, UPDATES,
                                      w_r._run_key, 0, w_r.neighbors)
    _assert_equal(st_r, st_f)
    assert all(torch.equal(a, b) for a, b in zip(out_f, out_r))
    assert int(out_r[1].sum()) > 0                       # births


def test_traced_row_space_batch_equals_fused_batch_and_solo():
    """Two stacked worlds on the row-space body with the recorder armed
    against the same batch on the fused body (every field but the ring)
    and against world 0's solo traced run (every field, ring
    included)."""
    traced = [_soup(dict(VALS, TPU_TRACE=1, TPU_TRACE_CAP=256), s)
              for s in (5, 6)]
    keys = torch.stack([w._run_key for w in traced])
    tp = traced[0].params
    b_t, o_t = tupdate.update_scan_batched(
        tp, stack_states([w.state for w in traced]), UPDATES, keys, 0)
    plain = [_soup(VALS, s) for s in (5, 6)]
    b_f, o_f = tupdate.update_scan_batched(
        plain[0].params, stack_states([w.state for w in plain]), UPDATES,
        keys, 0)
    _assert_equal(b_t, b_f, skip=TRACE_RING_FIELDS)
    assert all(torch.equal(a, b) for a, b in zip(o_f, o_t))
    w = traced[0]
    solo, _ = tupdate.update_scan(tp, w.state, UPDATES, w._run_key, 0,
                                  w.neighbors)
    got = unstack_states(b_t)[0]
    _assert_equal(got, solo)
    assert int(got.tr_count) > 0
