"""Experimental spatial hardware (hw_type 3) replicating in the port:
the stock experimental set and ancestor (tests/test_experimental.py's
first case) run alongside the reference, update by update.

Tolerance: exact -- every state field byte for byte after every update.
"""

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_experimental import _worlds  # noqa: E402
from test_torch_placement import assert_states_equal  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_experimental_replicates_equal_reference(tmp_path):
    """The stock experimental set and ancestor replicate (the first
    divide lands at update 4): five updates, every field equal after
    each."""
    ref, port = _worlds("instset-experimental.cfg", tmp_path)
    assert port.params.hw_type == 3 and port.params.num_registers == 8
    ref.inject()
    port.inject()
    for u in range(5):
        ref.run_update()
        ref.update += 1
        port.run(max_updates=u + 1)
        assert_states_equal(ref.state, port.state, u)
    assert int(port.state.alive.sum()) > 1
