"""A threaded world in the port against the reference: MAX_CPU_THREADS
2 under THREAD_SLICING_METHOD 1, every cell seeded with an ancestor
that forks once a gestation, run alongside the reference and resumed
from a generation the reference wrote (tests/test_torch_mating.py's
feature_world).

Tolerance: exact -- every state field byte for byte after every update,
the .dat files equal apart from the header's date line.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu_torch.config import default_instset  # noqa: E402

from test_torch_mating import feature_world, reseed  # noqa: E402
from test_torch_threads import NAMES  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def thread_ancestor(names):
    """The stock ancestor with fork-th and id-th after h-alloc, two filler
    nops dropped: the primary thread forks once a gestation and skips
    id-th; the new thread runs id-th and the same copy loop, writing the
    same sites one cycle behind, until the primary divides and the
    organism resets to one thread."""
    from avida_tpu_torch.world import default_ancestor
    anc = list(default_ancestor(default_instset()))
    anc[1:1] = [names.index("fork-th"), names.index("id-th")]
    del anc[7:9]
    return np.asarray(anc, np.int8)


def test_thread_world_equals_reference(tmp_path):
    """MAX_CPU_THREADS 2, THREAD_SLICING_METHOD 1, the forking ancestor
    in every cell: threads fork, the state after each of 6 updates and
    the .dat files equal the reference's, in the world run alongside it
    and in the one resumed from its generation at update 5."""
    anc = thread_ancestor(NAMES)
    ref, port, res = feature_world(
        tmp_path, NAMES, dict(RANDOM_SEED=14, MAX_CPU_THREADS=2,
                              THREAD_SLICING_METHOD=1),
        lambda w: reseed(w, [anc]), stop=6, resume_at=5)
    assert int(port._total_births) > 0
    assert port.state.t_alive.any()
