"""The offspring reversion / sterilization test (World._apply_reversion,
Divide_TestFitnessMeasures) against the reference's avida_tpu/world.py.

The world is the reference test's (tests/test_reversion.py: 10x10,
RANDOM_SEED 9, AVE_TIME_SLICE 100, COPY_MUT_PROB 0.02,
TPU_SYSTEMATICS 0) with REVERT_FATAL 1, REVERT_DETRIMENTAL 0.5 and
STERILIZE_DETRIMENTAL 0.5, on the micro-step engine (TPU_USE_PALLAS 2)
in both packages.  The reference world runs to update 3, its state
(and its reversion draw stream) is carried into a port world, and both
run on update by update, the states compared field by field after each:

  * with both packages' Test CPU replaced by one shared numpy stand-in
    (test_torch_analyze.stand_in), so both caches hold the same records:
    an InjectAll soup, 40-odd newborns an update, every category and
    the kill fallback of a newborn whose parent cell was overwritten;
  * end to end, each package's real Test CPU, over the first birth of
    one injected ancestor.

Tolerance: exact -- every state field byte for byte, the records equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import avida_tpu.analyze.testcpu as rtestcpu  # noqa: E402
from avida_tpu.config import AvidaConfig  # noqa: E402
from avida_tpu.config.events import parse_event_line  # noqa: E402
from avida_tpu.core.state import state_field_names  # noqa: E402
from avida_tpu.world import World as RefWorld  # noqa: E402

import avida_tpu_torch.analyze.testcpu as ttestcpu  # noqa: E402
from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

from test_torch_analyze import stand_in  # noqa: E402
from test_torch_placement import assert_states_equal  # noqa: E402

VALS = dict(WORLD_X=10, WORLD_Y=10, TPU_MAX_MEMORY=320, RANDOM_SEED=9,
            AVE_TIME_SLICE=100, TPU_MAX_STEPS_PER_UPDATE=100,
            COPY_MUT_PROB=0.02, TPU_SYSTEMATICS=0, TPU_USE_PALLAS=2,
            REVERT_FATAL=1.0, REVERT_DETRIMENTAL=0.5,
            STERILIZE_DETRIMENTAL=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_worlds(tmp_path, seed_line):
    """The reference world run to update 3 from `seed_line`, and a port
    world holding its state, update and reversion draw stream."""
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
    assert port._revert_on and not port._chunkable()
    return ref, port


def _records_equal(ref, port):
    rc, tc = ref.test_metrics._cache, port.test_metrics._cache
    assert rc.keys() == tc.keys()
    for k in rc:
        for f in rc[k]:
            assert np.asarray(rc[k][f]).tobytes() == \
                np.asarray(tc[k][f]).tobytes(), f
    assert ref.test_metrics.evaluations == port.test_metrics.evaluations


def test_reversion_updates_equal_reference(tmp_path, monkeypatch):
    """Three updates of an InjectAll soup with reversion, on shared
    records: every field after each update, the draw streams and the
    caches equal; the updates revert, sterilize and kill."""
    for mod in (rtestcpu, ttestcpu):
        monkeypatch.setattr(mod, "evaluate_genomes", stand_in)
    ref, port = both_worlds(tmp_path, "u begin InjectAll")
    seen = {"newborns": 0, "reverted": 0, "sterilized": 0, "killed": 0}
    for u in (4, 5, 6):
        ref.run(max_updates=u)
        port.run(max_updates=u)
        assert_states_equal(ref.state, port.state, u)
        assert ref._revert_rng.bit_generator.state == \
            port._revert_rng.bit_generator.state
        rec = port.last_reversion
        for k in seen:
            seen[k] += rec[k]
        if rec["reverted"]:
            # a reverted newborn carries its parent's genome
            c = rec["cells"][rec["revert"]]
            p = rec["parents"][rec["revert"]]
            assert (port.state.genome[c] == port.state.genome[p]).all()
    _records_equal(ref, port)
    assert seen["newborns"] > 50 and seen["reverted"] > 0
    assert seen["sterilized"] > 0 and seen["killed"] > 0


def test_reversion_end_to_end_equals_reference(tmp_path):
    """The first birth of one injected ancestor through each package's
    real Test CPU: the state after the update and the cached records
    equal."""
    ref, port = both_worlds(tmp_path, "u begin Inject")
    ref.run(max_updates=4)
    port.run(max_updates=4)
    assert port.last_reversion["newborns"] == 1
    assert_states_equal(ref.state, port.state, 4)
    _records_equal(ref, port)
    assert len(port.test_metrics) == 2
