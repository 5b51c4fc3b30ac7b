"""The .spop structured-population format in the port (utils/spop.py and
the SavePopulation / LoadPopulation actions) against the reference's
avida_tpu/utils/spop.py and World actions.

Tolerance: exact -- the .spop file byte for byte apart from its date
line, the .tasks.npy sidecar byte for byte, and the loaded population
(every organism fast-forwarded its gestation offset with micro-steps)
equal field by field.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.config import AvidaConfig  # noqa: E402
from avida_tpu.core.state import PopulationState as RefState  # noqa: E402
from avida_tpu.utils import spop as rspop  # noqa: E402
from avida_tpu.world import World as RefWorld  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.utils import spop as tspop  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

VALS = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=9, AVE_TIME_SLICE=100,
            TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0, TPU_USE_PALLAS=2,
            TPU_SYSTEMATICS=1)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 6x6 port world run 8 updates on the micro-step engine with a
    SavePopulation at update 8: the file, its sidecar and the state."""
    d = tmp_path_factory.mktemp("spop")
    w = World(cfg=convert.config_from_dict(VALS), data_dir=str(d / "port"),
              device="cpu")
    w.events = []
    for e in ("u begin InjectAll", "u 8 SavePopulation", "u 9 Exit"):
        w.add_event(e)
    w.run(max_updates=12)
    assert w.update == 9
    arrays = convert.state_to_arrays(w.state)
    return d, arrays, w


def _ref_world(data_dir):
    cfg = AvidaConfig()
    for k, v in VALS.items():
        cfg.set(k, v)
    w = RefWorld(cfg=cfg, data_dir=str(data_dir))
    w.events = []
    return w


def _lines(path):
    lines = open(path).read().splitlines()
    assert lines[3].startswith("# ")          # the date line
    return lines[:3] + lines[4:]


def test_spop_file_equals_reference(saved, tmp_path):
    """save_population on the same state: the same file but the date."""
    d, arrays, w = saved
    st_ref = RefState(**{k: (None if v is None else jnp.asarray(v))
                         for k, v in arrays.items()})
    rspop.save_population(str(tmp_path / "r.spop"), None, st_ref, 9)
    tspop.save_population(str(tmp_path / "p.spop"), None,
                          convert.state_from_arrays(arrays), 9)
    assert _lines(tmp_path / "r.spop") == _lines(tmp_path / "p.spop")
    assert len(_lines(tmp_path / "p.spop")) > 5


def test_save_population_action_writes_file_and_sidecar(saved):
    """The SavePopulation action: detail-8.spop and its .tasks.npy with
    the per-cell task-execution totals."""
    d, _, _ = saved
    path = d / "port" / "detail-8.spop"
    totals = np.load(str(path) + ".tasks.npy")
    assert totals.dtype == np.int32 and totals.shape[0] == 36
    orgs = tspop.load_population(str(path))
    assert orgs and {o["cell"] for o in orgs} <= set(range(36))
    want = rspop.load_population(str(path), None, None)
    assert len(orgs) == len(want)
    for a, b in zip(orgs, want):
        assert a.keys() == b.keys()
        assert a["genome"].tobytes() == b["genome"].tobytes()
        assert {k: v for k, v in a.items() if k != "genome"} \
            == {k: v for k, v in b.items() if k != "genome"}


def test_load_population_equals_reference(saved, tmp_path):
    """LoadPopulation of the port's file in both packages: the same
    population (genomes, per-genotype merit, each organism fast-forwarded
    gest_offset cycles keyed fold_in(key, s)), the sidecar's totals, the
    same key afterwards and the same genotype table."""
    d, _, _ = saved
    path = str(d / "port" / "detail-8.spop")
    ref = _ref_world(tmp_path / "r")
    ref.inject()
    ref._action_LoadPopulation([path])
    port = World(cfg=convert.config_from_dict(VALS),
                 data_dir=str(tmp_path / "p"), device="cpu")
    port.inject()
    port._action_LoadPopulation([path])
    got = convert.state_to_arrays(port.state)
    for k, v in got.items():
        a = getattr(ref.state, k)
        if a is None:
            assert v is None, k
            continue
        assert np.asarray(a).tobytes() == v.tobytes(), k
    assert np.asarray(jax.random.key_data(ref.key)).tolist() \
        == port.key.tolist()
    assert (port._task_exe_prev == np.asarray(ref._task_exe_prev)).all()
    assert port.systematics.to_snapshot() == ref.systematics.to_snapshot()
    offs = [o["gest_offset"] for o in tspop.load_population(path)]
    assert max(offs) > 0


def test_loaded_population_runs_equal_reference(saved, tmp_path):
    """A LoadPopulation event at update 0, then 2 updates in both
    packages: equal states."""
    d, _, _ = saved
    path = str(d / "port" / "detail-8.spop")
    from avida_tpu.config.events import parse_event_line
    ref = _ref_world(tmp_path / "r")
    ref.events = [parse_event_line(f"u begin LoadPopulation {path}")]
    port = World(cfg=convert.config_from_dict(VALS),
                 data_dir=str(tmp_path / "p"), device="cpu")
    port.events = []
    port.add_event(f"u begin LoadPopulation {path}")
    ref.run(max_updates=2)
    port.run(max_updates=2)
    assert port.update == 2 and port.num_organisms > 0
    got = convert.state_to_arrays(port.state)
    for k, v in got.items():
        a = getattr(ref.state, k)
        if a is not None:
            assert np.asarray(a).tobytes() == v.tobytes(), k
