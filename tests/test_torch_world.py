"""The slice as a whole: the port's World.run against the reference's,
same config and seed.  The reference runs its packed-resident engine with
the Pallas kernel in interpret mode on one shard.

Tolerance: exact -- PopulationState equal field by field (byte for byte)
at every chunk boundary, and the four .dat files byte-identical apart
from the header's date line.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from avida_tpu.config import AvidaConfig  # noqa: E402
from avida_tpu.config.events import parse_event_line  # noqa: E402
from avida_tpu.core.state import (PopulationState,  # noqa: E402
                                  state_field_names)
from avida_tpu.world import World as RefWorld  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.core.state import seed_organism  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

# IO reads x; push/pop copies it to CX; nand/IO output ~x (NOT), then
# ~(x & y) (NAND), ...
TASK_GENOME = ["IO", "push", "pop", "nop-C", "nand", "IO", "nand", "IO",
               "nand", "IO", "swap", "IO", "inc", "IO"] + ["swap-stk"] * 6

DATS = ("average", "count", "tasks", "time")


def _pair(tmp_path, vals, events):
    cfg = AvidaConfig()
    for k, v in vals.items():
        cfg.set(k, v)
    ref = RefWorld(cfg=cfg, data_dir=str(tmp_path / "ref"))
    ref.events = [parse_event_line(e) for e in events]
    port = World(cfg=convert.config_from_dict(vals),
                 data_dir=str(tmp_path / "port"), device="cpu")
    port.events = []
    for e in events:
        port.add_event(e)
    return ref, port


def _assert_same_state(ref, port, where):
    got = convert.state_to_arrays(port.state)
    for k in state_field_names():
        a, b = getattr(ref.state, k), got[k]
        if a is None:
            assert b is None, (where, k)
            continue
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, (where, k)
        assert a.tobytes() == b.tobytes(), (where, k)


def _assert_same_dats(tmp_path):
    for name in DATS:
        with open(tmp_path / "ref" / f"{name}.dat") as f:
            a = f.read().splitlines()
        with open(tmp_path / "port" / f"{name}.dat") as f:
            b = f.read().splitlines()
        assert len(a) == len(b) > 0, name
        assert a[1].startswith("# ") and b[1].startswith("# ")   # dates
        assert a[:1] + a[2:] == b[:1] + b[2:], name


def _reseed_mixed(ref, port):
    """After update 0's InjectAll: a third of the cells get a
    task-performing program, a third random genomes (seeded in the port,
    carried into the reference), so tasks and rewards reach the .dat
    files."""
    ref.process_events()
    port.process_events()
    _reseed_port(port)
    ref.state = PopulationState(**{
        k: (None if v is None else jnp.asarray(v))
        for k, v in convert.state_to_arrays(port.state).items()})


def _reseed_port(port):
    """_reseed_mixed's reseeding of the port world's current state."""
    names = port.instset.inst_names
    task = np.asarray([names.index(n) for n in TASK_GENOME], np.int8)
    rng = np.random.default_rng(7)
    st = port.state
    for c in range(port.params.num_cells):
        if c % 3 == 1:
            st = seed_organism(port.params, st, task, prng.key(c), c)
        elif c % 3 == 2:
            g = rng.integers(0, len(names), rng.integers(30, 90))
            st = seed_organism(port.params, st, g.astype(np.int8),
                               prng.key(c), c)
    port.state = st


def _run_ladder(tmp_path, vals, every, stops, mixed=False):
    events = ["u begin InjectAll"] + [
        f"u 0:{every}:end Print{d.capitalize()}Data" for d in DATS]
    ref, port = _pair(tmp_path, vals, events)
    if mixed:
        _reseed_mixed(ref, port)
    for u in stops:
        n_ref = ref.run(max_updates=u)
        n_port = port.run(max_updates=u)
        assert n_ref == n_port, u
        assert ref.update == port.update == u
        _assert_same_state(ref, port, u)
    _assert_same_dats(tmp_path)
    assert int(port._total_births) == int(ref._total_births)
    return int(port._total_births), port


VALS = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=3, AVE_TIME_SLICE=30,
            TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1,
            TPU_COMPILE_CACHE=0)


def test_world_run_equals_reference_fast(tmp_path):
    """A few updates, compared at every chunk boundary: the first divides
    (and births) land in the second chunk."""
    births, _ = _run_ladder(tmp_path, VALS, 8, (8, 16))
    assert births > 0
    assert os.path.exists(tmp_path / "port" / "average.dat")


def test_world_run_equals_reference_mixed_capped(tmp_path):
    """Task-performing and random programs under an odd per-update step
    cap: rewards, budget banking and the cap's extra cycle, a few
    updates."""
    births, port = _run_ladder(
        tmp_path, dict(VALS, TPU_MAX_STEPS_PER_UPDATE=25), 8, (8, 16),
        mixed=True)
    assert births > 0
    assert int((port.state.task_exe_total > 0).any(dim=0).sum()) >= 2


@pytest.mark.slow
def test_world_run_equals_reference_long(tmp_path):
    """Some hundred updates with births across chunk boundaries."""
    vals = dict(VALS, WORLD_X=8, WORLD_Y=8, RANDOM_SEED=21)
    births, _ = _run_ladder(tmp_path, vals, 16, tuple(range(16, 177, 16)))
    assert births > 3 * 64          # several generations
