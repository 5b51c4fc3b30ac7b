"""The micro-step cycle engine over a batch of worlds (TPU_USE_PALLAS=2):
the port's folded batch (ops/update.mw_fold_cycles_xla, through
update_scan_batched) against the reference's multiworld_scan, whose cycle
loop is world-folded the same way; each world of the batch against its
solo update scan; and a MultiWorld whose members equal their solo
World.run.  The worlds start from evolved 6x6 states, so births land in
the window.

Tolerance: exact -- every state field and output vector byte for byte,
accumulators equal, .dat files byte-identical apart from the header's
date line.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.config.environment import (  # noqa: E402
    default_logic9_environment as r_env)
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.ops import birth as rbirth  # noqa: E402
from avida_tpu.parallel.multiworld import multiworld_scan  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.config.environment import (  # noqa: E402
    default_logic9_environment as t_env)
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import cycles as tpc  # noqa: E402
from avida_tpu_torch.ops import update as tupd  # noqa: E402
from avida_tpu_torch.parallel.multiworld import MultiWorld  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

VALS = dict(WORLD_X=6, WORLD_Y=6, AVE_TIME_SLICE=30, TPU_KERNEL_SHARDS=1,
            TPU_COMPILE_CACHE=0, TPU_SYSTEMATICS=0)
SEEDS = (3, 8, 13)
EVOLVE = 20
DATS = ("average", "count", "tasks", "time")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def evolved():
    """Three 6x6 worlds run EVOLVE updates on the kernel route: their
    states and run keys."""
    sts, keys = [], []
    for seed in SEEDS:
        w = World(cfg=convert.config_from_dict(dict(
            VALS, RANDOM_SEED=seed, TPU_USE_PALLAS=1)), data_dir=None,
            device="cpu")
        w.events = []
        w.add_event("u begin InjectAll")
        w.run(max_updates=EVOLVE)
        sts.append(w.state)
        keys.append(w._run_key)
    return sts, torch.stack(keys)


def _both_params(vals):
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.default_instset(), r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  default_instset(), t_env())
    return rp, tp


def test_update_scan_batched_fold_equals_reference(evolved):
    """W = 3, four updates: the folded micro-step batch equals the
    reference's multiworld_scan -- every field and the seven [W, 4]
    output vectors, trips included -- and each world equals its solo
    update_scan."""
    sts, keys = evolved
    bst = tstate.stack_states(sts)
    rp, tp = _both_params(dict(VALS, TPU_USE_PALLAS=2))
    rb = rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v))
        for k, v in convert.state_to_arrays(bst).items()})
    rkeys = jax.random.wrap_key_data(jnp.asarray(keys.numpy().astype(
        np.uint32)))
    nb = jnp.asarray(rbirth.neighbor_table(6, 6, 2))
    rb2, routs = multiworld_scan(rp, rb, 4, rkeys, nb, jnp.int32(EVOLVE))
    tpc.reset_launches()
    tb2, touts = tupd.update_scan_batched(tp, bst, 4, keys, EVOLVE)
    assert tpc.LAUNCHES == 0
    got = convert.state_to_arrays(tb2)
    for k in rstate.state_field_names():
        a = getattr(rb2, k)
        assert (a is None and got[k] is None) or \
            np.asarray(a).tobytes() == got[k].tobytes(), k
    for a, b in zip(routs, touts):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert np.asarray(routs[1]).sum() > 0          # births in the window
    trips = np.asarray(routs[6])
    assert (trips != trips.max(axis=0)).any()      # worlds run masked
    for w, st in enumerate(sts):
        solo, _ = tupd.update_scan(tp, st, 4, keys[w], EVOLVE)
        for k, v in convert.state_to_arrays(solo).items():
            assert v is None or v.tobytes() == got[k][w].tobytes(), (w, k)


def test_multiworld_fold_members_equal_solo(evolved, tmp_path):
    """A W = 2 MultiWorld with TPU_USE_PALLAS=2 (the fold engine) from two
    evolved states: each member's state, accumulators, instruction counts
    and .dat files equal its solo World.run."""
    sts, _ = evolved
    vals = dict(VALS, TPU_USE_PALLAS=2)
    ev = [f"u 0:1:end Print{d.capitalize()}Data" for d in DATS]

    def world(i, d):
        w = World(cfg=convert.config_from_dict(dict(
            vals, RANDOM_SEED=SEEDS[i])), data_dir=str(tmp_path / d),
            device="cpu")
        w.events = []
        for e in ev:
            w.add_event(e)
        w.state = sts[i]
        w.update = EVOLVE
        return w

    solo = [world(i, f"solo{i}") for i in (0, 1)]
    for w in solo:
        w.run(max_updates=EVOLVE + 4)
    mw = MultiWorld([world(i, f"mw{i}") for i in (0, 1)])
    mw.run(max_updates=EVOLVE + 4)
    assert mw.engine == "per-update"
    for a, b in zip(solo, mw.worlds):
        sa, sb = (convert.state_to_arrays(x.state) for x in (a, b))
        for k in sa:
            assert sa[k] is None or sa[k].tobytes() == sb[k].tobytes(), k
        assert float(a._avida_time) == float(b._avida_time)
        assert int(a._total_births) == int(b._total_births)
        assert a._flush_exec() == b._flush_exec()
        for d in DATS:
            with open(os.path.join(a.data_dir, f"{d}.dat")) as f:
                x = f.read().splitlines()
            with open(os.path.join(b.data_dir, f"{d}.dat")) as f:
                y = f.read().splitlines()
            assert x[:1] + x[2:] == y[:1] + y[2:], d
    assert sum(int(w._total_births) for w in mw.worlds) > 0
