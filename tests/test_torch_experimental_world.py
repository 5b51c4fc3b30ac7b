"""Experimental spatial hardware (hw_type 3) in the port, as worlds: a
10x10 predator-prey world run alongside the reference and resumed from
its generation (and the reverse), BIRTH_METHOD 7 on the real facing (a
parent facing off a bounded grid drops its offspring), and the refusal
of a batch of hw 3 worlds.  Replication, the seventh case of
tests/test_experimental.py, is tests/test_torch_experimental_replication.py.

Tolerance: exact -- every state field byte for byte after every flush
and update, the .dat files equal apart from the header's date line.
"""

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

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import load_instset  # noqa: E402
from avida_tpu_torch.config.environment import (  # noqa: E402
    default_logic9_environment as t_env)
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import birth as tbirth  # noqa: E402
from avida_tpu_torch.ops import interpreter as tinterp  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402

from test_torch_experimental import AVATARS, _key  # noqa: E402
from test_torch_mating import _instset_text, feature_world  # noqa: E402
from test_torch_placement import (assert_states_equal,  # noqa: E402
                                  pending_arrays, ref_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PREDATOR = ["look-ahead", "nop-C", "attack-prey", "nop-B", "move",
            "nop-B", "inc", "nop-C", "rotate-x", "nop-C", "attack-prey",
            "nop-B", "move", "nop-B"]


def predator_genome(names):
    return np.asarray([names.index(x) for x in PREDATOR], np.int8)


def seed_predators(port, every=16, offset=0):
    """The port world's state after InjectAll with a predator (forage
    target -2) in every `every`-th cell from `offset`."""
    st = port.state
    g = predator_genome(port.instset.inst_names)
    for c in range(offset, port.params.num_cells, every):
        st = tstate.seed_organism(port.params, st, g, prng.key(c), c)
    ft = st.forage_target.clone()
    ft[offset::every] = -2
    return st.replace(forage_target=ft)


def test_predator_prey_world_equal_reference(tmp_path):
    """A 10x10 world of experimental ancestors and predators in every
    sixteenth cell: every field and the .dat files equal the
    reference's over 4 updates, in the world run alongside it and in the
    one resumed from its generation at update 2, with kills and moves;
    the reference resumes the port's generation at update 4 to the same
    state, facing and forage targets included."""
    ref, port, res = feature_world(
        tmp_path, AVATARS, dict(RANDOM_SEED=11, PRED_PREY_SWITCH=0,
                                TPU_MAX_STEPS_PER_UPDATE=60),
        lambda w: seed_predators(w), stop=4, resume_at=2, hw_type=3)
    assert port.params.hw_type == 3
    # the other way: the reference resumes the port's generation
    from avida_tpu.world import World as RefWorld
    gen = res.save_checkpoint(str(tmp_path / "pck"))
    back = RefWorld(config_dir=str(tmp_path / "cfg"),
                    data_dir=str(tmp_path / "back"), overrides=list(dict(
                        WORLD_X=10, WORLD_Y=10, AVE_TIME_SLICE=100,
                        TPU_MAX_STEPS_PER_UPDATE=60, TPU_SYSTEMATICS=0,
                        TPU_USE_PALLAS=2, RANDOM_SEED=11,
                        PRED_PREY_SWITCH=0).items()))
    assert back.resume(str(tmp_path / "pck")) == 4, gen
    assert_states_equal(back.state, res.state, "port generation")
    ft = res.state.forage_target.numpy()
    alive = res.state.alive.numpy()
    assert (alive & (ft == -2)).any()
    assert int(alive.sum()) < 100                     # prey were killed
    assert (res.state.facing.numpy() != 0).any()


@pytest.mark.parametrize("geometry", [1, 2])
def test_birth_method_7_follows_the_facing(geometry):
    """BIRTH_METHOD 7 places each offspring one step along its parent's
    facing; on the bounded grid a parent facing off the world drops its
    offspring and resumes (the reference's fix of the livelock)."""
    vals = dict(WORLD_X=7, WORLD_Y=5, RANDOM_SEED=4, TPU_MAX_MEMORY=64,
                WORLD_GEOMETRY=geometry, BIRTH_METHOD=7)
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.load_instset(
        _write_avatars()), r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  load_instset(_write_avatars()), t_env())
    arrays = pending_arrays(tp, seed=70 + geometry, pending_p=0.8)
    rng = np.random.default_rng(geometry)
    arrays["facing"] = rng.integers(0, 8, tp.num_cells).astype(np.int32)
    arrays["forage_target"] = rng.integers(-2, 3, tp.num_cells).astype(
        np.int32)
    arrays["regs"] = np.zeros((tp.num_cells, 8), np.int32)
    kr, kt = _key(geometry, 13)
    nbr = jnp.asarray(rbirth.neighbor_table(rp.world_x, rp.world_y,
                                            rp.geometry))
    out_r = jax.jit(lambda s, k: rbirth.flush_births(
        rp, s, k, nbr, 13, use_off_tape=True))(ref_state(arrays), kr)
    out_t = tbirth.flush_births(tp, convert.state_from_arrays(arrays), kt,
                                13)
    assert_states_equal(out_r, out_t, geometry)
    assert (out_t.birth_update.numpy() == 13).any()
    rows = torch.arange(tp.num_cells, dtype=torch.int32)
    _, valid = tinterp.facing_step(tp, rows, torch.from_numpy(
        arrays["facing"]), torch.ones_like(rows))
    off_grid = arrays["divide_pending"] & arrays["alive"] & ~valid.numpy()
    assert off_grid.any() == (geometry == 1)
    assert not out_t.divide_pending.numpy()[off_grid].any()


def _write_avatars():
    import tempfile
    d = tempfile.mkdtemp()
    path = f"{d}/avatars.cfg"
    with open(path, "w") as f:
        f.write(_instset_text(AVATARS, hw_type=3))
    return path


def test_batch_of_experimental_worlds_refused_by_name(tmp_path):
    """A batch folds its worlds onto one organism axis, where facing and
    moves would cross world borders: hw 3 batches are refused by name
    (ROADMAP.md item 14) and never run."""
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    with pytest.raises(NotImplementedError, match="item 14"):
        MultiWorld.from_seeds([1, 2], overrides=list(dict(
            WORLD_X=6, WORLD_Y=6, INST_SET="experimental").items()),
            data_dir=str(tmp_path), device="cpu")
