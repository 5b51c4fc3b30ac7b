"""The energy model in the port: its float32 arithmetic (energy to
merit, the child's share, the parent's remainder) against the
reference's compiled functions at the rounding edges, micro_step with
per-instruction energy costs, the birth flush's energy split (with
BIRTH_METHOD 9 and 10 reading the energy used), and a 10x10 world with
ENERGY_GIVEN_ON_INJECT 1000 and BIRTH_METHOD 10 -- run alongside the
reference and resumed from its generation.

Tolerance: exact -- every value and state field byte for byte, the .dat
files equal apart from the header's date line.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.ops import birth as rbirth  # noqa: E402
from avida_tpu.ops import interpreter as rinterp  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.ops import birth as tbirth  # noqa: E402
from avida_tpu_torch.ops import interpreter as tinterp  # noqa: E402

from test_torch_cycles_semantics import _both_params  # noqa: E402
from test_torch_mating import (_instset_text, feature_world,  # noqa: E402
                               reseed)
from test_torch_micro_step import (N, VALS, _assert_states_equal,  # noqa
                                   _random_arrays, _ref_state, _ref_step)
from test_torch_placement import (assert_states_equal,  # noqa: E402
                                  both_params, pending_arrays, ref_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADS = list(default_instset().inst_names)
COSTS = {"h-copy": 0.75, "IO": 3.3, "nand": 1.1, "h-divide": 2.0,
         "inc": 0.1}


def _energies(n=60000, seed=0):
    """Energies across magnitudes, many at float32 rounding edges."""
    rng = np.random.default_rng(seed)
    e = (rng.random(n) * 10.0 ** rng.integers(-3, 6, n)).astype(np.float32)
    e[:64] = [0.0, 1.0, 1000.0, 3.0, 7.0, 1e-30] + list(
        np.nextafter(np.float32(1000.0), np.float32(0), dtype=np.float32)
        * np.ones(58, np.float32))
    return e


@pytest.mark.parametrize("over", [
    {}, {"NUM_CYCLES_EXC_BEFORE_0_ENERGY": 300,
         "FRAC_PARENT_ENERGY_GIVEN_TO_ORG_AT_BIRTH": 0.3,
         "FRAC_ENERGY_DECAY_AT_ORG_BIRTH": 0.1,
         "ENERGY_GIVEN_AT_BIRTH": 7.3},
    {"NUM_CYCLES_EXC_BEFORE_0_ENERGY": 7, "ENERGY_CAP": 333.3,
     "FRAC_PARENT_ENERGY_GIVEN_TO_ORG_AT_BIRTH": 0.7,
     "FRAC_ENERGY_DECAY_AT_ORG_BIRTH": 0.2, "ENERGY_GIVEN_AT_BIRTH": 1.1},
    {"FIX_METABOLIC_RATE": 0.37}])
def test_energy_arithmetic_equals_reference(over):
    """Merit from energy, the child's share and the parent's remainder on
    60000 energies: equal to the reference's jitted expressions (its
    simplifier folds each product's constants into one, and the child's
    share is one fused multiply-add)."""
    rp, tp = both_params(dict(VALS, ENERGY_ENABLED=1, **over))
    e = _energies()

    def ref(x):
        keep = 1.0 - rp.frac_energy_decay_birth
        child = x * keep * rp.frac_parent_energy + rp.energy_given_at_birth
        if rp.energy_cap > 0:
            child = jnp.minimum(child, rp.energy_cap)
        return (rinterp.convert_energy_to_merit(rp, x), child,
                x * keep * (1.0 - rp.frac_parent_energy))

    want = jax.jit(ref)(e)
    te = torch.from_numpy(e)
    got = (tinterp.convert_energy_to_merit(tp, te),
           tinterp.child_energy(tp, te), tinterp.parent_energy_after(tp, te))
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()


def test_energy_micro_step_equals_reference(tmp_path):
    """Six cycles on a random state under an instruction set with energy
    costs: the charge, floored at the store, energy_spent, and merit from
    energy at divide -- every field equal."""
    path = tmp_path / "i.cfg"
    path.write_text(_instset_text(HEADS, COSTS))
    rp, tp = _both_params(str(path), dict(
        VALS, ENERGY_ENABLED=1, NUM_CYCLES_EXC_BEFORE_0_ENERGY=300,
        COPY_MUT_PROB=0.02))
    assert tp.inst_energy_cost
    arrays = _random_arrays(tp, HEADS, 3)
    rng = np.random.default_rng(31)
    arrays["energy"] = np.where(rng.random(N) < 0.3, rng.random(N) * 2,
                                rng.random(N) * 500).astype(np.float32)
    arrays["energy_spent"] = (rng.random(N) * 50).astype(np.float32)
    st_r, st_t = _ref_state(arrays), convert.state_from_arrays(arrays)
    step = _ref_step(rp)
    for c in range(6):
        mask = rng.random(N) < 0.9
        k = jax.random.fold_in(jax.random.key(6), c)
        st_r = step(st_r, k, jnp.asarray(mask))
        st_t = tinterp.micro_step(
            tp, st_t, convert.key_from_data(jax.random.key_data(k)),
            torch.from_numpy(mask))
        _assert_states_equal(st_r, st_t, c)
    spent = st_t.energy_spent.numpy() - arrays["energy_spent"]
    assert (spent > 0).any() and (st_t.energy.numpy() == 0).any()


@pytest.mark.parametrize("bm", [0, 9, 10])
def test_energy_flush_equals_reference(bm):
    """The flush with the energy model (jitted reference): the child's
    share and merit, the winning parent's remainder and merit, and
    BIRTH_METHOD 9 and 10 ranking cells by energy used; every field
    equal."""
    vals = dict(WORLD_X=7, WORLD_Y=5, RANDOM_SEED=4, TPU_MAX_MEMORY=64,
                ENERGY_ENABLED=1, BIRTH_METHOD=bm, WORLD_GEOMETRY=1,
                FRAC_PARENT_ENERGY_GIVEN_TO_ORG_AT_BIRTH=0.3,
                FRAC_ENERGY_DECAY_AT_ORG_BIRTH=0.1,
                ENERGY_GIVEN_AT_BIRTH=7.3, NUM_CYCLES_EXC_BEFORE_0_ENERGY=300)
    rp, tp = both_params(vals)
    arrays = pending_arrays(tp, seed=100 + bm)
    rng = np.random.default_rng(bm)
    arrays["energy"] = (rng.random(tp.num_cells) * 900).astype(np.float32)
    arrays["energy_spent"] = (rng.random(tp.num_cells) * 90).astype(
        np.float32)
    nbr = jnp.asarray(rbirth.neighbor_table(rp.world_x, rp.world_y,
                                            rp.geometry))
    kr = jax.random.fold_in(jax.random.key(bm), 13)
    out_r = jax.jit(lambda s, k: rbirth.flush_births(
        rp, s, k, nbr, 13, use_off_tape=True))(ref_state(arrays), kr)
    out_t = tbirth.flush_births(tp, convert.state_from_arrays(arrays),
                                convert.key_from_data(
                                    jax.random.key_data(kr)), 13)
    assert_states_equal(out_r, out_t, bm)
    born = out_t.birth_update.numpy() == 13
    assert born.any()
    assert (out_t.energy.numpy()[born] != arrays["energy"][born]).all()


def test_energy_world_equals_reference(tmp_path):
    """ENERGY_ENABLED 1, ENERGY_GIVEN_ON_INJECT 1000 and BIRTH_METHOD 10
    (the reference's tests/test_energy.py world) with energy costs on
    four instructions, every cell seeded: births happen, and the state
    after each of 6 updates and the .dat files equal the reference's,
    in the world run alongside it and in the one resumed from its
    generation at update 4.  Each cell is seeded through Inject's path,
    which gives the organism its energy (InjectAll's does not)."""
    from avida_tpu_torch.world import default_ancestor

    def seed(w):
        return reseed(w, [default_ancestor(w.instset)])
    ref, port, res = feature_world(
        tmp_path, HEADS, dict(RANDOM_SEED=7, ENERGY_ENABLED=1,
                              ENERGY_GIVEN_ON_INJECT=1000.0,
                              BIRTH_METHOD=10),
        seed, stop=6, resume_at=4, energy_cost=COSTS)
    assert int(port._total_births) > 0
    assert (port.state.energy_spent.numpy() > 0).any()
