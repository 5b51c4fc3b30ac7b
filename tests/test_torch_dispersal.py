"""BIRTH_METHOD 11 and population control in the port: prng.poisson
against jax.random.poisson (every trip of both samplers), the dispersal
placement on a grid and a torus, POPULATION_CAP and POP_CAP_ELDEST in
the birth flush, the KillProb and SerialTransfer actions, and a 10x10
world with all of them against the reference.

Tolerance: exact -- samples and trip counts equal, every state field
byte for byte, the .dat files equal apart from the header's date line.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax._src import random as jrandom  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402

from test_torch_placement import (VALS, assert_states_equal,  # noqa: E402
                                  both_params, flush_both, pending_arrays,
                                  ref_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(seed):
    kr = jax.random.fold_in(jax.random.key(seed), 11)
    return kr, convert.key_from_data(jax.random.key_data(kr))


@pytest.mark.parametrize("lam", [0.0, 0.5, 1.0, 3.0, 9.99, 10.0, 12.0])
def test_poisson_equals_reference(lam):
    """prng.poisson on 4 keys over 3000 lanes equals jax.random.poisson:
    Knuth's sampler below 10, the transformed-rejection one from 10 up
    (its float32 lgamma included).  On one key each sampler's trip count
    is the reference's: Knuth's is the largest sample plus one, and at
    the ends of each branch's range the reference's sampler capped one
    trip short of it differs, capped at it agrees (the rate a
    compile-time constant, as in the birth flush)."""
    n = 3000
    draw = jax.jit(lambda k: jax.random.poisson(k, lam, (n,)))
    knuth = lam < 10
    port = prng._poisson_knuth if knuth else prng._poisson_rejection
    ref = jrandom._poisson_knuth if knuth else jrandom._poisson_rejection
    for seed in range(4):
        kr, kt = _keys(seed)
        want = np.asarray(draw(kr))
        assert (prng.poisson(kt, lam, (n,)).numpy() == want).all()
        if lam == 0.0 or seed >= 1:
            continue
        got, trips = port(kt, lam, (n,))
        if knuth:
            assert trips == want.max() + 1
        if lam not in (0.5, 9.99, 10.0, 12.0):
            continue
        for cap in (trips - 1, trips):
            r = np.asarray(jax.jit(lambda k: ref(
                k, jnp.full((n,), lam, jnp.float32), (n,),
                jnp.dtype("int32"), cap))(kr))
            t = port(kt, lam, (n,), max_iters=cap)[0]
            assert (t.numpy() == r).all()
            assert (r == want).all() == (cap == trips)


def test_lgamma_equals_reference():
    """The rejection sampler's lgamma(k + 1) over every k below 2**18
    and a stride up to 2**24: equal to the reference's compiled
    lax.lgamma."""
    k = np.concatenate([np.arange(2**18, dtype=np.float32),
                        np.arange(2**18, 2**24, 4093, dtype=np.float32)])
    want = np.asarray(jax.jit(lambda x: jax.lax.lgamma(x + 1))(k))
    got = prng.xla_lgamma_of_succ(torch.from_numpy(k)).numpy()
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize("geometry", [1, 2])
@pytest.mark.parametrize("rate", [2.5, 12.0])
def test_dispersal_flush_equals_reference(geometry, rate):
    """BIRTH_METHOD 11 at DISPERSAL_RATE 2.5 (Knuth) and 12 (rejection):
    up to 8 random hops, wrapped on the torus and clamped on the grid;
    every field equal."""
    vals = dict(VALS, BIRTH_METHOD=11, WORLD_GEOMETRY=geometry,
                DISPERSAL_RATE=rate)
    rp, tp = both_params(vals)
    arrays = pending_arrays(tp, seed=60 + geometry)
    out_r, out_t = flush_both(rp, tp, arrays, seed=geometry)
    assert_states_equal(out_r, out_t, geometry)
    assert int((out_t.birth_update == 13).sum()) >= 1


@pytest.mark.parametrize("cap", ["POPULATION_CAP", "POP_CAP_ELDEST"])
def test_population_cap_flush_equals_reference(cap):
    """A cap below the population: the excess dies at random (or eldest
    first), newborns spared; every field equal."""
    vals = dict(VALS, BIRTH_METHOD=0, **{cap: 12})
    rp, tp = both_params(vals)
    arrays = pending_arrays(tp, seed=70, alive_p=0.7)
    out_r, out_t = flush_both(rp, tp, arrays, seed=7)
    assert_states_equal(out_r, out_t, cap)
    born = out_t.alive & (out_t.birth_update == 13)
    assert int(out_t.alive.sum()) == max(12, int(born.sum()))


def _action_pair(tmp_path, action, args):
    from avida_tpu.world import World as RefWorld
    from avida_tpu_torch.world import World
    from avida_tpu import config as rconfig
    vals = dict(WORLD_X=10, WORLD_Y=10, RANDOM_SEED=5, TPU_SYSTEMATICS=0)
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    ref = RefWorld(cfg=rcfg, data_dir=str(tmp_path / "r"))
    port = World(cfg=convert.config_from_dict(vals),
                 data_dir=str(tmp_path / "p"), device="cpu")
    ref._action_InjectAll([])
    port._action_InjectAll([])
    alive = np.random.default_rng(3).random(100) < 0.8
    port.state = port.state.replace(alive=torch.from_numpy(alive))
    ref.state = ref_state(convert.state_to_arrays(port.state))
    getattr(ref, f"_action_{action}")(args)
    getattr(port, f"_action_{action}")(args)
    assert_states_equal(ref.state, port.state, (action, args))
    assert (np.asarray(jax.random.key_data(ref.key))
            == port.key.numpy()).all()
    return alive, port.state.alive.numpy()


@pytest.mark.parametrize("action,args", [
    ("KillProb", ["0.3"]), ("KillProb", []), ("SerialTransfer", ["25"]),
    ("SerialTransfer", ["200"])])
def test_population_actions_equal_reference(tmp_path, action, args):
    """KillProb and SerialTransfer on an 80%-full world: the same deaths
    and the same world key after the action's split."""
    before, after = _action_pair(tmp_path, action, args)
    assert not (after & ~before).any()
    if action == "SerialTransfer":
        assert after.sum() == min(int(args[0]), before.sum())
    else:
        assert 0 < after.sum() < before.sum()


DATS = ("average", "count", "tasks", "time")


def test_dispersal_world_equals_reference(tmp_path):
    """A 10x10 world on the micro-step engine: BIRTH_METHOD 11 on the
    torus, POPULATION_CAP 60 over an InjectAll soup, KillProb at update
    3 and SerialTransfer at update 5; the state after each of 6 updates
    and the .dat files equal."""
    from test_torch_world import _assert_same_dats, _pair
    vals = dict(WORLD_X=10, WORLD_Y=10, RANDOM_SEED=8, AVE_TIME_SLICE=100,
                TPU_SYSTEMATICS=0, TPU_USE_PALLAS=2, BIRTH_METHOD=11,
                DISPERSAL_RATE=1.5, POPULATION_CAP=60)
    events = ["u begin InjectAll", "u 3 KillProb 0.2",
              "u 5 SerialTransfer 30"] + [
        f"u 0:1:end Print{d.capitalize()}Data" for d in DATS]
    ref, port = _pair(tmp_path, vals, events)
    for u in range(1, 7):
        assert ref.run(max_updates=u) == port.run(max_updates=u)
        assert_states_equal(ref.state, port.state, u)
        if u == 1:
            assert int(port.state.alive.sum()) <= 60
    _assert_same_dats(tmp_path)
