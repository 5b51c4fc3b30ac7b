"""Demes: avida_tpu_torch/ops/demes.py, the deme branches of the birth
flush, the germline seeding and deme worlds, against the reference's
avida_tpu on the same inputs.

  * prng.xla_cumsum / prng.choice against `jnp.cumsum` and
    `jax.random.choice` (the roulette of CompeteDemes);
  * deme_fitness (competition types 0-6), compete_demes and
    replicate_demes (triggers 0-5, with and without germlines) on random
    evolved-looking states;
  * flush_births with demes: deme-local candidates, FULL_SOUP_RANDOM and
    DEME_RANDOM inside the deme, absolute targets of methods 5, 7 and 8
    collapsing to the parent, migration methods 0, 1, 2 and 4, the
    per-deme birth tally; method 3 refused by both packages;
  * init_population seeding every deme's germline;
  * a 4-deme world on the kernel route (the reference in interpret mode)
    with ReplicateDemes and CompeteDemes over germlines, a deme world
    whose reactions draw on deme pools with a predicate-triggered
    replication on the micro-step engine, and a resource and deme world
    saved and resumed.

Tolerance: exact -- every state field byte for byte.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.config.environment import (  # noqa: E402
    default_logic9_environment as r_env)
from avida_tpu.config.events import parse_event_line  # noqa: E402
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.ops import demes as rdemes  # noqa: E402
from avida_tpu.world import World as RefWorld  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.config.environment import (  # noqa: E402
    default_logic9_environment as t_env)
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import cycles as tpc  # noqa: E402
from avida_tpu_torch.ops import demes as tdemes  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

from test_torch_placement import (assert_states_equal,  # noqa: E402
                                  flush_both, pending_arrays, ref_state)
from test_torch_world import _assert_same_state, _reseed_port  # noqa: E402

VALS = dict(WORLD_X=8, WORLD_Y=6, RANDOM_SEED=4, TPU_MAX_MEMORY=64,
            TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1, NUM_DEMES=4,
            DEMES_MAX_BIRTHS=3, DEMES_MAX_AGE=5, GERMLINE_COPY_MUT=0.2)
MATRIX = [[0, 1, 2, 1], [3, 0, 1, 0.5], [1, 1, 0, 1], [0.2, 0, 4, 0]]


def _both(vals):
    rcfg = rconfig.AvidaConfig()
    tcfg = convert.config_from_dict(vals)
    for k, v in vals.items():
        rcfg.set(k, v)
    if int(vals.get("DEMES_MIGRATION_METHOD", 0)) == 4:
        rcfg._migration_matrix = tcfg._migration_matrix = MATRIX
    rp = rstate.make_world_params(rcfg, rconfig.default_instset(), r_env())
    tp = tstate.make_world_params(tcfg, default_instset(), t_env())
    return rp, tp


def _deme_arrays(tp, seed):
    """pending_arrays plus deme state: birth tallies, ages, germlines of
    random lengths, deme pool levels and fitness values."""
    a = pending_arrays(tp, seed)
    rng = np.random.default_rng(seed + 100)
    D, L = tp.num_demes, tp.max_memory
    a["deme_birth_count"][:] = rng.integers(0, 7, D)
    a["deme_age"][:] = rng.integers(0, 9, D)
    glen = rng.integers(20, L, D)
    a["germ_len"][:] = glen
    a["germ_mem"][:] = np.where(np.arange(L)[None, :] < glen[:, None],
                                rng.integers(0, tp.num_insts, (D, L)), 0)
    a["fitness"][:] = (rng.random(tp.num_cells) * 10.0
                       ** rng.integers(-2, 2, tp.num_cells))
    return a


# ---- the roulette's arithmetic ----

@pytest.mark.parametrize("n", [1, 4, 16, 17, 33, 300])
def test_xla_cumsum_and_choice_equal_jax(n):
    """jnp.cumsum on the CPU: in order up to 16 values, else rows of 16
    with the rows' running totals added back; jax.random.choice with p:
    searchsorted (left) of total * (1 - uniform)."""
    rng = np.random.default_rng(n)
    for t in range(10):
        x = (rng.random(n) * 10.0 ** rng.integers(-4, 3, n)).astype(
            np.float32)
        want = np.asarray(jnp.cumsum(jnp.asarray(x)))
        assert want.tobytes() == prng.xla_cumsum(
            torch.from_numpy(x)).numpy().tobytes()
        p = x / x.sum()
        k = jax.random.key(t)
        want = np.asarray(jax.random.choice(k, n, shape=(n,),
                                            p=jnp.asarray(p)))
        got = prng.choice(convert.key_from_data(jax.random.key_data(k)), n,
                          (n,), torch.from_numpy(p))
        assert want.astype(np.int32).tobytes() == got.numpy().tobytes()


# ---- competition and replication ----

@pytest.mark.parametrize("ctype", range(7))
def test_deme_fitness_equals_reference(ctype):
    rp, tp = _both(VALS)
    a = _deme_arrays(tp, 3 + ctype)
    want = rdemes.deme_fitness(rp, ref_state(a), ctype)
    got = tdemes.deme_fitness(tp, convert.state_from_arrays(a), ctype)
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("germline", [0, 1])
@pytest.mark.parametrize("ctype", [1, 2, 4])
def test_compete_demes_equals_reference(ctype, germline):
    """The roulette over deme fitness, the replaced bands' InjectClone
    copies, the germlines following their deme, every counter reset."""
    rp, tp = _both(dict(VALS, DEMES_USE_GERMLINE=germline))
    replaced = 0
    for seed in range(3):
        a = _deme_arrays(tp, 10 * ctype + seed)
        k = jax.random.key(seed)
        out_r = rdemes.compete_demes(rp, ref_state(a), k, ctype)
        out_t = tdemes.compete_demes(
            tp, convert.state_from_arrays(a),
            convert.key_from_data(jax.random.key_data(k)), ctype)
        assert_states_equal(out_r, out_t, (ctype, seed))
        replaced += int((out_t.genome.numpy() != a["genome"]).any(1).sum())
    assert replaced > 0


@pytest.mark.parametrize("germline", [0, 1])
@pytest.mark.parametrize("trigger", range(6))
def test_replicate_demes_equals_reference(trigger, germline):
    """Each trigger; the random targets, the lowest source winning a
    contested target (a scatter-min), germline seeding at the center
    cell with the mutated germline going to both demes, or InjectClone
    copies; the counters of demes that fired or were replaced reset."""
    rp, tp = _both(dict(VALS, DEMES_USE_GERMLINE=germline))
    preds = ((0, ">=", 5.0), (0, "<=", 1.5))
    fired = 0
    for seed in range(3):
        a = _deme_arrays(tp, 7 * trigger + seed)
        a["deme_resources"] = np.asarray([[9.0], [1.0], [3.0], [6.0]],
                                         np.float32)
        if seed == 0:
            a["alive"][:12] = True     # deme 0 full (its corners too)
        k = jax.random.key(40 + seed)
        st_r = ref_state(a)
        st_r = st_r.replace(deme_resources=jnp.asarray(a["deme_resources"]))
        st_t = convert.state_from_arrays(a)
        st_t = st_t.replace(deme_resources=torch.from_numpy(
            a["deme_resources"]))
        out_r = rdemes.replicate_demes(rp, st_r, k, trigger, preds)
        out_t = tdemes.replicate_demes(
            tp, st_t, convert.key_from_data(jax.random.key_data(k)), trigger,
            preds)
        assert_states_equal(out_r, out_t, (trigger, seed))
        fired += int((out_t.deme_age.numpy() != a["deme_age"]).sum())
    assert fired > 0


def test_replicate_predicate_needs_a_predicate():
    _, tp = _both(VALS)
    st = convert.state_from_arrays(_deme_arrays(tp, 1))
    with pytest.raises(ValueError, match="Pred_DemeResourceThreshold"):
        tdemes.replicate_demes(tp, st, prng.key(1),
                               tdemes.TRIGGER_PREDICATE)


# ---- the birth flush with demes ----

@pytest.mark.parametrize("bm,migration", [
    (0, None), (1, None), (4, None), (5, None), (6, None), (7, None),
    (8, None), (0, 0), (2, 1), (0, 2), (3, 4), (4, 0)])
def test_deme_flush_equals_reference(bm, migration):
    """Deme-local candidates, FULL_SOUP_RANDOM and DEME_RANDOM inside the
    deme, absolute targets (methods 5, 7, 8) collapsing to the parent
    when they leave the deme, DEMES_MIGRATION_RATE with methods 0, 1, 2
    and 4 (MIGRATION_FILE weights), and the per-deme birth tally."""
    vals = dict(VALS, BIRTH_METHOD=bm, WORLD_GEOMETRY=1 + bm % 2)
    if migration is not None:
        vals.update(DEMES_MIGRATION_RATE=0.4,
                    DEMES_MIGRATION_METHOD=migration, DEMES_NUM_X=2)
    rp, tp = _both(vals)
    a = _deme_arrays(tp, 60 + bm)
    out_r, out_t = flush_both(rp, tp, a, seed=bm)
    assert_states_equal(out_r, out_t, (bm, migration))
    tally = out_t.deme_birth_count.numpy() - a["deme_birth_count"]
    assert tally.sum() == int((out_t.birth_update == 13).sum()) > 0


def test_migration_method_3_is_refused():
    """Deme points are not modeled: both packages refuse method 3 with
    the same NotImplementedError."""
    msgs = []
    for make in (rstate.make_world_params, tstate.make_world_params):
        cfg = (rconfig.AvidaConfig() if make is rstate.make_world_params
               else convert.config_from_dict({}))
        cfg.set("NUM_DEMES", 4)
        cfg.set("DEMES_MIGRATION_METHOD", 3)
        inst = (rconfig.default_instset() if make is rstate.make_world_params
                else default_instset())
        env = r_env() if make is rstate.make_world_params else t_env()
        with pytest.raises(NotImplementedError, match="METHOD 3") as e:
            make(cfg, inst, env)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_init_population_seeds_every_germline():
    """DEMES_USE_GERMLINE 1: every deme's germline starts as the
    ancestor, as the reference's init_population seeds it; the whole
    state field by field."""
    rp, tp = _both(dict(VALS, DEMES_USE_GERMLINE=1))
    g = (np.arange(37) % tp.num_insts).astype(np.int8)
    want = rstate.init_population(rp, g, jax.random.key(2), inject_cell=9)
    got = tstate.init_population(tp, g, convert.key_from_data(
        jax.random.key_data(jax.random.key(2))), inject_cell=9)
    assert_states_equal(want, got)
    assert (got.germ_len.numpy() == 37).all()
    assert (got.germ_mem.numpy()[:, :37] == g).all()


# ---- deme worlds ----

WORLD = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=7, AVE_TIME_SLICE=30,
             TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0, TPU_SYSTEMATICS=0,
             NUM_DEMES=4, DEMES_USE_GERMLINE=1, DEMES_MIGRATION_RATE=0.2,
             DEMES_MAX_BIRTHS=10, GERMLINE_COPY_MUT=0.05)
EVOLVE = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# logic-9 (every process infinite) beside a global and a deme pool that
# no reaction binds: the kernel route keeps the world, and the pools
# step every update
KERNEL_ENV = """\
RESOURCE glu:inflow=10:outflow=0.05:initial=50
RESOURCE dpool:inflow=2.5:outflow=0.03:initial=40:demeresource=1
REACTION NOT  not  process:value=1.0:type=pow requisite:max_count=1
REACTION NAND nand process:value=1.0:type=pow requisite:max_count=1
REACTION AND  and  process:value=2.0:type=pow requisite:max_count=1
REACTION ORN  orn  process:value=2.0:type=pow requisite:max_count=1
REACTION OR   or   process:value=3.0:type=pow requisite:max_count=1
REACTION ANDN andn process:value=3.0:type=pow requisite:max_count=1
REACTION NOR  nor  process:value=4.0:type=pow requisite:max_count=1
REACTION XOR  xor  process:value=4.0:type=pow requisite:max_count=1
REACTION EQU  equ  process:value=5.0:type=pow requisite:max_count=1
"""


def _kernel_cfg_dir(tmp_path):
    cdir = tmp_path / "cfg_kernel"
    cdir.mkdir(exist_ok=True)
    (cdir / "environment.cfg").write_text(KERNEL_ENV)
    (cdir / "avida.cfg").write_text("")
    return str(cdir)


def _evolved_deme_world(cdir):
    """A 4-deme 8x8 world run EVOLVE updates from a mixed seeding on the
    port's kernel route (the plain version): births in every deme,
    migration across them, the unbound pools stepping."""
    w = World(config_dir=cdir, overrides=list(dict(
        WORLD, TPU_USE_PALLAS=1).items()), data_dir=None, device="cpu")
    w.events = []
    w.add_event("u begin InjectAll")
    w.process_events()
    _reseed_port(w)
    w.run(max_updates=EVOLVE)
    return convert.state_to_arrays(w.state)


def _pair_from(tmp_path, vals, arrays, update, events, cdir):
    ov = list(vals.items())
    ref = RefWorld(config_dir=cdir, overrides=ov,
                   data_dir=str(tmp_path / "ref"))
    port = World(config_dir=cdir, overrides=ov,
                 data_dir=str(tmp_path / "port"), device="cpu")
    ref.events = [parse_event_line(e) for e in events]
    port.events = []
    for e in events:
        port.add_event(e)
    ref.state = rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})
    port.state = convert.state_from_arrays(arrays)
    ref.update = port.update = update
    return ref, port


def _kernel_route_ladder(tmp_path, stop):
    """TPU_USE_PALLAS=1 in both packages (the reference in interpret
    mode): from an evolved 4-deme state, ReplicateDemes births (demes
    over DEMES_MAX_BIRTHS replicate into germline-seeded targets, the
    others not), CompeteDemes 1 and ReplicateDemes all, with migration,
    deme ageing and the unbound pools in every update; the state field
    by field after each update up to `stop`."""
    cdir = _kernel_cfg_dir(tmp_path)
    arrays = _evolved_deme_world(cdir)
    births = arrays["deme_birth_count"]
    assert (births >= 10).any() and (births < 10).any()
    events = [f"u {EVOLVE} ReplicateDemes births",
              f"u {EVOLVE + 1} CompeteDemes 1",
              f"u {EVOLVE + 2} ReplicateDemes all",
              f"u {EVOLVE + 5} CompeteDemes 2"]
    ref, port = _pair_from(tmp_path, dict(WORLD, TPU_USE_PALLAS=1), arrays,
                           EVOLVE, events, cdir)
    rep = port.engine_report()
    assert rep["engine"] == "per-update" and "demes" in rep[
        "fallback_reason"]
    tpc.reset_launches()
    for u in range(EVOLVE + 1, stop + 1):
        ref.run(max_updates=u)
        port.run(max_updates=u)
        _assert_same_state(ref, port, u)
    assert tpc.LAUNCHES == 0                # the CPU runs the plain version
    assert (port.state.germ_mem.numpy() != arrays["germ_mem"]).any()
    assert (port.state.deme_resources.numpy() != 40.0).all()


def test_deme_world_kernel_route_equals_reference(tmp_path):
    """Three launches (_kernel_route_ladder)."""
    _kernel_route_ladder(tmp_path, EVOLVE + 3)


@pytest.mark.slow
def test_deme_world_kernel_route_ladder(tmp_path):
    """Ten launches, a second CompeteDemes among them."""
    _kernel_route_ladder(tmp_path, EVOLVE + 10)


DEME_ENV = """\
RESOURCE dpool:inflow=2.5:outflow=0.03:initial=40:demeresource=1
RESOURCE glu:inflow=10:outflow=0.05:initial=50
REACTION NOT  not  process:value=1.0:type=pow:resource=dpool:frac=0.0731
REACTION NAND nand process:value=1.0:type=pow:resource=dpool:frac=0.131
REACTION AND  and  process:value=2.0:type=pow:resource=glu:frac=0.25
REACTION ORN  orn  process:value=2.0:type=pow:resource=glu:frac=0.5
"""


def _deme_resource_pair(tmp_path, events):
    cdir = tmp_path / "cfg"
    cdir.mkdir()
    (cdir / "environment.cfg").write_text(DEME_ENV)
    (cdir / "avida.cfg").write_text("")
    ov = list(dict(WORLD_X=12, WORLD_Y=12, RANDOM_SEED=5,
                   AVE_TIME_SLICE=30, TPU_KERNEL_SHARDS=1,
                   TPU_COMPILE_CACHE=0, TPU_SYSTEMATICS=0,
                   TPU_USE_PALLAS=2, NUM_DEMES=4,
                   DEMES_MIGRATION_RATE=0.1).items())
    ref = RefWorld(config_dir=str(cdir), overrides=ov,
                   data_dir=str(tmp_path / "ref"))
    port = World(config_dir=str(cdir), overrides=ov,
                 data_dir=str(tmp_path / "port"), device="cpu")
    evs = ["u begin InjectAll"] + events
    ref.events = [parse_event_line(e) for e in evs]
    port.events = []
    for e in evs:
        port.add_event(e)
    return ref, port


def test_deme_resource_world_equals_reference(tmp_path):
    """Reactions drawing on deme pools (contention inside each 36-cell
    band) and a global pool on the micro-step engine; a
    Pred_DemeResourceThresholdPredicate and ReplicateDemes
    sat-deme-predicate, then CompeteDemes 2; eight updates, the state
    field by field after each."""
    from test_torch_world import _reseed_mixed
    ref, port = _deme_resource_pair(tmp_path, [
        "u begin Pred_DemeResourceThresholdPredicate dpool <= 30",
        "u 4 ReplicateDemes sat-deme-predicate",
        "u 6 CompeteDemes 2"])
    _reseed_mixed(ref, port)
    levels = []
    for u in range(1, 9):
        ref.run(max_updates=u)
        port.run(max_updates=u)
        _assert_same_state(ref, port, u)
        levels.append(port.state.deme_resources[:, 0].numpy().copy())
    assert len(set(levels[3].tolist())) > 1      # bands drew differently
    assert port._deme_predicates == [(0, "<=", 30.0)]


def test_resource_deme_world_resumes_as_uninterrupted(tmp_path):
    """A world with global and deme pools, migration and a ReplicateDemes
    after the stop, saved at update 4 and resumed in a new World: the
    update-8 state equals the uninterrupted run's, field by field (the
    newborn ring's slack and the host clocks aside, as for every
    resume)."""
    events = ["u 5 ReplicateDemes all"]
    ck = tmp_path / "ck"

    def port_world(sub, ckpt):
        cdir = tmp_path / sub / "cfg"
        if not cdir.exists():
            cdir.mkdir(parents=True)
            (cdir / "environment.cfg").write_text(DEME_ENV)
            (cdir / "avida.cfg").write_text("")
        ov = [("WORLD_X", 12), ("WORLD_Y", 12), ("RANDOM_SEED", 5),
              ("TPU_SYSTEMATICS", 0), ("TPU_USE_PALLAS", 2),
              ("NUM_DEMES", 4), ("DEMES_MIGRATION_RATE", 0.1),
              ("TPU_CKPT_DIR", str(ckpt)), ("TPU_CKPT_FINAL", 1)]
        w = World(config_dir=str(cdir), overrides=ov,
                  data_dir=str(tmp_path / sub / "dat"), device="cpu")
        w.events = []
        for e in ["u begin InjectAll"] + events:
            w.add_event(e)
        return w

    u = port_world("u", tmp_path / "cu")
    u.run(max_updates=8)
    s = port_world("s", ck)
    s.run(max_updates=4)
    r = port_world("r", ck)
    assert r.resume() == 4
    r.run(max_updates=8)
    want = convert.state_to_arrays(u.state)
    got = convert.state_to_arrays(r.state)
    for k, v in want.items():
        if v is None or k.startswith("nb_"):
            continue
        assert v.tobytes() == got[k].tobytes(), k
    assert (got["deme_resources"] != 40.0).all()
