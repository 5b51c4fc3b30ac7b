"""Experimental spatial hardware (hw_type 3) in the port: the
8-register CPU with facing, movement, look-ahead, forage targets and
predation (models/experimental.py, the hw 3 branches of
interpreter.micro_step and birth.flush_births), against avida_tpu.

Six of tests/test_experimental.py's seven cases run here alongside the
reference from the same state and key, with the reference test's own
assertions on the port's result (the seventh, replication, is a world:
tests/test_torch_experimental_world.py); a random-state cycle test
covers every instruction at once (negative rotations, rotate-org-id
hits, look rays, move conflicts, kills) on the torus and the bounded
grid.

Tolerance: exact -- every state field byte for byte after every cycle.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.config.environment import (  # noqa: E402
    default_logic9_environment as r_env)
from avida_tpu.config.instset import (  # noqa: E402
    pred_look_instset as r_pred_look_instset)
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.models import experimental as rexp  # noqa: E402
from avida_tpu.ops import interpreter as rinterp  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import load_instset  # noqa: E402
from avida_tpu_torch.config.environment import (  # noqa: E402
    default_logic9_environment as t_env)
from avida_tpu_torch.config.instset import (  # noqa: E402
    experimental_instset, pred_look_instset)
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.models import experimental as texp  # noqa: E402
from avida_tpu_torch.ops import interpreter as tinterp  # noqa: E402

from test_torch_mating import _instset_text  # noqa: E402
from test_torch_placement import (assert_states_equal,  # noqa: E402
                                  ref_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the avatars set: pred_look's sensing set, attack-prey, and the
# experimental set's replication instructions (the experimental ancestor
# runs in it)
PRED_LOOK = list(pred_look_instset().inst_names)
AVATARS = PRED_LOOK + ["attack-prey"] + [
    n for n in experimental_instset().inst_names if n not in PRED_LOOK]


def _key(seed, c=0):
    k = jax.random.fold_in(jax.random.key(seed), c)
    return k, convert.key_from_data(jax.random.key_data(k))


def _both_params(tmp_path, names, vals):
    path = tmp_path / "instset.cfg"
    path.write_text(_instset_text(names, hw_type=3))
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.load_instset(str(path)),
                                  r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  load_instset(str(path)), t_env())
    return rp, tp


_REF_STEPS = {}


def ref_step(rp):
    """The reference's micro_step for `rp`, jitted once per module."""
    if rp not in _REF_STEPS:
        _REF_STEPS[rp] = jax.jit(lambda s, k, m: rinterp.micro_step(
            rp, s, k, m))
    return _REF_STEPS[rp]


def _step_both(rp, tp, st_r, st_t, seed, c, mask):
    kr, kt = _key(seed, c)
    st_r = ref_step(rp)(st_r, kr, jnp.asarray(mask))
    st_t = tinterp.micro_step(tp, st_t, kt, torch.from_numpy(mask))
    assert_states_equal(st_r, st_t, c)
    return st_r, st_t


def test_semantic_tables_equal_reference():
    for names in (AVATARS, PRED_LOOK,
                  list(experimental_instset().inst_names)):
        want = rexp.build_semantic_tables(names)
        got = texp.build_semantic_tables(names)
        assert want.keys() == got.keys()
        for k in want:
            assert np.array_equal(np.asarray(want[k]), np.asarray(got[k]))
    with pytest.raises(ValueError, match="does not implement"):
        texp.build_semantic_tables(["nop-A", "collect-specific"])


# ---- tests/test_experimental.py's seven cases, alongside the reference --

def _worlds(inst_set, tmp_path, wx=8, wy=8, seed=5):
    """The reference test's world (AVE_TIME_SLICE 100, no systematics) in
    both packages."""
    from avida_tpu.world import World as RefWorld
    from avida_tpu_torch.world import World
    vals = dict(WORLD_X=wx, WORLD_Y=wy, RANDOM_SEED=seed, INST_SET=inst_set,
                AVE_TIME_SLICE=100, TPU_SYSTEMATICS=0)
    cfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        cfg.set(k, v)
    ref = RefWorld(cfg=cfg, data_dir=str(tmp_path / "ref"))
    port = World(cfg=convert.config_from_dict(vals),
                 data_dir=str(tmp_path / "port"), device="cpu")
    ref.events, port.events = [], []
    return ref, port


def _prog(names, prog, pad_to=24):
    ops = [names.index(n) for n in prog]
    ops += [names.index("nop-A")] * (pad_to - len(ops))
    return np.asarray(ops, np.int8)


def _inject_both(ref, port, genome, cell):
    ref.inject(genome=genome, cell=cell)
    port.inject(genome=genome, cell=cell)
    assert_states_equal(ref.state, port.state, ("inject", cell))


def _set_both(ref, port, **fields):
    """Write {field: {cell: value}} into both worlds' states."""
    arrays = convert.state_to_arrays(port.state)
    for name, cells in fields.items():
        for c, v in cells.items():
            arrays[name][c] = v
    ref.state = ref_state(arrays)
    port.state = convert.state_from_arrays(arrays)


def test_rotate_and_move_equal_reference(tmp_path):
    ref, port = _worlds("pred_look.cfg", tmp_path)
    names = port.instset.inst_names
    cell = 4 * 8 + 4
    _inject_both(ref, port, _prog(names, ["move", "nop-B"]), cell)
    _set_both(ref, port, facing={cell: 0})
    mask = np.zeros(64, bool)
    mask[cell] = True
    _, st = _step_both(ref.params, port.params, ref.state, port.state, 0, 0,
                       mask)
    alive = st.alive.numpy()
    assert not alive[cell]
    occupied = np.flatnonzero(alive)
    assert len(occupied) == 1
    assert divmod(int(occupied[0]), 8)[::-1] == (4, 3)


def test_look_ahead_equal_reference(tmp_path):
    ref, port = _worlds("pred_look.cfg", tmp_path)
    names = port.instset.inst_names
    looker, target = 4 * 8 + 4, 1 * 8 + 4
    _inject_both(ref, port, _prog(names, ["look-ahead", "nop-B"]), looker)
    _inject_both(ref, port, _prog(names, ["nop-A"]), target)
    _set_both(ref, port, facing={looker: 0}, forage_target={target: 7})
    mask = np.zeros(64, bool)
    mask[looker] = True
    _, st = _step_both(ref.params, port.params, ref.state, port.state, 0, 0,
                       mask)
    regs = st.regs.numpy()[looker]
    assert list(regs[[1, 2, 4, 5, 0]]) == [-2, 3, target, 1, 7]


@pytest.mark.parametrize("steps,facing", [
    (["inc", "inc", "set-forage-target", "inc", "rotate-x", "nop-B"], 3),
    # a negative rotation: BX = -3 turns the facing to (0 - 3) mod 8
    (["dec", "nop-B", "dec", "nop-B", "dec", "nop-B", "set-forage-target",
      "nop-B", "rotate-x", "nop-B"], 5)])
def test_set_forage_target_and_rotate_x_equal_reference(tmp_path, steps,
                                                        facing):
    ref, port = _worlds("pred_look.cfg", tmp_path)
    names = port.instset.inst_names
    cell = 9
    _inject_both(ref, port, _prog(names, steps), cell)
    _set_both(ref, port, facing={cell: 0})
    mask = np.zeros(64, bool)
    mask[cell] = True
    st_r, st_t = ref.state, port.state
    for c in range(5):
        st_r, st_t = _step_both(ref.params, port.params, st_r, st_t, 1, c,
                                mask)
    ft = int(st_t.forage_target[cell])
    assert ft == (2 if facing == 3 else -3)
    assert int(st_t.facing[cell]) == facing
    assert int(st_t.regs[cell, 1]) == facing      # the echo: ?BX? mod 8


def test_move_conflict_equal_reference(tmp_path):
    ref, port = _worlds("pred_look.cfg", tmp_path)
    names = port.instset.inst_names
    mover = _prog(names, ["move", "nop-B"])
    a, b, tgt = 2 * 8 + 4, 4 * 8 + 4, 3 * 8 + 4
    _inject_both(ref, port, mover, a)
    _inject_both(ref, port, mover, b)
    _set_both(ref, port, facing={a: 4, b: 0})
    mask = np.zeros(64, bool)
    mask[[a, b]] = True
    _, st = _step_both(ref.params, port.params, ref.state, port.state, 2, 0,
                       mask)
    alive = st.alive.numpy()
    assert alive[tgt] and not alive[a] and alive[b]
    assert int(st.regs[tgt, 1]) == 1 and int(st.regs[b, 1]) == 0


def test_pred_look_params_equal_reference():
    vals = dict(WORLD_X=5, WORLD_Y=5)
    cfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        cfg.set(k, v)
    rp = rstate.make_world_params(cfg, r_pred_look_instset(), r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  pred_look_instset(), t_env())
    assert tp.hw_type == rp.hw_type == 3
    assert tp.num_insts == rp.num_insts == len(PRED_LOOK)
    assert tp.num_registers == rp.num_registers == 8
    assert tp.num_nops == rp.num_nops == 8
    assert tuple(tp.sem) == tuple(int(x) for x in rp.sem)


def _predator_case(tmp_path, eff):
    """The reference test's predator: cell 12 moves north and attacks the
    prey two cells north of its start, in both packages."""
    names = PRED_LOOK + ["attack-prey"]
    vals = dict(WORLD_X=5, WORLD_Y=5, TPU_MAX_MEMORY=32, PRED_PREY_SWITCH=0,
                PRED_EFFICIENCY=eff, COPY_MUT_PROB=0.0)
    rp, tp = _both_params(tmp_path, names, vals)
    n, L = tp.num_cells, tp.max_memory
    arrays = convert.state_to_arrays(tstate.zeros_population(
        n, L, tp.num_reactions, num_registers=8))
    move, atk, nop_a = (names.index(x) for x in ("move", "attack-prey",
                                                  "nop-A"))
    arrays["tape"][12, :4] = [move, atk, nop_a, nop_a]
    for c in (12, 2):
        arrays["mem_len"][c] = arrays["genome_len"][c] = 4
        arrays["alive"][c] = True
    arrays["merit"][:] = 1.0
    arrays["merit"][2] = 5.0
    arrays["cur_bonus"][2] = 3.0
    arrays["forage_target"][2] = 0
    return rp, tp, arrays


@pytest.mark.parametrize("eff", [1.0, 0.3])
def test_predator_kills_prey_equal_reference(tmp_path, eff):
    rp, tp, arrays = _predator_case(tmp_path, eff)
    st_r, st_t = ref_state(arrays), convert.state_from_arrays(arrays)
    step = ref_step(rp)
    for c, cell in enumerate((12, 7)):
        mask = np.zeros(tp.num_cells, bool)
        mask[cell] = True
        kr, kt = _key(0, c)
        st_r = step(st_r, kr, jnp.asarray(mask))
        st_t = tinterp.micro_step(tp, st_t, kt, torch.from_numpy(mask))
        assert_states_equal(st_r, st_t, c)
    assert not bool(st_t.alive[2])
    assert float(st_t.merit[7]) == np.float32(1.0) + np.float32(
        np.float32(5.0) * np.float32(eff))
    assert int(st_t.forage_target[7]) == -2 and int(st_t.regs[7, 1]) == 1


# ---- every instruction at once on random states ----

def _random_arrays(tp, names, seed, n):
    rng = np.random.default_rng(seed)
    L = tp.max_memory
    a = convert.state_to_arrays(tstate.zeros_population(
        n, L, tp.num_reactions, num_registers=8))
    nops = [k for k, nm in enumerate(names) if nm.startswith("nop-")]
    ops = rng.integers(0, len(names), (n, L))
    ops = np.where(rng.random((n, L)) < 0.25, rng.choice(nops, (n, L)), ops)
    a["tape"] = ops.astype(np.uint8)
    a["mem_len"] = rng.integers(12, L + 1, n).astype(np.int32)
    a["genome_len"] = a["mem_len"].copy()
    a["heads"] = rng.integers(0, L, (n, 4)).astype(np.int32)
    regs = np.where(rng.random((n, 8)) < 0.5, rng.integers(0, n, (n, 8)),
                    rng.integers(-20, 20, (n, 8)))
    a["regs"] = regs.astype(np.int32)
    a["alive"] = rng.random(n) < 0.7
    a["facing"] = rng.integers(0, 8, n).astype(np.int32)
    a["forage_target"] = rng.integers(-3, 3, n).astype(np.int32)
    a["merit"] = (rng.random(n) * 50 + 1).astype(np.float32)
    a["cur_bonus"] = (rng.random(n) * 4 + 0.5).astype(np.float32)
    a["inputs"] = rng.integers(0, 2**24, (n, 3)).astype(np.int32)
    a["max_executed"][:] = 2**30
    return a


@pytest.mark.parametrize("geometry,switch", [(2, 0), (1, 0), (1, -1)])
def test_micro_step_random_states_equal_reference(tmp_path, geometry,
                                                  switch):
    """Eight cycles on a random 9x7 population programmed over the
    avatars set: every field equal after every cycle, with moves, kills,
    looks and rotations among them."""
    vals = dict(WORLD_X=9, WORLD_Y=7, TPU_MAX_MEMORY=48,
                WORLD_GEOMETRY=geometry, PRED_PREY_SWITCH=switch,
                PRED_EFFICIENCY=0.7, COPY_MUT_PROB=0.05)
    rp, tp = _both_params(tmp_path, AVATARS, vals)
    n = tp.num_cells
    arrays = _random_arrays(tp, AVATARS, 31 + geometry, n)
    st_r, st_t = ref_state(arrays), convert.state_from_arrays(arrays)
    step = ref_step(rp)
    rng = np.random.default_rng(geometry)
    moved = killed = 0
    for c in range(8):
        mask = rng.random(n) < 0.9
        kr, kt = _key(7, c)
        before = st_t
        st_r = step(st_r, kr, jnp.asarray(mask))
        st_t = tinterp.micro_step(tp, st_t, kt, torch.from_numpy(mask))
        assert_states_equal(st_r, st_t, c)
        # a move empties one cell and fills another; a kill only empties
        new = int((~before.alive & st_t.alive).sum())
        moved += new
        killed += int((before.alive & ~st_t.alive).sum()) - new
    assert moved > 0 and (killed > 0) == (switch >= 0)
    assert (st_t.facing != torch.from_numpy(arrays["facing"])).any()
