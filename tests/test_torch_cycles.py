"""ops/cycles.py: the plane layout, codecs and one cycle-kernel launch
against the reference (avida_tpu/ops/pallas_cycles.py, its Pallas kernel
run in interpret mode on a single shard).

Tolerance: exact -- every plane word and every state field byte for
byte.  The CUDA leg holds the Hopper kernel and the first port
(csrc/cycles_simple.cu) to the plain version the same way.
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
from avida_tpu.ops import pallas_cycles as rpc  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.config.environment import (  # noqa: E402
    default_logic9_environment as t_env, load_environment)
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import cycles as tpc  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402
from avida_tpu.config.environment import (  # noqa: E402
    load_environment as r_load_environment)

VALS = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=5, AVE_TIME_SLICE=30,
            TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1)


def _ref_params():
    cfg = rconfig.AvidaConfig()
    for k, v in VALS.items():
        cfg.set(k, v)
    return rstate.make_world_params(cfg, rconfig.default_instset(), r_env())


# an environment whose reactions use every reward type and requisite kind
ENV_TEXT = """
REACTION NOT  not  process:value=1.0:type=pow  requisite:max_count=2
REACTION NAND nand process:value=1.5:type=mult requisite:noreaction=NOT
REACTION AND  and  process:value=2.5:type=add  requisite:reaction=NOT
REACTION ORN  orn  process:value=2.0:type=pow  requisite:min_count=1:max_count=3
REACTION OR   or   process:value=3.0:type=pow
REACTION ANDN andn process:value=3.0:type=add
REACTION NOR  nor  process:value=4.0:type=pow
REACTION XOR  xor  process:value=4.0:type=pow
REACTION EQU  equ  process:value=5.0:type=pow
"""
VARIANTS = {
    "default": {},
    "phenotype": dict(BASE_MERIT_METHOD=5, DIVIDE_METHOD=0,
                      GENERATION_INC_METHOD=0, REQUIRE_ALLOCATE=0,
                      COPY_MUT_PROB=0.05, INHERIT_MERIT=0),
}

# IO reads x into BX; push/pop copies it to CX; nand makes ~x; IO outputs
# it (NOT) and reads y; nand makes ~(x & y); IO outputs it (NAND) ...
TASK_GENOME = ["IO", "push", "pop", "nop-C", "nand", "IO", "nand", "IO",
               "nand", "IO", "swap", "IO", "inc", "IO"] + ["swap-stk"] * 6


def _both_params(tmp_path, variant, env):
    vals = dict(VALS, **VARIANTS[variant])
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    if env == "custom":
        path = tmp_path / "environment.cfg"
        path.write_text(ENV_TEXT)
        renv, tenv = r_load_environment(str(path)), load_environment(str(path))
    else:
        renv, tenv = r_env(), None
    rp = rstate.make_world_params(rcfg, rconfig.default_instset(), renv)
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  default_instset(), tenv or t_env())
    return rp, tp


def _mixed_state(w):
    """The evolved state with a third of the cells reseeded with a
    task-performing program and a third with random genomes, so that
    every instruction, task reward and requisite path runs."""
    names = default_instset().inst_names
    task = np.asarray([names.index(n) for n in TASK_GENOME], np.int8)
    rng = np.random.default_rng(7)
    st = w.state
    for c in range(w.params.num_cells):
        if c % 3 == 1:
            g = task
        elif c % 3 == 2:
            g = rng.integers(0, len(names), rng.integers(30, 90)).astype(
                np.int8)
        else:
            continue
        st = tstate.seed_organism(w.params, st, g, prng.key(c), c)
    return st


def _evolved_world(device="cpu", updates=24):
    """A 6x6 world seeded everywhere and run until divides and births
    happen (the port's World equals the reference's, test_torch_world)."""
    w = World(cfg=convert.config_from_dict(VALS), data_dir=None,
              device=device)
    w.events = []
    w.add_event("u begin InjectAll")
    w.run(max_updates=updates)
    return w


@pytest.fixture(scope="module")
def evolved():
    w = _evolved_world()
    arrays = convert.state_to_arrays(w.state)
    rst = rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})
    rng = np.random.default_rng(0)
    granted = rng.integers(0, 70, w.params.num_cells).astype(np.int32)
    return w, rst, granted


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def test_codecs_byte_equal():
    rng = np.random.default_rng(1)
    L = 384
    tape = rng.integers(0, 256, (20, L)).astype(np.uint8)
    t = torch.from_numpy(tape)
    assert _eq(rpc._pack_words(jnp.asarray(tape), L), tpc.pack_words(t, L))
    w = rpc._pack_words(jnp.asarray(tape), L)
    assert _eq(rpc._unpack_words(w, L),
               tpc.unpack_words(torch.from_numpy(np.array(w)), L))
    for bit in (6, 7):
        fw = rpc._flag_to_words(jnp.asarray(tape), bit, L)
        assert _eq(fw, tpc.flag_to_words(t, bit, L))
        assert _eq(rpc._words_to_flag(fw, bit, L), tpc.words_to_flag(
            torch.from_numpy(np.array(fw)), bit, L))
    ops = rng.integers(0, 32, (20, 100)).astype(np.uint8)
    w5 = rpc._pack_words5(jnp.asarray(ops), 100)
    assert _eq(w5, tpc.pack_words5(torch.from_numpy(ops), 100))
    assert _eq(rpc._unpack_words5(w5, 100), tpc.unpack_words5(
        torch.from_numpy(np.array(w5)), 100))
    assert tpc.words5(100) == rpc.words5(100)


def test_layout_and_dims():
    rp = _ref_params()
    for n in (36, 100, 1000, 102400):
        assert tpc.dims(rp, n, 384) == rpc._dims(rp, n, 384, 1)
    assert tpc.layout(rp, 384) == rpc._layout(rp, 384)


def test_pack_unpack_byte_equal(evolved):
    w, rst, granted = evolved
    rp = _ref_params()
    quad_r = rpc.pack_state(rp, rst, jnp.asarray(granted), None, 1)
    quad_t = tpc.pack_state(w.params, w.state, torch.from_numpy(granted))
    for a, b in zip(quad_r, quad_t):
        assert _eq(a, b)
    back_r = rpc.unpack_state(rp, rst, quad_r, None, restore_ro=True)
    back_t = tpc.unpack_state(w.params, w.state, quad_t, restore_ro=True)
    bt = convert.state_to_arrays(back_t)
    for k in rstate.state_field_names():
        a = getattr(back_r, k)
        assert (a is None and bt[k] is None) or _eq(a, bt[k]), k


@pytest.mark.parametrize("cap", [2**31 - 1, 7])
def test_one_launch_equals_reference(evolved, cap):
    """One launch of the plain version equals run_packed (interpret mode,
    one shard) on all four planes, uncapped and with an odd step cap."""
    w, rst, granted = evolved
    rp = _ref_params()
    assert rpc.kernel_shards(rp) == 1
    quad_r = rpc.pack_state(rp, rst, jnp.asarray(granted), None, 1)
    quad_t = tpc.pack_state(w.params, w.state, torch.from_numpy(granted))
    key = jax.random.fold_in(jax.random.key(3), 21)
    out_r = rpc.run_packed(rp, quad_r, key, cap)
    B, n_pad, _ = tpc.dims(w.params, w.params.num_cells, 384)
    seeds = tpc.block_seeds(convert.key_from_data(jax.random.key_data(key)),
                            n_pad, B)
    tpc.cycles(w.params, quad_t, seeds, cap, B)
    flags = quad_t[2][tpc.IV_FLAGS]
    assert bool(((flags & tpc.FLAG_NEWDIV) != 0).any())   # divides happened
    for a, b in zip(out_r, quad_t):
        assert _eq(a, b)


@pytest.mark.parametrize("variant,env", [("default", "custom"),
                                         ("phenotype", "logic9")])
def test_launches_on_mixed_programs_equal_reference(evolved, tmp_path,
                                                    variant, env):
    """Two consecutive launches over task-performing and random programs,
    under other phenotype settings and an environment with every reward
    type and requisite kind: planes equal the reference's exactly."""
    w, _, _ = evolved
    rp, tp = _both_params(tmp_path, variant, env)
    st = _mixed_state(w)
    arrays = convert.state_to_arrays(st)
    rst = rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})
    granted = np.full(tp.num_cells, 40, np.int32)
    quad_r = rpc.pack_state(rp, rst, jnp.asarray(granted), None, 1)
    quad_t = tpc.pack_state(tp, st, torch.from_numpy(granted))
    B, n_pad, _ = tpc.dims(tp, tp.num_cells, 384)
    for i in range(2):
        key = jax.random.fold_in(jax.random.key(9), i)
        quad_r = rpc.run_packed(rp, quad_r, key, 2**31 - 1)
        seeds = tpc.block_seeds(
            convert.key_from_data(jax.random.key_data(key)), n_pad, B)
        tpc.cycles(tp, quad_t, seeds, 2**31 - 1, B)
        for a, b in zip(quad_r, quad_t):
            assert _eq(a, b), i
    NI, LW, _, dyn = tpc.layout(tp, 384)
    R = tp.num_reactions
    done = quad_t[2][dyn + 3 * R:dyn + 4 * R].sum(dim=1)
    assert int((done > 0).sum()) >= 2          # several tasks performed
    assert int(quad_t[2][dyn + R:dyn + 2 * R].sum()) > 0   # and rewarded


def test_kernel_tables_built_once_per_params(tmp_path):
    """The launch table is built once per params object and device (a
    launch must not rebuild and upload it), and other params get their
    own table."""
    p = World(cfg=convert.config_from_dict(VALS), data_dir=None,
              device="cpu").params
    t1 = tpc.kernel_tables(p, "cpu")
    assert tpc.kernel_tables(p, "cpu") is t1
    assert torch.equal(t1, tpc._build_tables(p))
    _, tp = _both_params(tmp_path, "default", "custom")
    t2 = tpc.kernel_tables(tp, "cpu")
    assert t2 is not t1 and torch.equal(t2, tpc._build_tables(tp))
    assert not torch.equal(t1, t2)          # the custom environment differs


@pytest.mark.cuda
def test_kernel_equals_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cycle kernel has no CPU mode")
    w = _evolved_world("cuda", updates=24)
    rng = np.random.default_rng(0)
    granted = torch.from_numpy(
        rng.integers(0, 70, w.params.num_cells).astype(np.int32)).cuda()
    quad = tpc.pack_state(w.params, w.state, granted)
    B, n_pad, _ = tpc.dims(w.params, w.params.num_cells, 384)
    seeds = tpc.block_seeds(torch.tensor([0, 9], device="cuda"), n_pad, B)
    kern = tuple(t.clone() for t in quad)
    simple = tuple(t.clone() for t in quad)
    plain = tuple(t.clone() for t in quad)
    n0 = tpc.LAUNCHES
    tpc.cycles(w.params, kern, seeds, 2**31 - 1, B)
    tpc.cycles_simple(w.params, simple, seeds, 2**31 - 1, B)
    tpc.cycles_reference(w.params, plain, seeds, 2**31 - 1, B)
    torch.cuda.synchronize()
    assert tpc.LAUNCHES == n0 + 1          # the first port is not counted
    for a, b, c in zip(kern, simple, plain):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        assert torch.equal(b.view(torch.int32), c.view(torch.int32))
