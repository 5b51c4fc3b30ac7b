"""TransSMT hardware and host-parasite coevolution in the port
(models/transsmt.py, models/registry.py, ops/interpreter_smt.py, the SMT
branches of ops/birth.flush_births with flush_injections, InjectParasite)
against the reference's avida_tpu on the CPU:

  * the semantic tables and the hardware registry;
  * micro_step_smt on a random 8x8 state -- every opcode under an IP, both
    threads, half the cells parasitized, stacks holding INT_MIN, -1 and 0,
    negative head positions -- under PARASITE_VIRULENCE -1, 0.0 and 0.8;
  * designed cycles: Search hit, miss and empty label, SetMemory, Write
    growth, Inject above and below MIN_INJECT_SIZE, Divide at the size
    limits (OFFSPRING_SIZE_RANGE 1.1, whose float32 quotient rounds),
    INT_MIN // -1 and INT_MIN % -1, the parasite thread's own cases;
  * the SMT birth flush: several injectors on one target, injections into
    parasitized targets, failed injections consumed, newborn SMT fields;
  * InjectParasite;
  * an 8x8 host-parasite world with and without systematics, resumed in
    the port from a generation the reference wrote (the checkpoint's SMT
    fields), four more updates: state and .dat bytes;
  * a TransSMT deme world through a ReplicateDemes.

Tolerance: exact -- every state field byte for byte, .dat files equal
apart from the header's date line.
"""

import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.config.environment import \
    default_logic9_environment as r_env  # noqa: E402
from avida_tpu.config.events import parse_event_line  # noqa: E402
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.models import registry as rregistry  # noqa: E402
from avida_tpu.models import transsmt as rsmt  # noqa: E402
from avida_tpu.ops import birth as rbirth  # noqa: E402
from avida_tpu.ops.interpreter_smt import micro_step_smt as r_step  # noqa
from avida_tpu.world import World as RefWorld  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import transsmt_instset  # noqa: E402
from avida_tpu_torch.config.environment import \
    default_logic9_environment as t_env  # noqa: E402
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.models import registry as tregistry  # noqa: E402
from avida_tpu_torch.models import transsmt as tsmt  # noqa: E402
from avida_tpu_torch.ops import birth as tbirth  # noqa: E402
from avida_tpu_torch.ops import cycles as tpc  # noqa: E402
from avida_tpu_torch.ops.interpreter_smt import micro_step_smt  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

N, L = 64, 160
I32_MIN, I32_MAX = -2**31, 2**31 - 1
VALS = dict(WORLD_X=8, WORLD_Y=8, TPU_MAX_MEMORY=L, RANDOM_SEED=5,
            INST_SET="transsmt", TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1,
            TPU_COMPILE_CACHE=0, COPY_MUT_PROB=0.05)
NAMES = transsmt_instset().inst_names
OP = {n: i for i, n in enumerate(NAMES)}
NOPS = [OP[n] for n in ("Nop-A", "Nop-B", "Nop-C", "Nop-D")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_params(**kw):
    vals = dict(VALS, **kw)
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.transsmt_instset(), r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  transsmt_instset(), t_env())
    return rp, tp


def _ref_state(arrays):
    return rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})


def _assert_states_equal(st_r, st_t, where=""):
    got = convert.state_to_arrays(st_t)
    for k in rstate.state_field_names():
        a = getattr(st_r, k)
        if a is None:
            assert got[k] is None, (where, k)
            continue
        a = np.asarray(a)
        assert a.shape == got[k].shape and a.dtype == got[k].dtype, (where, k)
        assert a.tobytes() == got[k].tobytes(), (where, k)


_STEPS = {}


def _ref_cycle(rp):
    """The reference's micro_step_smt, compiled once per params."""
    if rp not in _STEPS:
        _STEPS[rp] = jax.jit(lambda s, k, m: r_step(rp, s, k, m))
    return _STEPS[rp]


def _cycles(rp, tp, arrays, masks, seed=3):
    """Run one cycle per exec mask in both packages, comparing every field
    after each.  Returns the reference's states."""
    st_r, st_t = _ref_state(arrays), convert.state_from_arrays(arrays)
    out = []
    for c, mask in enumerate(masks):
        k = jax.random.fold_in(jax.random.key(seed), c)
        st_r = _ref_cycle(rp)(st_r, k, jnp.asarray(mask))
        st_t = micro_step_smt(tp, st_t,
                              convert.key_from_data(jax.random.key_data(k)),
                              torch.from_numpy(np.array(mask)))
        _assert_states_equal(st_r, st_t, c)
        out.append(st_r)
    return out


def test_semantic_tables_and_registry_equal_reference():
    want = rsmt.build_semantic_tables(NAMES)
    got = tsmt.build_semantic_tables(NAMES)
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(np.asarray(want[k]), np.asarray(got[k])), k
    for hw in (0, 1, 2):
        assert tregistry.get_hardware(hw)["name"] == \
            rregistry.get_hardware(hw)["name"]
        assert tregistry.get_hardware(hw)["default_instset"] == \
            rregistry.get_hardware(hw)["default_instset"]
    with pytest.raises(NotImplementedError, match="item 12h"):
        tregistry.get_hardware(3)
    with pytest.raises(ValueError, match="HARDWARE_TYPE 9"):
        tregistry.get_hardware(9)
    _, tp = _both_params()
    assert tp.hw_type == 2 and tp.num_insts == len(NAMES)
    assert tuple(tp.sem) == tuple(want["sem"].tolist())


def _random_arrays(tp, seed):
    """A random TransSMT population of N organisms: every opcode of the
    set under some thread's IP, half the cells parasitized, stacks with
    the int32 extremes, -1 and 0, head positions outside their space and
    negative, sizes of 0, pending injections and divides."""
    rng = np.random.default_rng(seed)
    ni, R = tp.num_insts, tp.num_reactions
    a = convert.state_to_arrays(tstate.zeros_population(N, L, R, smt=True))

    def i32(lo, hi, shape):
        return rng.integers(lo, hi, shape, endpoint=True).astype(np.int32)

    def ops(shape):
        o = rng.integers(0, ni, shape)
        return np.where(rng.random(shape) < 0.3, rng.choice(NOPS, shape), o)

    flags = rng.integers(0, 4, (N, L)) << 6
    tape = np.where(rng.random((N, L)) < 0.03, rng.integers(0, 64, (N, L)),
                    ops((N, L)))
    a["tape"] = (tape | flags).astype(np.uint8)
    a["mem_len"] = i32(8, L, N)
    a["smt_aux"] = ops((N, 2, L)).astype(np.uint8)
    a["smt_aux_len"] = i32(0, L, (N, 2))
    a["pmem"] = ops((N, L)).astype(np.uint8)
    a["pmem_len"] = i32(0, L, N)
    a["parasite_active"] = rng.random(N) < 0.5
    extremes = np.array([I32_MIN, I32_MAX, -1, 0, 1], np.int32)

    def values(shape):
        small = i32(-20, 20, shape)
        big = i32(I32_MIN, I32_MAX, shape)
        ext = rng.choice(extremes, shape)
        u = rng.random(shape)
        return np.where(u < 0.3, ext, np.where(u < 0.5, big, small))

    a["smt_stacks"] = values((N, 2, 3, 10))
    a["smt_sp"] = i32(0, 9, (N, 2, 3))
    a["gstack"] = values((N, 10))
    a["gsp"] = i32(0, 9, N)
    a["smt_head_pos"] = np.where(rng.random((N, 2, 4)) < 0.1,
                                 i32(-40, -1, (N, 2, 4)),
                                 i32(0, L + 8, (N, 2, 4)))
    a["smt_head_space"] = i32(0, 3, (N, 2, 4))
    a["inject_pending"] = rng.random(N) < 0.2
    a["inj_mem"] = ops((N, L)).astype(np.uint8)
    a["inj_len"] = i32(0, L, N)
    a["alive"] = rng.random(N) < 0.95
    a["genome_len"] = i32(8, L // 2, N)
    a["inputs"] = i32(I32_MIN, I32_MAX, (N, 3))
    a["input_ptr"] = i32(-4, 20, N)
    a["input_buf"] = i32(I32_MIN, I32_MAX, (N, 3))
    a["input_buf_n"] = i32(0, 3, N)
    a["merit"] = (rng.random(N) * 100).astype(np.float32)
    a["cur_bonus"] = (rng.random(N) * 4 + 0.5).astype(np.float32)
    a["cur_task_count"] = i32(0, 2, (N, R))
    a["cur_reaction_count"] = i32(0, 1, (N, R))
    a["time_used"] = i32(0, 400, N)
    a["gestation_start"] = (a["time_used"] * rng.random(N)).astype(np.int32)
    a["max_executed"] = np.where(rng.random(N) < 0.1, a["time_used"] + 1,
                                 2**30).astype(np.int32)
    a["divide_pending"] = rng.random(N) < 0.1
    a["sterile"] = rng.random(N) < 0.05
    # every opcode under an IP, on both threads
    sizes = {0: a["mem_len"], 2: a["pmem_len"]}
    for c in range(N):
        for th in range(2):
            sp = int(a["smt_head_space"][c, th, 0])
            size = int(sizes[sp][c] if sp in sizes
                       else a["smt_aux_len"][c, (sp - 1) // 2])
            if size == 0:
                continue
            pos = int(a["smt_head_pos"][c, th, 0]) % size
            op = (c + 29 * th) % ni
            if sp == 0:
                a["tape"][c, pos] = (a["tape"][c, pos] & 0xC0) | op
            elif sp == 2:
                a["pmem"][c, pos] = op
            else:
                a["smt_aux"][c, (sp - 1) // 2, pos] = op
    # INT_MIN // -1 and % -1 under Val-Div / Val-Mod (no modifier: BX
    # over CX), and a division by zero
    for c, name in ((0, "Val-Div"), (1, "Val-Mod"), (2, "Val-Div"),
                    (3, "Val-Mod")):
        a["parasite_active"][c] = False
        a["alive"][c] = True
        a["divide_pending"][c] = False
        a["smt_head_space"][c, 0] = 0
        a["smt_head_pos"][c, 0, 0] = 4
        a["tape"][c, 4:6] = [OP[name], OP["Val-Inc"]]
        a["smt_stacks"][c, 0, 1] = I32_MIN
        a["smt_stacks"][c, 0, 2] = -1 if c < 2 else 0
    return a


@pytest.mark.parametrize("virulence", [-1, 0.0, 0.8])
def test_micro_step_smt_equals_reference(virulence):
    """Three consecutive cycles on the random state: every field equal
    after each; INT_MIN // -1 and INT_MIN % -1 land on the stack."""
    rp, tp = _both_params(PARASITE_VIRULENCE=virulence)
    arrays = _random_arrays(tp, 11)
    rng = np.random.default_rng(2)
    masks = [rng.random(N) < 0.85 for _ in range(3)]
    for m in masks:
        m[:4] = True
    st = _cycles(rp, tp, arrays, masks)[0]
    tops = np.asarray(st.smt_stacks)[:4, 0, 1]
    sps = np.asarray(st.smt_sp)[:4, 0, 1]
    top = tops[np.arange(4), sps]
    assert top[0] == I32_MIN and top[1] == 0       # pushed onto BX
    assert top[2] == top[3] == I32_MIN             # b == 0: no push
    threads = np.asarray(st.parasite_active) & np.asarray(masks[0])
    assert threads.sum() > 5


def _case_arrays(tp):
    """Organisms set up one case each (see the row comments); the hosts
    carry no parasite and the parasite cases run their parasite thread
    (PARASITE_VIRULENCE 1.0)."""
    R = tp.num_reactions
    a = convert.state_to_arrays(tstate.zeros_population(N, L, R, smt=True))
    rng = np.random.default_rng(4)
    filler = OP["Val-Inc"]
    a["tape"][:] = filler
    a["smt_aux"][:] = filler
    a["pmem"][:] = filler
    a["alive"][:] = True
    a["mem_len"][:] = 100
    a["genome_len"][:] = 100
    a["smt_aux_len"][:] = 20
    a["pmem_len"][:] = 80
    a["smt_head_space"][:, 1] = 2
    a["max_executed"][:] = 2**30
    a["cur_bonus"][:] = 1.0
    a["inputs"][:] = rng.integers(1, 2**24, (N, 3)).astype(np.int32)
    a["smt_head_pos"][:, :, 0] = 10       # IP of both threads at 10

    def at(c, names, space=0, pos=10):
        row = [OP[x] if isinstance(x, str) else x for x in names]
        plane = {0: a["tape"][c], 1: a["smt_aux"][c, 0], 2: a["pmem"][c],
                 3: a["smt_aux"][c, 1]}[space]
        plane[pos:pos + len(row)] = row

    def head(c, h, space, pos, thread=0):
        a["smt_head_space"][c, thread, h] = space
        a["smt_head_pos"][c, thread, h] = pos

    # 0: Search, label A B; the complement C D at 40 -> hit
    at(0, ["Search", "Nop-A", "Nop-B"])
    at(0, ["Nop-C", "Nop-D"], pos=40)
    # 1: Search, label A; its complement C only before IP -> hit (wraps)
    head(1, 0, 0, 50)
    at(1, ["Search", "Nop-A"], pos=50)
    at(1, ["Nop-C"], pos=5)
    # 2: a label absent from the tape -> miss; 3: no label -> miss
    at(2, ["Search", "Nop-B", "Nop-A", "Nop-D"])
    at(3, ["Search"])
    # 4: SetMemory with a label -> FLOW (1, 0); 5: without -> (0, 0)
    at(4, ["SetMemory", "Nop-A"])
    at(5, ["SetMemory"])
    # 6: Inst-Write at the write buffer's last site -> the buffer grows;
    # 7: inside it -> no growth; 8: a full buffer at L -> no growth
    for c, pos, size in ((6, 19, 20), (7, 5, 20), (8, L - 1, L)):
        at(c, ["Inst-Write"])
        head(c, 2, 1, pos)
        a["smt_aux_len"][c, 0] = size
        a["smt_stacks"][c, 0, 0, 0] = OP["Nop-B"]
    # 9: Inject with 8 sites written; 10: 7 sites; 11: one pending
    for c, pos in ((9, 8), (10, 7), (11, 9)):
        at(c, ["Inject"])
        head(c, 2, 1, pos)
    a["inject_pending"][11] = True
    # 12-17: Divide at the size limits of a 33-site parent under
    # OFFSPRING_SIZE_RANGE 1.1: the reference's compiled 33 / 1.1f is
    # 33 * f32(1 / 1.1f) = 29.999998 -> 29 (33 / 1.1f would be 30.0),
    # 33 * 1.1f = 36.3 -> 36; 16 writes in the genome; 17 already
    # pending
    for c, child, space in ((12, 29, 1), (13, 28, 1), (14, 36, 1),
                            (15, 37, 1), (16, 30, 0), (17, 30, 1)):
        at(c, ["Divide"])
        a["mem_len"][c] = 33
        head(c, 2, space, child)
    a["divide_pending"][17] = True
    # 18-21: INT_MIN // -1, INT_MIN % -1, INT_MIN // 0, INT_MAX * 2
    for c, name, b in ((18, "Val-Div", -1), (19, "Val-Mod", -1),
                       (20, "Val-Div", 0), (21, "Val-Mult", 2)):
        at(c, [name])
        a["smt_stacks"][c, 0, 1] = I32_MIN if c < 21 else I32_MAX
        a["smt_stacks"][c, 0, 2] = b
    # 22: Head-Pop of a negative value into READ (?BX? by its nop), then
    # an Inst-Read through it; 23: IO of a NOT result
    at(22, ["Head-Pop", "Nop-B", "Inst-Read"])
    a["smt_stacks"][22, 0, 1] = -7
    at(23, ["IO"])
    x = int(a["inputs"][23, 0])
    a["input_buf"][23, 0] = x
    a["input_buf_n"][23] = 1
    a["smt_stacks"][23, 0, 1] = ~x
    # parasite thread: 30 Inject from its buffer, 31 SetMemory with a
    # label, 32 Divide (host only), 33 IO (no reward), 34 Inst-Read with
    # copy mutations on (host only)
    for c, names in ((30, ["Inject"]), (31, ["SetMemory", "Nop-B"]),
                     (32, ["Divide"]), (33, ["IO"]), (34, ["Inst-Read"])):
        a["parasite_active"][c] = True
        at(c, names, space=2)
        head(c, 2, 3, 9, thread=1)
        head(c, 1, 2, 3, thread=1)
    a["input_buf"][33, 0] = a["inputs"][33, 0]
    a["input_buf_n"][33] = 1
    a["smt_stacks"][33, 1, 1] = ~a["inputs"][33, 0]
    # 35: host Inst-Read from the parasite's code
    at(35, ["Inst-Read"])
    head(35, 1, 2, 6)
    return a


def test_designed_cycles_equal_reference():
    """Two cycles of the designed state: every field equal; each case
    did what it was set up for in the reference."""
    rp, tp = _both_params(PARASITE_VIRULENCE=1.0,
                          OFFSPRING_SIZE_RANGE=1.1, COPY_MUT_PROB=1.0)
    arrays = _case_arrays(tp)
    on = np.ones(N, bool)
    s1, s2 = _cycles(rp, tp, arrays, [on, on])
    pos = np.asarray(s1.smt_head_pos)
    space = np.asarray(s1.smt_head_space)
    sps = np.asarray(s1.smt_sp)
    assert pos[0, 0, 3] == 40 and pos[1, 0, 3] == 5       # Search hits
    assert pos[2, 0, 3] == 11 and pos[3, 0, 3] == 11      # misses: IP + 1
    assert (space[4, 0, 3], space[5, 0, 3]) == (1, 0)     # SetMemory
    alen = np.asarray(s1.smt_aux_len)
    assert list(alen[6:9, 0]) == [21, 20, L]              # Write growth
    inj = np.asarray(s1.inject_pending)
    assert inj[9] and not inj[10] and inj[11]
    assert list(np.asarray(s1.inj_len)[[9, 30]]) == [8, 9]
    div = np.asarray(s1.divide_pending)
    assert list(div[12:17]) == [True, False, True, False, False]
    tops = np.asarray(s1.smt_stacks)[np.arange(18, 22), 0, 1,
                                     sps[18:22, 0, 1]]
    assert list(tops) == [I32_MIN, 0, I32_MIN, -2]
    assert pos[22, 0, 1] == -7 and pos[22, 0, 0] == 12
    assert np.asarray(s2.smt_head_pos)[22, 0, 1] == -6
    rc = np.asarray(s1.cur_reaction_count)
    assert rc[23].sum() == 1 and rc[33].sum() == 0         # host-only IO
    assert space[31, 1, 3] == 3 and not div[32]           # parasite
    assert np.asarray(s1.cur_bonus)[23] == 2.0


def _flush_arrays(tp, divides):
    """After-cycles state for the flush: about half the cells
    parasitized, injections staged in 50 cells (some dead) and, with
    `divides`, divides pending in 12 with offspring in their host write
    buffers."""
    rng = np.random.default_rng(8)
    a = _random_arrays(tp, 21)
    a["alive"][:] = rng.random(N) < 0.9
    a["parasite_active"][:] = rng.random(N) < 0.5
    a["inject_pending"][:] = False
    a["inject_pending"][rng.choice(N, 50, replace=False)] = True
    a["inj_len"][:] = rng.integers(8, 60, N)
    a["divide_pending"][:] = False
    a["off_len"][:] = 0
    a["genome_len"][:] = 40
    a["mem_len"][:] = 40
    if divides:
        for c in rng.choice(N, 12, replace=False):
            a["divide_pending"][c] = True
            a["off_len"][c] = rng.integers(30, 60)
            a["smt_aux_len"][c, 0] = a["off_len"][c]
    return a


def test_smt_flush_equals_reference():
    """flush_births on TransSMT states: with divides pending (the winning
    parents' write buffers reset, the newborns' SMT fields, then
    flush_injections) and without (flush_injections alone), every field
    equal.  Among the staged injections some share a target (the lowest
    injector wins), some aim at parasitized cells and fail, and every
    staged one of a living injector is consumed."""
    rp, tp = _both_params(PARASITE_VIRULENCE=0.8, DIVIDE_INS_PROB=0.5,
                          DIVIDE_DEL_PROB=0.5)
    key = jax.random.key(17)
    nbr = jnp.asarray(rbirth.neighbor_table(8, 8, 2))
    flush = jax.jit(lambda s, k: rbirth.flush_births(
        rp, s, k, nbr, 7, use_off_tape=True))
    out = {}
    for divides in (True, False):
        arrays = _flush_arrays(tp, divides)
        st_r = flush(_ref_state(arrays), key)
        st_t = tbirth.flush_births(
            tp, convert.state_from_arrays(arrays),
            convert.key_from_data(jax.random.key_data(key)), 7)
        _assert_states_equal(st_r, st_t, divides)
        out[divides] = arrays, st_r
    arrays, st_r = out[True]
    births = np.asarray(st_r.birth_update) == 7
    assert births.sum() > 0
    assert (np.asarray(st_r.smt_head_space)[births][:, 1] == 2).all()
    won = arrays["divide_pending"] & ~np.asarray(st_r.divide_pending)
    assert (np.asarray(st_r.smt_aux_len)[won & ~births, 0] == 1).all()

    # the injections alone, against the reference's own draws
    arrays, st_r = out[False]
    choice = np.asarray(jax.random.randint(jax.random.fold_in(key, 17),
                                           (N,), 0, 8))
    target = np.asarray(nbr)[np.arange(N), choice]
    alive, para = arrays["alive"], arrays["parasite_active"]
    pend = arrays["inject_pending"] & alive
    ok = pend & alive[target] & ~para[target]
    assert (pend & alive[target] & para[target]).any()   # fail: infected
    tgts, counts = np.unique(target[ok], return_counts=True)
    assert (counts > 1).any()                            # shared targets
    pmem = np.asarray(st_r.pmem)
    for t in tgts:
        first = np.flatnonzero(ok & (target == t))[0]
        assert (pmem[t] == arrays["inj_mem"][first]).all()
    assert np.array_equal(np.asarray(st_r.parasite_active),
                          para | np.isin(np.arange(N), tgts))
    pending = np.asarray(st_r.inject_pending)
    assert not pending[pend].any()
    assert np.array_equal(pending[~alive], arrays["inject_pending"][~alive])


def _world_pair(tmp_path, base=VALS, **kw):
    vals = dict(base, **kw)
    cfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        cfg.set(k, v)
    ref = RefWorld(cfg=cfg, data_dir=str(tmp_path / "ref"))
    port = World(cfg=convert.config_from_dict(vals),
                 data_dir=str(tmp_path / "port"), device="cpu")
    return ref, port


def test_inject_parasite_equals_reference(tmp_path):
    """The port's InjectAll state (a dead cell at 5) in both packages,
    then InjectParasite over cell ranges that cover the dead cell and
    infected ones: the same state in both packages."""
    ref, port = _world_pair(tmp_path)
    port.events = []
    port._action_InjectAll([])
    alive = np.ones(N, bool)
    alive[5] = False
    port.state = port.state.replace(alive=torch.from_numpy(alive))
    ref.state = _ref_state(convert.state_to_arrays(port.state))
    for args in (["-", "-", "3", "9"], ["-", "-", "0", "40"], []):
        ref._action_InjectParasite(args)
        port._action_InjectParasite(args)
        _assert_states_equal(ref.state, port.state, args)
    para = port.state.parasite_active.numpy()
    assert para[:40].sum() == 39 and not para[5] and not para[40:].any()
    assert int(port.state.pmem_len[0]) == 100


WORLD = dict(VALS, WORLD_X=8, WORLD_Y=8, RANDOM_SEED=31, AVE_TIME_SLICE=100,
             TPU_MAX_STEPS_PER_UPDATE=100, PARASITE_VIRULENCE=0.8,
             COPY_MUT_PROB=0.0075, TPU_CKPT_FINAL=0)
DATS = ("average", "count", "tasks", "time")
EVOLVE, STOP = 8, 12


def _world_events(sysm):
    ev = ["u begin InjectAll", "u begin InjectParasite - - 0 32"]
    ev += [f"u 0:1:end Print{d.capitalize()}Data" for d in DATS]
    return ev + (["u 0:1:end PrintDominantData"] if sysm else [])


def _assert_same_dats(a, b, sysm):
    names = [f"{d}.dat" for d in DATS] + (["dominant.dat"] if sysm else [])
    for name in names:
        la = open(os.path.join(a, name)).read().splitlines()
        lb = open(os.path.join(b, name)).read().splitlines()
        assert len(la) == len(lb) > STOP, name
        assert la[:1] + la[2:] == lb[:1] + lb[2:], name     # dates differ


@pytest.mark.parametrize("sysm", [0, 1])
def test_world_resumes_reference_generation(tmp_path, sysm):
    """The reference runs an 8x8 host-parasite world (every cell seeded,
    the parasite in half of them) to EVOLVE and writes a generation; the
    port resumes it and both run to STOP, one update at a time: the state
    equal after each, births and infections in the window, and the .dat
    files equal."""
    ck = tmp_path / "ck"
    ref, _ = _world_pair(tmp_path, WORLD, TPU_SYSTEMATICS=sysm,
                         TPU_CKPT_DIR=str(ck))
    ref.events = [parse_event_line(e) for e in _world_events(sysm)]
    for u in range(1, EVOLVE + 1):
        ref.run(max_updates=u)
    ref.save_checkpoint()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    shutil.copytree(ck, tmp_path / "pck")
    port = World(cfg=convert.config_from_dict(dict(
        WORLD, TPU_SYSTEMATICS=sysm, TPU_CKPT_DIR=str(tmp_path / "pck"))),
        data_dir=str(tmp_path / "port"), device="cpu")
    port.events = []
    for e in _world_events(sysm):
        port.add_event(e)
    assert port.resume() == EVOLVE
    _assert_states_equal(ref.state, port.state, EVOLVE)
    tpc.reset_launches()
    births0 = int(ref._total_births)
    infected = 0
    for u in range(EVOLVE + 1, STOP + 1):
        before = np.asarray(ref.state.parasite_active)
        assert ref.run(max_updates=u) == port.run(max_updates=u)
        _assert_states_equal(ref.state, port.state, u)
        infected += int((np.asarray(ref.state.parasite_active)
                         & ~before).sum())
    assert int(ref._total_births) > births0
    assert infected > 0
    assert tpc.LAUNCHES == 0
    _assert_same_dats(tmp_path / "ref", tmp_path / "port", sysm)


def test_deme_world_replicate_equals_reference(tmp_path):
    """Four demes of 16 cells, a host-parasite seeding and a ReplicateDemes
    of every deme at update 2: the replaced demes' SMT threads start
    fresh (head spaces 0 and 2); the state equal after each of three
    updates."""
    ev = ["u begin InjectAll", "u begin InjectParasite - - 0 64",
          "u 2 ReplicateDemes all"]
    ref, port = _world_pair(tmp_path, NUM_DEMES=4, RANDOM_SEED=9,
                            PARASITE_VIRULENCE=0.8)
    ref.events = [parse_event_line(e) for e in ev]
    port.events = []
    for e in ev:
        port.add_event(e)
    cleared = False
    for u in range(1, 4):
        assert ref.run(max_updates=u) == port.run(max_updates=u)
        _assert_states_equal(ref.state, port.state, u)
        cleared = cleared or not port.state.parasite_active.all()
    assert cleared
    space = port.state.smt_head_space.numpy()
    assert set(np.unique(space[:, 1])) <= {2, 3}


@pytest.mark.slow
def test_world_ladder_equals_reference(tmp_path):
    """The 10x10 host-parasite world of the reference's TransSMT tests
    (160 sites, time slices of 100, the parasite in half the cells) with
    systematics on, 40 updates from InjectAll in both packages: the state
    after every update and the .dat files equal; births and infections
    throughout."""
    vals = dict(WORLD, WORLD_X=10, WORLD_Y=10, TPU_SYSTEMATICS=1)
    ev = ["u begin InjectAll", "u begin InjectParasite - - 0 50"] + [
        f"u 0:1:end Print{d.capitalize()}Data" for d in DATS] + [
        "u 0:1:end PrintDominantData"]
    ref, port = _world_pair(tmp_path, vals)
    ref.events = [parse_event_line(e) for e in ev]
    port.events = []
    for e in ev:
        port.add_event(e)
    infected = 0
    for u in range(1, 41):
        before = port.state.parasite_active.clone() if port.state is not None \
            else None
        assert ref.run(max_updates=u) == port.run(max_updates=u)
        _assert_states_equal(ref.state, port.state, u)
        if before is not None:
            infected += int((port.state.parasite_active & ~before).sum())
    assert int(port._total_births) > 0 and infected > 0
    _assert_same_dats(tmp_path / "ref", tmp_path / "port", True)
