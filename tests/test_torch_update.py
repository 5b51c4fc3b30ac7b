"""The per-update engine's phases against the reference: the lane
permutation (ops/update.perm_phase), one run_cycles launch through a
non-identity permutation (the reference's Pallas kernel in interpret mode
on one shard), the canonical birth flush with its newborn ring
(ops/birth.flush_births) and the point-mutation sweep, on the same
inputs and keys; tests/test_torch_systematics.py holds whole updates.

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
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.ops import birth as rbirth  # noqa: E402
from avida_tpu.ops import interpreter as rinterp  # noqa: E402
from avida_tpu.ops import pallas_cycles as rpc  # noqa: E402
from avida_tpu.ops import scheduler as rsched  # noqa: E402
from avida_tpu.ops import update as rupd  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.config.environment import (  # noqa: E402
    default_logic9_environment as t_env)
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import birth as tbirth  # noqa: E402
from avida_tpu_torch.ops import interpreter as tinterp  # noqa: E402
from avida_tpu_torch.ops import packed_chunk as tpk  # noqa: E402
from avida_tpu_torch.ops import scheduler as tsched  # noqa: E402
from avida_tpu_torch.ops import update as tupd  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

VALS = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=4, AVE_TIME_SLICE=30,
            TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1)
CAP = 2**31 - 1


def _params(vals):
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.default_instset(), r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  default_instset(), t_env())
    return rp, tp


def _ref_state(st):
    return rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v))
        for k, v in convert.state_to_arrays(st).items()})


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _assert_states_equal(st_r, st_t, where=""):
    got = convert.state_to_arrays(st_t)
    for k in rstate.state_field_names():
        a = getattr(st_r, k)
        assert (a is None and got[k] is None) or _eq(a, got[k]), (where, k)


def _key(seed, data):
    k = jax.random.fold_in(jax.random.key(seed), data)
    return k, convert.key_from_data(jax.random.key_data(k))


def _neighbors(p):
    return jnp.asarray(rbirth.neighbor_table(p.world_x, p.world_y,
                                             p.geometry))


@pytest.fixture(scope="module")
def evolved():
    """A 6x6 world with systematics on (the per-update engine), seeded
    everywhere and run until parents divide."""
    w = World(cfg=convert.config_from_dict(VALS), data_dir=None,
              device="cpu")
    w.events = []
    w.add_event("u begin InjectAll")
    w.run(max_updates=12)
    assert w.engine_report()["engine"] == "per-update"
    return w


@pytest.fixture(scope="module")
def pending(evolved):
    """The evolved state one kernel launch later (through the identity
    lanes): parents divide-pending with fresh offspring in off_tape."""
    w = evolved
    rng = np.random.default_rng(1)
    granted = torch.from_numpy(
        rng.integers(20, 90, w.params.num_cells).astype(np.int32))
    _, k = _key(5, 1)
    st = tupd.interpret_phase(w.params, w.state, k, granted, CAP)
    assert int((st.divide_pending & st.alive).sum()) >= 3
    return st


# ---- perm_phase ----

def _tied_granted(rng, n):
    """Granted budgets with heavy ties (a handful of distinct values)."""
    return (rng.integers(0, 4, n) * 10 + (rng.random(n) < 0.1)).astype(
        np.int32)


@pytest.mark.parametrize("k,min_util", [(1, 0.5), (3, 0.3), (3, 0.55),
                                        (3, 0.9)])
def test_perm_phase_equals_reference(k, min_util):
    """Sorted lanes on tied budgets (K = 1) and merit (K = 3), the K-update
    refresh schedule and the early refresh under the utilization floor,
    over six updates on a 16x16 state (one 256-lane block)."""
    vals = dict(VALS, WORLD_X=16, WORLD_Y=16, TPU_LANE_PERM=k,
                TPU_LANE_PERM_MIN_UTIL=min_util)
    rp, tp = _params(vals)
    n = tp.num_cells
    rng = np.random.default_rng(k * 10 + int(min_util * 10))
    st = tstate.init_population(tp, np.arange(40, dtype=np.int8) % 26,
                                prng.key(0))
    alive = rng.random(n) < 0.8
    perm0 = rng.permutation(n).astype(np.int32)
    inv0 = np.argsort(perm0).astype(np.int32)
    st = st.replace(alive=torch.from_numpy(alive),
                    lane_perm=torch.from_numpy(perm0),
                    lane_inv=torch.from_numpy(inv0))
    rst = _ref_state(st)
    refreshed = kept = 0
    for u in range(6):
        g = _tied_granted(rng, n)
        if u == 2:
            g = np.where(np.arange(n) < 4, 500, g).astype(np.int32)
        # fresh merits, so that a refresh shows as a new permutation
        merit = rng.choice([1.0, 2.0, 4.0], n).astype(np.float32)
        st = st.replace(merit=torch.from_numpy(merit))
        rst = rst.replace(merit=jnp.asarray(merit))
        rst = rupd.perm_phase(rp, rst, jnp.asarray(g), u)
        st_new = tupd.perm_phase(tp, st, torch.from_numpy(g), u)
        assert _eq(rst.lane_perm, st_new.lane_perm), u
        assert _eq(rst.lane_inv, st_new.lane_inv), u
        same = torch.equal(st_new.lane_perm, st.lane_perm)
        kept += same
        refreshed += not same
        st = st_new
        p = st.lane_perm.long()
        assert torch.equal(st.lane_inv[p], torch.arange(n, dtype=torch.int32))
    if k > 1:
        assert refreshed >= 2
        if min_util < 0.5:
            assert kept >= 2              # off-schedule updates keep it
    bu_r = rsched.block_utilization(jnp.asarray(g), 64)
    bu_t = tsched.block_utilization(torch.from_numpy(g), 64)
    assert _eq(bu_r, bu_t)


def test_perm_phase_identity_when_packed():
    """No ring (TPU_SYSTEMATICS=0): the packed chunk is active and the
    permutation stays as it is, as in the reference."""
    rp, tp = _params(dict(VALS, TPU_SYSTEMATICS=0))
    st = tstate.init_population(tp, np.arange(40, dtype=np.int8) % 26,
                                prng.key(0))
    assert tpk.active(tp, st)
    g = torch.arange(36, 0, -1, dtype=torch.int32)
    assert tupd.perm_phase(tp, st, g, 0) is st


# ---- run_cycles ----

def test_run_cycles_through_permutation_equals_reference(evolved):
    """One update's cycles on the canonical state with a non-identity lane
    permutation (so each organism draws another lane's random stream):
    every PopulationState field equals pallas_cycles.run_cycles.  A high
    copy-mutation rate makes the streams visible in the tapes."""
    w = evolved
    rp, tp = _params(dict(VALS, COPY_MUT_PROB=0.2))
    assert rpc.kernel_shards(rp) == 1
    rng = np.random.default_rng(2)
    n = tp.num_cells
    granted = _tied_granted(rng, n) + 20
    st = tupd.perm_phase(tp, w.state, torch.from_numpy(granted), 12)
    assert not torch.equal(st.lane_perm, torch.arange(n, dtype=torch.int32))
    rst = _ref_state(st)
    kr, kt = _key(6, 12)
    out_r = rpc.run_cycles(rp, rst, kr, jnp.asarray(granted), CAP)
    out_t = tupd.interpret_phase(tp, st, kt, torch.from_numpy(granted), CAP)
    _assert_states_equal(out_r, out_t)
    assert int(out_t.divide_pending.sum()) > int(st.divide_pending.sum())
    # the permutation matters: identity lanes give another state
    ident = st.replace(lane_perm=torch.arange(n, dtype=torch.int32),
                       lane_inv=torch.arange(n, dtype=torch.int32))
    out_i = tupd.interpret_phase(tp, ident, kt, torch.from_numpy(granted),
                                 CAP)
    assert not torch.equal(out_i.tape, out_t.tape)


def test_pack_with_perm_is_lane_gather(evolved):
    """pack_state with perm puts organism perm[s] in lane s (the
    reference's major-axis gathers) and unpack_state with inv undoes it."""
    from avida_tpu_torch.ops import cycles as tpc
    w = evolved
    rp, tp = _params(VALS)
    n = tp.num_cells
    perm = torch.from_numpy(np.random.default_rng(3).permutation(n)
                            .astype(np.int32))
    inv = torch.argsort(perm).to(torch.int32)
    granted = torch.arange(n, dtype=torch.int32)
    qr = rpc.pack_state(rp, _ref_state(w.state), jnp.asarray(granted.numpy()),
                        jnp.asarray(perm.numpy()), 1)
    qt = tpc.pack_state(tp, w.state, granted, perm)
    for a, b in zip(qr, qt):
        assert _eq(a, b)
    back = tpc.unpack_state(tp, w.state, qt, inv)
    _assert_states_equal(_ref_state(w.state), back)


# ---- the canonical birth flush ----

FLUSH_VARIANTS = {
    "default": {},
    "mutations": dict(DIVIDE_MUT_PROB=0.5, DIV_MUT_PROB=0.05,
                      COPY_INS_PROB=0.02, COPY_DEL_PROB=0.02,
                      DIVIDE_SLIP_PROB=0.5, DEATH_METHOD=2),
    "placement": dict(BIRTH_METHOD=1, ALLOW_PARENT=0, PREFER_EMPTY=0,
                      GENERATION_INC_METHOD=0, DEATH_METHOD=1),
}


@pytest.mark.parametrize("variant", sorted(FLUSH_VARIANTS))
@pytest.mark.parametrize("ring", ["room", "overflow"])
def test_flush_births_equals_reference(pending, variant, ring):
    """Placement, divide mutations, the newborn fields and the ring
    append; "overflow" starts the ring two rows short of its capacity, so
    most of this flush's newborns are dropped but still counted."""
    rp, tp = _params(dict(VALS, **FLUSH_VARIANTS[variant]))
    st = pending
    cap = st.nb_genome.shape[0]
    assert cap == 2 * tp.num_cells == rp.nb_cap
    start = cap - 2 if ring == "overflow" else 5
    st = st.replace(nb_count=torch.tensor(start, dtype=torch.int32))
    rst = _ref_state(st)
    kr, kt = _key(7, 13)
    off_r = rinterp.extract_offspring(rp, rst, jax.random.split(kr, 4)[2],
                                      use_off_tape=True)
    off_t = tinterp.extract_offspring(tp, st, prng.split(kt, 4)[2])
    for a, b in zip(off_r, off_t):
        assert _eq(a, b)
    out_r = rbirth.flush_births(rp, rst, kr, _neighbors(rp), 13,
                                use_off_tape=True)
    out_t = tbirth.flush_births(tp, st, kt, 13)
    _assert_states_equal(out_r, out_t, variant)
    births = int((out_t.birth_update == 13).sum())
    assert births >= 2
    assert int(out_t.nb_count) == start + births
    if ring == "overflow":
        assert int(out_t.nb_count) > cap
    if variant == "mutations":
        born = out_t.birth_update == 13
        assert bool((out_t.genome_len[born] != 100).any())


def test_flush_refuses_unported_branches():
    """Every branch the canonical flush does not run raises by name: a
    BIRTH_METHOD outside 0-11 and the geometries with no table in the
    reference either (GLOBAL 0, PARTIAL 5).  Experimental hardware (ROADMAP
    item 12h) is ported and flushes."""
    for extra, word in ((dict(BIRTH_METHOD=12), "BIRTH_METHOD 12"),
                        (dict(WORLD_GEOMETRY=0), "WORLD_GEOMETRY 0"),
                        (dict(WORLD_GEOMETRY=5), "WORLD_GEOMETRY 5"),
                        ("bm-1", "BIRTH_METHOD -1")):
        neg = extra == "bm-1"
        _, tp = _params(dict(VALS, **({} if neg else extra)))
        st = tstate.init_population(tp, np.arange(40, dtype=np.int8) % 26,
                                    prng.key(0))
        if neg:
            tp = tp.replace(birth_method=-1)
        with pytest.raises(NotImplementedError, match=word):
            tbirth.flush_births(tp, st, prng.key(1), 0)


# ---- the point-mutation sweep ----

def test_point_mutation_sweep_equals_reference(evolved):
    rp, tp = _params(dict(VALS, POINT_MUT_PROB=0.05))
    st = evolved.state
    kr, kt = _key(8, 3)
    out_r = rupd._point_mutation_sweep(rp, _ref_state(st), kr)
    out_t = tupd.point_mutation_sweep(tp, st, kt)
    assert _eq(out_r.tape, out_t.tape)
    assert not torch.equal(out_t.tape, st.tape)


def test_plain_version_keeps_cycle_start_heads(evolved):
    """The deferred-write reach that bounds the reference's row-tile
    traversal is the write head at the cycle's start plus one.  A lane
    copies at the block's second-to-last cycle with its write head at
    byte 127 (reach 128: the tile from word 32 is not traversed), and an
    idle lane's read head sits at byte 140: its pending-write value row
    reads 0, in the plain version as in the reference (the plain version
    once read the advanced head and traversed one tile more)."""
    from avida_tpu_torch.ops import cycles as tpc
    from avida_tpu_torch.world import default_ancestor
    rp, tp = _params(VALS)
    anc = default_ancestor(default_instset())
    assert int(anc[92]) == default_instset().inst_names.index("h-copy")
    n, L = tp.num_cells, tp.max_memory
    tape = evolved.state.tape.clone()
    tape[:2] = 0
    tape[:2, :100] = torch.from_numpy(anc.astype(np.uint8))
    tape[:2, 100:200] = torch.from_numpy(anc.astype(np.uint8))
    heads = evolved.state.heads.clone()
    heads[0] = torch.tensor([92, 10, 127, 0], dtype=torch.int32)
    heads[1] = torch.tensor([0, 140, 0, 0], dtype=torch.int32)
    alive = evolved.state.alive.clone()
    alive[:2] = True
    st = evolved.state.replace(
        tape=tape, heads=heads, alive=alive,
        mem_len=torch.where(torch.arange(n) < 2, 200, evolved.state.mem_len),
        divide_pending=evolved.state.divide_pending & (torch.arange(n) >= 2))
    granted = np.zeros(n, np.int32)
    granted[0] = 1                       # two cycles: 0 runs, 1 is idle
    kr, kt = _key(11, 0)
    quad_r = rpc.pack_state(rp, _ref_state(st), jnp.asarray(granted), None, 1)
    out_r = rpc.run_packed(rp, quad_r, kr, CAP)
    quad_t = tpc.pack_state(tp, st, torch.from_numpy(granted))
    B, n_pad, _ = tpc.dims(tp, n, L)
    tpc.cycles(tp, quad_t, tpc.block_seeds(kt, n_pad, B), CAP, B)
    for a, b in zip(out_r, quad_t):
        assert _eq(a, b)
    assert int(quad_t[2][tpc.IV_PW_POS, 0]) == -1     # the write landed
    assert int(quad_t[2][tpc.IV_HEADS + 2, 0]) == 128
    assert int(quad_t[2][tpc.IV_PW_VAL, 1]) == 0
