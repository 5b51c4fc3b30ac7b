"""ops/birth.flush_births off the torus fast path: the general placement
through the neighbor table (candidates with padding, ALLOW_PARENT and
PREFER_EMPTY, the empty-first pick, BIRTH_METHOD 0-10, the scatter-min
claim and the by-parent gathers), on grid and torus, against the
reference's flush_births on hand-built states with pending divides and a
live newborn ring; and a World ladder with an instruction set carrying
costs on the packed engine.

Tolerance: exact -- every state field byte for byte, the ring included.
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
from avida_tpu.ops import packed_chunk as rpk  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import (default_instset,  # noqa: E402
                                    heads_sex_instset)
from avida_tpu_torch.config.environment import (  # noqa: E402
    default_logic9_environment as t_env)
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import birth as tbirth  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402

VALS = dict(WORLD_X=7, WORLD_Y=5, RANDOM_SEED=4, TPU_MAX_MEMORY=64,
            TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1)


def both_params(vals, sexual=False):
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    r_set = rconfig.heads_sex_instset() if sexual \
        else rconfig.default_instset()
    t_set = heads_sex_instset() if sexual else default_instset()
    rp = rstate.make_world_params(rcfg, r_set, r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals), t_set,
                                  t_env())
    return rp, tp


def pending_arrays(tp, seed, sexual=False, store=False, nb_start=5,
                   alive_p=0.6, pending_p=0.5):
    """A hand-built population: random occupancy, parents with pending
    offspring of random content in off_tape, random phenotypes, a ring
    holding `nb_start` rows and, optionally, a waiting store entry."""
    n, L = tp.num_cells, tp.max_memory
    ni = tp.num_insts
    st = tstate.init_population(tp, np.arange(30, dtype=np.int8) % ni,
                                prng.key(seed))
    a = convert.state_to_arrays(st)
    rng = np.random.default_rng(seed)

    def put(name, v):
        a[name] = np.asarray(v).astype(a[name].dtype).reshape(a[name].shape)

    def genomes(lens):
        g = rng.integers(0, ni, (n, L))
        return np.where(np.arange(L)[None, :] < lens[:, None], g, 0)

    alive = rng.random(n) < alive_p
    pend = alive & (rng.random(n) < pending_p)
    glen = rng.integers(16, L // 2, n)
    off_len = np.clip(glen + rng.integers(-4, 5, n), 10, L - 4)
    gen = genomes(glen)
    off = genomes(off_len)
    off[::3] = gen[::3]                        # some breed true
    off_len[::3] = glen[::3]
    put("alive", alive)
    put("divide_pending", pend)
    put("off_sex", pend & sexual)
    put("genome", gen)
    put("tape", gen)
    put("genome_len", glen)
    put("mem_len", glen)
    put("off_tape", off)
    put("off_len", np.where(pend, off_len, 0))
    for name, hi in (("time_used", 400), ("gestation_time", 300),
                     ("executed_size", 60), ("child_copied_size", 60),
                     ("generation", 9)):
        put(name, rng.integers(0, hi, n))
    put("time_used", np.where(rng.random(n) < 0.2, 7, a["time_used"]))
    for name, scale in (("merit", 90.0), ("fitness", 0.5),
                        ("last_bonus", 4.0), ("last_merit_base", 80.0)):
        put(name, (rng.random(n) * scale).astype(np.float32))
    put("merit", np.where(rng.random(n) < 0.2, 16.0, a["merit"]))
    put("last_task_count", rng.integers(0, 3, a["last_task_count"].shape))
    put("nb_count", nb_start)
    if store:
        blen = int(rng.integers(16, L // 2))
        put("bc_valid", True)
        put("bc_len", blen)
        put("bc_merit", np.float32(55.5))
        put("bc_mem", np.where(np.arange(L) < blen,
                               rng.integers(0, ni, L), 0))
    return a


def ref_state(arrays):
    return rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})


def assert_states_equal(st_r, st_t, where=""):
    got = convert.state_to_arrays(st_t)
    for k in rstate.state_field_names():
        a = getattr(st_r, k)
        if a is None:
            assert got[k] is None, (where, k)
            continue
        a = np.asarray(a)
        assert a.shape == got[k].shape and a.dtype == got[k].dtype, (where, k)
        assert a.tobytes() == got[k].tobytes(), (where, k)


def flush_both(rp, tp, arrays, seed, update_no=13):
    """The reference's flush and the port's on the same state and key."""
    rst = ref_state(arrays)
    st = convert.state_from_arrays(arrays)
    kr = jax.random.fold_in(jax.random.key(seed), update_no)
    kt = convert.key_from_data(jax.random.key_data(kr))
    nbr = jnp.asarray(rbirth.neighbor_table(rp.world_x, rp.world_y,
                                            rp.geometry))
    out_r = rbirth.flush_births(rp, rst, kr, nbr, update_no,
                                use_off_tape=True)
    out_t = tbirth.flush_births(tp, st, kt, update_no)
    return out_r, out_t


@pytest.mark.parametrize("geometry", [1, 2])
@pytest.mark.parametrize("bm", range(11))
def test_general_placement_equals_reference(bm, geometry):
    """BIRTH_METHOD 0-10 on a bounded grid (padded candidate lists) and a
    torus, with PREFER_EMPTY and ALLOW_PARENT on for even methods and off
    for odd ones: every field equal, newborns placed and recorded."""
    on = int(bm % 2 == 0)
    vals = dict(VALS, BIRTH_METHOD=bm, WORLD_GEOMETRY=geometry,
                PREFER_EMPTY=on, ALLOW_PARENT=on)
    rp, tp = both_params(vals)
    fast = rbirth.local_torus_fast_path(rp, False)
    assert fast == tbirth.local_torus_fast_path(tp, False)
    assert fast == (geometry == 2 and bm <= 3)
    arrays = pending_arrays(tp, seed=bm * 2 + geometry)
    out_r, out_t = flush_both(rp, tp, arrays, seed=bm)
    assert_states_equal(out_r, out_t, (bm, geometry))
    births = int((out_t.birth_update == 13).sum())
    assert births >= 1
    assert int(out_t.nb_count) == 5 + births


@pytest.mark.parametrize("prefer_empty,allow_parent", [(0, 1), (1, 0)])
@pytest.mark.parametrize("bm", [0, 1, 2, 3, 10])
def test_general_placement_flags_on_grid(bm, prefer_empty, allow_parent):
    """The neighbor-table methods with PREFER_EMPTY and ALLOW_PARENT set
    apart, on a dense grid where most candidates are occupied."""
    vals = dict(VALS, BIRTH_METHOD=bm, WORLD_GEOMETRY=1,
                PREFER_EMPTY=prefer_empty, ALLOW_PARENT=allow_parent)
    rp, tp = both_params(vals)
    arrays = pending_arrays(tp, seed=40 + bm, alive_p=0.85)
    out_r, out_t = flush_both(rp, tp, arrays, seed=bm + 50)
    assert_states_equal(out_r, out_t, (bm, prefer_empty, allow_parent))


def test_neighbor_table_on_device_is_cached():
    _, tp = both_params(dict(VALS, WORLD_GEOMETRY=1))
    t1 = tbirth.neighbors_on(tp, "cpu")
    assert tbirth.neighbors_on(tp, "cpu") is t1
    assert (t1.numpy() == rbirth.neighbor_table(7, 5, 1)).all()


def test_costs_world_packed_equals_reference(tmp_path):
    """A World whose instruction-set file carries costs, first-time costs,
    prob_fail, addl_time_cost and unequal redundancies, with nop-A/B/C
    off opcodes 0-2, on the packed engine: states equal at every chunk
    boundary, the four .dat files byte for byte."""
    from test_torch_world import _assert_same_dats, _assert_same_state
    from avida_tpu.world import World as RefWorld
    from avida_tpu_torch.world import World
    cdir = write_costs_config(tmp_path / "cfg")
    vals = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=3, AVE_TIME_SLICE=30,
                TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1,
                TPU_COMPILE_CACHE=0, COPY_MUT_PROB=0.02)
    ref = RefWorld(config_dir=cdir, overrides=list(vals.items()),
                   data_dir=str(tmp_path / "ref"))
    port = World(config_dir=cdir, overrides=list(vals.items()),
                 data_dir=str(tmp_path / "port"), device="cpu")
    assert port.engine_report() == rpk.engine_report(ref.params, False) \
        == {"engine": "packed", "sub_path": "fused", "packed_bits": 0}
    for u in (8, 16, 24):
        assert ref.run(max_updates=u) == port.run(max_updates=u)
        _assert_same_state(ref, port, u)
    _assert_same_dats(tmp_path)
    assert int(port._total_births) == int(ref._total_births) > 0


# the heads opcodes with nop-A/B/C moved off 0-2, every cost column set
COSTS_INSTSET = """INSTSET heads_costs:hw_type=0
INST if-n-equ:cost=2
INST if-less
INST nop-B:redundancy=2
INST if-label:prob_fail=0.05
INST mov-head
INST jmp-head:ft_cost=3
INST get-head
INST set-flow
INST nop-C
INST shift-r
INST shift-l:prob_fail=0.1
INST inc:addl_time_cost=2
INST dec
INST push:cost=3
INST pop:ft_cost=2
INST swap-stk
INST swap
INST nop-A:redundancy=3
INST add
INST sub
INST nand:cost=2:ft_cost=4
INST h-copy:redundancy=4:addl_time_cost=1
INST h-alloc:ft_cost=5
INST h-divide:cost=2:addl_time_cost=3
INST IO:prob_fail=0.02:cost=2
INST h-search:redundancy=0.5
"""


def write_costs_config(cdir):
    """A config dir: avida.cfg naming the costs instset, the default
    events (the ancestor is found by name), a logic-9 environment."""
    cdir.mkdir()
    (cdir / "instset-costs.cfg").write_text(COSTS_INSTSET)
    (cdir / "avida.cfg").write_text("INST_SET instset-costs.cfg\n")
    (cdir / "events.cfg").write_text(
        "u begin InjectAll\n" + "".join(
            f"u 0:8:end Print{d}Data\n"
            for d in ("Average", "Count", "Tasks", "Time")))
    return str(cdir)
