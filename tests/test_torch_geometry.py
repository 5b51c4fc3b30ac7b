"""Every world geometry the reference builds, in the port: the neighbor
tables (grid, torus, clique, hex, lattice, random connected, scale-free)
against the reference's builder, the tables a World keeps per seed, the
birth flush placing through them, MultiWorld's refusal of members on
different graphs, and a 10x10 hex world against the reference.

Tolerance: exact -- tables equal, every state field byte for byte, the
.dat files equal apart from the header's date line.
"""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu.ops import birth as rbirth  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.ops import birth as tbirth  # noqa: E402

from test_torch_placement import (VALS, assert_states_equal,  # noqa: E402
                                  both_params, pending_arrays, ref_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("geometry", [1, 2, 3, 4, 6, 7, 8])
def test_neighbor_table_equals_reference(geometry, seed):
    """Each geometry's table on a 9x7 world -- width (the largest degree)
    and column order included -- and on a 6x6 scale-free world with
    other SCALE_FREE_* values."""
    a = rbirth.neighbor_table(9, 7, geometry, seed=seed)
    b = tbirth.neighbor_table(9, 7, geometry, seed=seed)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert (a == b).all()
    if geometry == 8:
        kw = dict(seed=seed, scale_free_m=2, scale_free_alpha=1.5,
                  scale_free_zero_appeal=0.25)
        assert (rbirth.neighbor_table(6, 6, 8, **kw)
                == tbirth.neighbor_table(6, 6, 8, **kw)).all()


@pytest.mark.parametrize("geometry", [0, 5])
def test_unbuilt_geometries_raise_as_the_reference(geometry, tmp_path):
    """GLOBAL (0) and PARTIAL (5) have no builder in the reference either:
    both packages raise the same error, the port's World at
    construction."""
    from avida_tpu_torch.world import World
    with pytest.raises(NotImplementedError) as er:
        rbirth.neighbor_table(4, 4, geometry)
    with pytest.raises(NotImplementedError) as et:
        tbirth.neighbor_table(4, 4, geometry)
    assert str(er.value) == str(et.value)
    with pytest.raises(NotImplementedError, match=f"WORLD_GEOMETRY "
                       f"{geometry}"):
        World(cfg=convert.config_from_dict(dict(
            WORLD_X=4, WORLD_Y=4, WORLD_GEOMETRY=geometry)),
            data_dir=str(tmp_path), device="cpu")


def test_world_tables_follow_seed_and_scale_free_settings(tmp_path):
    """A World's table is the reference World's: random geometries drawn
    from max(RANDOM_SEED, 0) and SCALE_FREE_*, so two worlds of one
    shape but different seeds hold different graphs (the cache is keyed
    by them), and MultiWorld refuses such members in the reference's
    words."""
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    from avida_tpu_torch.world import World

    def world(seed, **kw):
        vals = dict(dict(WORLD_X=8, WORLD_Y=6, WORLD_GEOMETRY=7,
                         RANDOM_SEED=seed, TPU_SYSTEMATICS=0), **kw)
        return World(cfg=convert.config_from_dict(vals),
                     data_dir=str(tmp_path / f"w{seed}{len(kw)}"),
                     device="cpu")

    w3, w4 = world(3), world(4)
    assert (w3.neighbors.numpy()
            == rbirth.neighbor_table(8, 6, 7, seed=3)).all()
    assert not torch.equal(w3.neighbors, w4.neighbors)
    assert world(3).neighbors is w3.neighbors
    sf = world(-1, WORLD_GEOMETRY=8, SCALE_FREE_M=2)
    assert (sf.neighbors.numpy() == rbirth.neighbor_table(
        8, 6, 8, seed=0, scale_free_m=2)).all()
    with pytest.raises(ValueError, match="neighbor tables differ"):
        MultiWorld([w3, w4])


@pytest.mark.parametrize("geometry,bm", [(3, 0), (4, 0), (4, 11), (6, 1),
                                         (7, 3), (8, 10)])
def test_flush_on_geometry_equals_reference(geometry, bm):
    """The birth flush through each graph's table (the random ones drawn
    with seed 4), with a BIRTH_METHOD that reads its candidates: every
    field equal, newborns placed."""
    vals = dict(VALS, WORLD_GEOMETRY=geometry, BIRTH_METHOD=bm,
                PREFER_EMPTY=1)
    rp, tp = both_params(vals)
    arrays = pending_arrays(tp, seed=80 + geometry)
    nbr = rbirth.neighbor_table(rp.world_x, rp.world_y, geometry, seed=4)
    kr = jax.random.fold_in(jax.random.key(geometry), 13)
    out_r = rbirth.flush_births(rp, ref_state(arrays), kr,
                                jax.numpy.asarray(nbr), 13,
                                use_off_tape=True)
    out_t = tbirth.flush_births(
        tp, convert.state_from_arrays(arrays),
        convert.key_from_data(jax.random.key_data(kr)), 13,
        torch.from_numpy(nbr))
    assert_states_equal(out_r, out_t, (geometry, bm))
    assert int((out_t.birth_update == 13).sum()) >= 1


DATS = ("average", "count", "tasks", "time")


def test_hex_world_equals_reference(tmp_path):
    """A 10x10 hex world with every cell seeded, on the micro-step engine:
    the state after each of 6 updates and the .dat files equal, with
    births."""
    from test_torch_world import _assert_same_dats, _pair
    vals = dict(WORLD_X=10, WORLD_Y=10, RANDOM_SEED=6, AVE_TIME_SLICE=100,
                TPU_SYSTEMATICS=0, TPU_USE_PALLAS=2, WORLD_GEOMETRY=4)
    events = ["u begin InjectAll"] + [
        f"u 0:1:end Print{d.capitalize()}Data" for d in DATS]
    ref, port = _pair(tmp_path, vals, events)
    for u in range(1, 7):
        assert ref.run(max_updates=u) == port.run(max_updates=u)
        assert_states_equal(ref.state, port.state, u)
    assert int(port._total_births) > 0
    _assert_same_dats(tmp_path)
    assert port.engine_report()["engine"] == "per-update"
