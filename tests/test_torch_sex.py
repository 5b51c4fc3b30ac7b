"""Sexual reproduction in the port: the birth chamber
(ops/birth.recombine_sexual) and the sexual tail of flush_births against
the reference on hand-built states, and the heads-sex World (BASELINE
config 3: divide-sex, the sexual ancestor, pairing and recombination)
against the reference's World, whose per-update engine runs the Pallas
kernel in interpret mode on one shard.

Tolerance: exact -- every returned array and state field byte for byte,
the .dat files (dominant.dat included) byte-identical apart from the
header's date line.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu.ops import birth as rbirth  # noqa: E402
from avida_tpu.ops import packed_chunk as rpk  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.ops import birth as tbirth  # noqa: E402

from test_torch_placement import (assert_states_equal,  # noqa: E402
                                  both_params, pending_arrays, ref_state)

VALS = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=4, TPU_MAX_MEMORY=64,
            TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _recombine_both(vals, arrays, seed):
    rp, tp = both_params(vals, sexual=True)
    rst = ref_state(arrays)
    st = convert.state_from_arrays(arrays)
    kr = jax.random.fold_in(jax.random.key(seed), 3)
    kt = convert.key_from_data(jax.random.key_data(kr))
    L = tp.max_memory
    cols = np.arange(L)[None, :]
    off = np.where(cols < arrays["off_len"][:, None],
                   arrays["off_tape"].astype(np.int8), 0).astype(np.int8)
    pend = arrays["divide_pending"] & arrays["alive"]
    # jitted, as the reference's update runs it (its float32 merit mix
    # differs from an op-by-op run: the compiled program fuses one
    # product into the add)
    out_r = jax.jit(functools.partial(rbirth.recombine_sexual, rp))(
        rst, kr, jax.numpy.asarray(off),
        jax.numpy.asarray(arrays["off_len"]), jax.numpy.asarray(pend))
    out_t = tbirth.recombine_sexual(tp, st, kt, torch.from_numpy(off),
                                    torch.from_numpy(arrays["off_len"]),
                                    torch.from_numpy(pend))
    return out_r, out_t


def _flat(out):
    *head, store = out
    return list(head) + list(store)


RECOMBINE_CASES = {
    # odd count, empty store: the last sexual row moves into the store
    "odd_into_store": (dict(VALS), dict(store=False), 3),
    # a waiting store entry pairs with the first row: the dual row
    "store_paired": (dict(VALS), dict(store=True), 4),
    "modules": (dict(VALS, MODULE_NUM=4), dict(store=True), 5),
    "recombination_prob": (dict(VALS, RECOMBINATION_PROB=0.5),
                           dict(store=False), 6),
    # offspring of 3 and 39 in a 40-site memory: a short cut leaves a
    # child shorter than 8, and the swap is refused
    "illegal_length": (dict(VALS, TPU_MAX_MEMORY=40), dict(store=True), 7),
}


@pytest.mark.parametrize("case", sorted(RECOMBINE_CASES))
def test_recombine_equals_reference(case):
    """Pairing, the store, the per-pair draws, the crossover and the
    merit mix (float32, with the reference's fused multiply-add) on a
    world of sexual pending rows: every output equal."""
    vals, kw, seed = RECOMBINE_CASES[case]
    _, tp = both_params(vals, sexual=True)
    arrays = pending_arrays(tp, seed, sexual=True, alive_p=0.8,
                            pending_p=0.8, **kw)
    if case == "illegal_length":
        a = arrays
        a["off_len"] = np.where(a["divide_pending"], np.where(
            np.arange(tp.num_cells) % 2 == 0, 3, 39), 0).astype(np.int32)
    if case == "odd_into_store" and arrays["divide_pending"].sum() % 2 == 0:
        arrays["divide_pending"][np.argmax(arrays["divide_pending"])] = False
    out_r, out_t = _recombine_both(vals, arrays, seed)
    for i, (a, b) in enumerate(zip(_flat(out_r), _flat(out_t))):
        assert _eq(a, b), (case, i)
    off_len, child_merit, placeable = out_t[1], out_t[2], out_t[3]
    sexual = torch.from_numpy(arrays["divide_pending"] & arrays["alive"])
    merit = torch.from_numpy(arrays["merit"])
    mixed = sexual & (child_merit != merit)
    if case != "illegal_length":
        assert int(mixed.sum()) >= 4            # recombined pairs
    if case == "odd_into_store":
        assert bool(out_t[-1][3]) and int((sexual & ~placeable).sum()) == 1
    if case in ("store_paired", "modules"):
        assert bool(out_t[4].any())             # the dual row
    if case == "illegal_length":
        # with RECOMBINATION_PROB 1 every paired row recombines unless the
        # swap is illegal: some are refused, some go through
        kept = sexual & ~mixed & (off_len == torch.from_numpy(
            arrays["off_len"]))
        assert int(kept.sum()) >= 1 and int(mixed.sum()) >= 4


def _one_update(vals, arrays):
    """Both Worlds one update on from the same hand-built state (the
    reference's jitted update: kernel in interpret mode, then the flush,
    where the merit mix is compiled as a World compiles it): every field
    equal.  Returns the port's state."""
    from avida_tpu.config import AvidaConfig
    from avida_tpu.world import World as RefWorld
    from avida_tpu_torch.world import World
    cfg = AvidaConfig()
    for k, v in vals.items():
        cfg.set(k, v)
    ref = RefWorld(cfg=cfg)
    port = World(cfg=convert.config_from_dict(vals), device="cpu")
    ref.events, port.events = [], []
    ref.state = ref_state(arrays)
    port.state = convert.state_from_arrays(arrays)
    assert ref.run(max_updates=1) == port.run(max_updates=1)
    assert_states_equal(ref.state, port.state)
    return port.state


@pytest.mark.parametrize("case", ["odd", "dual", "dual_prefer_empty",
                                  "grid_ring_full", "merit_mix"])
def test_sexual_flush_equals_reference(case):
    """flush_births with divide-sex, one update of each World from a
    hand-built state: recombination and the merit mix, the leftover into
    the store, the dual (store-paired) second birth and its ring record,
    the transactional store and the resuming parents."""
    vals = _sex_world_vals(TPU_MAX_MEMORY=64, RANDOM_SEED=4)
    kw = dict(store=case != "odd", alive_p=0.5, pending_p=0.5)
    if case == "dual_prefer_empty":
        vals.update(PREFER_EMPTY=1, BIRTH_METHOD=1)
    if case == "grid_ring_full":
        vals.update(WORLD_GEOMETRY=1, BIRTH_METHOD=2, PREFER_EMPTY=0)
        kw["nb_start"] = 2 * 36 - 3
    if case == "merit_mix":
        # most parents hold sexual offspring: many pairs, many mixes
        vals["TPU_SYSTEMATICS"] = 0
        kw.update(alive_p=0.9, pending_p=0.9)
    rp, tp = both_params(vals, sexual=True)
    assert not rbirth.local_torus_fast_path(rp, True)
    arrays = pending_arrays(tp, seed=11 + len(case), sexual=True, **kw)
    st = _one_update(vals, arrays)
    born = st.birth_update == 0
    assert int(born.sum()) >= 2
    if case == "merit_mix":
        recombined = born & (st.merit != torch.from_numpy(arrays["merit"])[
            st.parent_id.clamp(min=0).long()])
        assert int(recombined.sum()) >= 8
    if case.startswith("dual"):
        # the store child's ring row names cell n-1 as its parent (the
        # reference clips an unclaimed cell's claim), while its
        # parent_id is the dual parent's cell
        n = tp.num_cells
        start = int(arrays["nb_count"])
        rows = slice(start, start + int(born.sum()))
        cells = st.nb_cell[rows].long()
        parents = st.nb_parent[rows]
        odd = parents != st.parent_id[cells]
        assert int(odd.sum()) == 1 and int(parents[odd][0]) == n - 1


def _sex_world_vals(**kw):
    vals = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=3, AVE_TIME_SLICE=30,
                TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1, TPU_COMPILE_CACHE=0,
                INST_SET="heads_sex")
    vals.update(kw)
    return vals


def test_sex_world_run_equals_reference(tmp_path):
    """The heads-sex world at 6x6 with systematics on and every print
    action (dominant.dat included): the sexual ancestor, per-update
    engine, state equal at every chunk boundary, .dat files byte for
    byte; births happen and the store fills."""
    from test_torch_systematics import _run_ladder
    from avida_tpu_torch.world import default_ancestor
    births, port = _run_ladder(tmp_path, _sex_world_vals(), 4,
                               (8, 16, 24, 32))
    names = port.instset.inst_names
    anc = default_ancestor(port.instset)
    assert "divide-sex" in names and "h-divide" not in names
    assert names[anc[-4]] == "divide-sex"
    assert port.engine_report()["fallback_reason"] \
        == "divide-sex instruction set (recombination is canonical)"
    assert births > 0


@pytest.mark.slow
def test_sex_world_run_long(tmp_path):
    """8x8 for 200 updates: generations of recombinants, the 100-update
    prune, the store across chunk boundaries."""
    from test_torch_systematics import _run_ladder
    births, port = _run_ladder(tmp_path, _sex_world_vals(
        WORLD_X=8, WORLD_Y=8, RANDOM_SEED=21), 16, tuple(range(40, 201, 40)))
    assert births > 3 * 64


def test_sex_cli_equals_reference(tmp_path):
    """`python -m avida_tpu_torch -set INST_SET heads_sex` (the built-in
    set, the default events: one sexual ancestor injected, prints every
    100 updates) writes the same .dat files as `python -m avida_tpu -set
    INST_SET heads_sex -set TPU_USE_PALLAS 1`; by update 32 the first
    offspring waited in the store and paired."""
    import contextlib
    import io
    import json
    from avida_tpu.__main__ import main as ref_main
    from avida_tpu_torch.__main__ import main as port_main
    from test_torch_world import _assert_same_dats
    common = ["-s", "9", "-u", "32", "-set", "INST_SET", "heads_sex",
              "-set", "WORLD_X", "4", "-set", "WORLD_Y", "4",
              "-set", "AVE_TIME_SLICE", "30",
              "-set", "TPU_KERNEL_SHARDS", "1",
              "-set", "TPU_COMPILE_CACHE", "0"]
    assert ref_main(common + ["-d", str(tmp_path / "ref"),
                              "-set", "TPU_USE_PALLAS", "1"]) in (0, None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main(common + ["-d", str(tmp_path / "port"),
                                   "--device", "cpu"]) == 0
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rep["engine"]["engine"] == "per-update"
    assert "divide-sex" in rep["engine"]["fallback_reason"]
    assert rep["organisms"] > 1
    _assert_same_dats(tmp_path)


def test_engine_reports_name_the_reference_reasons():
    """The sexual and soup worlds take the per-update engine for the
    reference's reasons; a costs world without systematics stays on the
    packed engine (tests/test_torch_placement.py)."""
    from avida_tpu.config import AvidaConfig
    from avida_tpu.world import World as RefWorld
    from avida_tpu_torch.world import World
    for vals in (_sex_world_vals(TPU_SYSTEMATICS=0),
                 dict(WORLD_X=6, WORLD_Y=6, BIRTH_METHOD=4,
                      WORLD_GEOMETRY=1, TPU_SYSTEMATICS=0,
                      TPU_USE_PALLAS=1)):
        cfg = AvidaConfig()
        for k, v in vals.items():
            cfg.set(k, v)
        want = rpk.engine_report(RefWorld(cfg=cfg).params, False)
        got = World(cfg=convert.config_from_dict(vals),
                    device="cpu").engine_report()
        assert got == want and got["engine"] == "per-update"
