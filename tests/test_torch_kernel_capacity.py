"""The cycle kernel at any tape height and any reaction count
(ops/cycles.py, csrc/cycles.cu): one launch of the plain version against
the reference's Pallas kernel (interpret mode, one shard) past the 1024
sites and 32 reactions the CUDA kernel held before, with rewards and
requisites in the masks' later words; the launch table's mask words; and
the shared-memory plan of every tape height and reaction count the tests
sweep.  The CUDA kernel itself is held to the plain version at these
shapes on the card (chip_smoke.py: capacity_path, geometry, the stacked
launch, capacity_cross_device).

Tolerance: exact -- all four planes byte for byte; the plan's sizes are
integers.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.config.environment import (  # noqa: E402
    load_environment as r_load_environment)
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.ops import pallas_cycles as rpc  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import cycles as tpc  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

CAP = 2**31 - 1
VALS = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=5, AVE_TIME_SLICE=30,
            TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1)
# the reordered logic-77 environment: the 68 logic_3* reactions, then
# logic-9 at reactions 68-76 (NOT 68, NAND 69 with noreaction=NOT, AND 70
# with reaction=NOT), so every requisite sits in the masks' third word
ENV77 = chip_smoke.logic77_env_text(logic9_first=False)
NOT, NAND, AND = 68, 69, 70
# 33 reactions: the first 24 of the 68, then logic-9 (NOT at 24): the
# masks' second word holds one reaction
ENV33 = "".join(ENV77.splitlines(True)[:24] + ENV77.splitlines(True)[68:])
PREP_UPDATES = 12        # the ancestors' first divides fall in the launch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_dir(path, env_text):
    return chip_smoke.math_config_dir(str(path), env_text)


def _state(cdir, L):
    """A 6x6 world at TPU_MAX_MEMORY L run PREP_UPDATES updates from
    InjectAll (its ancestors near their first divide), then every third
    cell reseeded with the NOT/NAND task program or the NOT/AND one, every
    third with a random program of 30-89 instructions: fresh organisms
    whose first IOs are rewarded in the launch."""
    w = World(config_dir=cdir, overrides=list(dict(
        VALS, TPU_MAX_MEMORY=L).items()), data_dir=None, device="cpu")
    w.events = []
    w.add_event("u begin InjectAll")
    w.run(max_updates=PREP_UPDATES)
    names = w.instset.inst_names
    rng = np.random.default_rng(L)
    st = w.state
    for c in range(1, w.params.num_cells, 3):
        prog = chip_smoke.TASK_GENOME if c % 2 else chip_smoke.AND_GENOME
        g = np.asarray([names.index(x) for x in prog], np.int8)
        st = tstate.seed_organism(w.params, st, g, prng.key(c), c)
    for c in range(2, w.params.num_cells, 3):
        g = rng.integers(0, len(names), rng.integers(30, 90)).astype(np.int8)
        st = tstate.seed_organism(w.params, st, g, prng.key(c), c)
    return w.params, convert.state_to_arrays(st)


def _ref_params(cdir, L):
    rcfg = rconfig.AvidaConfig()
    for k, v in dict(VALS, TPU_MAX_MEMORY=L).items():
        rcfg.set(k, v)
    return rstate.make_world_params(
        rcfg, rconfig.default_instset(),
        r_load_environment(f"{cdir}/environment.cfg"))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("L,env", [(2048, ENV77), (1088, ENV33)],
                         ids=["L2048-R77", "L1088-R33"])
def test_launch_past_the_old_capacity_equals_reference(tmp_path, L, env):
    """One launch over divides, task programs and random programs at a
    tape past 1024 sites and more than 32 reactions: all four planes
    equal the reference's, rewards are paid past bit 32, and the
    no-requisite on NOT (NAND) and the requisite on NOT (AND), in a later
    mask word, both decide a reward."""
    cdir = _config_dir(tmp_path / "cfg", env)
    tp, arrays = _state(cdir, L)
    rp = _ref_params(cdir, L)
    R = tp.num_reactions
    assert (rp.num_reactions, tp.max_memory) == (R, L)
    assert tpc.kernel_limit_reason(tp, "cuda") is None
    granted = np.random.default_rng(1).integers(
        10, 60, tp.num_cells).astype(np.int32)
    rst = rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})
    quad_r = rpc.pack_state(rp, rst, jnp.asarray(granted), None, 1)
    quad_t = tpc.pack_state(tp, convert.state_from_arrays(arrays),
                            torch.from_numpy(granted))
    for a, b in zip(quad_r, quad_t):
        assert _eq(a, b)
    before = quad_t[2].clone()
    key = jax.random.key(11)
    out_r = rpc.run_packed(rp, quad_r, key, CAP)
    B, n_pad, _ = tpc.dims(tp, tp.num_cells, tp.max_memory)
    seeds = tpc.block_seeds(convert.key_from_data(jax.random.key_data(key)),
                            n_pad, B)
    tpc.cycles(tp, quad_t, seeds, CAP, B)
    for a, b in zip(out_r, quad_t):
        assert _eq(a, b)
    iv = quad_t[2]
    assert bool(((iv[tpc.IV_FLAGS] & tpc.FLAG_NEWDIV) != 0).any())
    dyn = tpc.layout(tp, L)[3]
    task, reac = (iv[dyn + k * R:dyn + (k + 1) * R]
                  - before[dyn + k * R:dyn + (k + 1) * R] for k in (0, 1))
    not_at = R - 9
    rewarded = set((reac > 0).nonzero()[:, 0].tolist())
    assert {not_at, not_at + 2} <= rewarded    # NOT; AND on its requisite
    assert min(rewarded) >= 32 or L != 2048
    # NAND performed where NOT had been rewarded, and never paid there
    blocked = (task[not_at + 1] > 0) & (iv[dyn + R + not_at] > 0)
    assert bool(blocked.any())
    assert not bool((reac[not_at + 1][blocked] > 0).any())


def test_launch_table_masks_at_77_reactions(tmp_path):
    """_build_tables at R = 77: reaction d of a requisite mask at word
    d // 32, bit d % 32 -- word 0 in the reaction's entry, words 1-2 in
    the block after the entries -- and the nop decode after the padded
    reaction block."""
    cdir = _config_dir(tmp_path / "cfg", ENV77)
    p = World(config_dir=cdir, overrides=list(VALS.items()), data_dir=None,
              device="cpu").params
    R = p.num_reactions
    RW = tpc.mask_words(R)
    assert (R, RW) == (77, 3)
    tab = tpc._build_tables(p).tolist()
    base = tpc.T_REACTIONS * tpc.TAB_INSTS
    more = base + tpc.RX * R

    def words(r, which):
        first = tab[base + tpc.RX * r + 4 + which]
        rest = tab[more + 2 * (RW - 1) * r + which * (RW - 1):][:RW - 1]
        return [first] + rest

    for r in range(R):
        for which, mask in ((0, p.req_reaction_mask[r]),
                            (1, p.noreq_reaction_mask[r])):
            got = words(r, which)
            want = [d for d in range(R) if mask[d]]
            assert [32 * k + b for k in range(RW) for b in range(32)
                    if (got[k] >> b) & 1] == want, (r, which)
    assert words(AND, 0) == [0, 0, 1 << (NOT - 64)]
    assert words(NAND, 1) == [0, 0, 1 << (NOT - 64)]
    assert tpc.reaction_ints(R) == (16 * 77 + 2 * 77 * 2 + 3) & ~3
    assert len(tab) == tpc.nop_decode_at(R) + tpc.TAB_INSTS
    assert (4 * len(tab)) % 16 == 0
    decode = tab[tpc.nop_decode_at(R):]
    assert sorted(v for v in decode if v >= 0) == [0, 1, 2]


def _old_lanes(L, R, B):
    """The CTA width the kernel took before it was sized by R and L (a
    tile of every row, a table with room for 32 reactions): the shapes
    that ran then must keep it."""
    rows = L // 4 + 30 + 2 * (L // 32) + 4 * R
    cands = [c for c in (128, 64, 32) if c <= B and B // c <= 8]
    for c in cands:
        if 2 * (4 * (rows * c + 1112) + 1024) <= 233_472:
            return c
    for c in cands:
        if 4 * (rows * c + 1112) <= 232_448:
            return c
    return None


@pytest.mark.parametrize("B", [128, 256, 512])
@pytest.mark.parametrize("R", [0, 9, 32, 33, 77, 128])
@pytest.mark.parametrize("L", list(range(tpc.CHUNK, 4097, tpc.CHUNK)))
def test_plan_fits_the_card(L, R, B):
    """Every tape height 64..4096 and reaction count: a plan whose CTA
    divides B into at most 8 CTAs (one portable cluster) and fits
    232,448 bytes (two CTAs an SM where it says so); the shapes that ran
    before keep their CTA width with the whole tile staged, and the
    others take the least staging level at which two CTAs share an SM.
    Every level that fits a CTA can be forced."""
    plan = tpc.cta_plan(L, R, B)
    assert plan.C in (32, 64, 128) and B % plan.C == 0 and B // plan.C <= 8
    assert plan.smem_bytes == tpc.plan_smem_bytes(L, R, plan.C, plan.stage)
    assert plan.smem_bytes <= 232_448
    assert plan.per_sm * (plan.smem_bytes + 1024) <= 233_472
    assert plan.rows == tpc.staged_rows(L, R, plan.stage)
    widths = [c for c in (128, 64, 32) if c <= B and B // c <= 8]
    if L <= 1024 and R <= 32:
        assert (plan.C, plan.stage) == (_old_lanes(L, R, B), 0)
    else:
        assert plan.per_sm == 2
        for stage in range(plan.stage):    # no lesser level holds two
            assert all(2 * (tpc.plan_smem_bytes(L, R, c, stage) + 1024)
                       > 233_472 for c in widths)
    for stage in range(4):
        fits = any(tpc.plan_smem_bytes(L, R, c, stage) <= 232_448
                   for c in widths)
        if not fits:
            with pytest.raises(ValueError):
                tpc.cta_plan(L, R, B, _force_stage=stage)
            continue
        forced = tpc.cta_plan(L, R, B, _force_stage=stage)
        assert forced.stage == stage and forced.smem_bytes <= 232_448
        assert forced.per_sm * (forced.smem_bytes + 1024) <= 233_472


def test_65_instructions_refused_as_the_reference_does(tmp_path):
    """A 65-instruction set on TPU_USE_PALLAS=1: the reference refuses it
    when it builds the world (a tape byte keeps 6 opcode bits), before
    any engine runs, and so does this port, in the same words; the
    kernel's own check (kernel_limit_reason) names the reference's limit
    for parameters past it."""
    from avida_tpu.world import World as RefWorld
    names = list(rconfig.default_instset().inst_names)
    names += [names[k % len(names)] for k in range(65 - len(names))]
    cdir = chip_smoke.write_config_dir(
        str(tmp_path / "cfg"), instset="INSTSET heads65:hw_type=0\n" + "".join(
            f"INST {n}\n" for n in names))
    over = list(dict(VALS, TPU_USE_PALLAS=1).items())
    refusal = "packed-tape layout supports <= 64 instructions per set"
    with pytest.raises(ValueError, match=refusal):
        RefWorld(config_dir=cdir, overrides=over, data_dir=None)
    with pytest.raises(ValueError, match=refusal):
        World(config_dir=cdir, overrides=over, data_dir=None, device="cpu")
    p = World(cfg=convert.config_from_dict(VALS), data_dir=None,
              device="cpu").params
    assert tpc.kernel_limit_reason(p, "cuda") is None
    reason = tpc.kernel_limit_reason(p.replace(num_insts=65), "cuda")
    assert "at most 64 instructions" in reason and "pallas_cycles" in reason
