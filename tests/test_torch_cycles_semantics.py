"""ops/cycles.py: the cycle kernel's instruction-set semantics beyond the
stock heads set -- instruction costs and first-time costs, execution
failure (prob_fail), addl_time_cost, redundancy-weighted mutation draws,
nops outside opcodes 0-2 and divide-sex -- one launch of the plain
version against the reference's Pallas kernel (interpret mode, one
shard) on the same planes, and the kernel gate against the reference's.

Tolerance: exact -- all four planes byte for byte.
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
from avida_tpu_torch.config import default_instset, load_instset  # noqa: E402
from avida_tpu_torch.config.environment import (  # noqa: E402
    default_logic9_environment as t_env)
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import cycles as tpc  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

VALS = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=5, AVE_TIME_SLICE=30,
            TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1, TPU_USE_PALLAS=1)
CAP = 2**31 - 1
HEADS = list(default_instset().inst_names)
# ten more opcodes, so that opcodes >= 32 exist (the upper first-time-cost
# word)
EXTRA = ["inc", "dec", "push", "pop", "swap", "add", "sub", "nand", "IO",
         "h-copy"]
# the nops moved off opcodes 0-2
REORDERED = (HEADS[3:9] + ["nop-B"] + HEADS[9:14] + ["nop-C"]
             + HEADS[14:21] + ["nop-A"] + HEADS[21:])

# case -> (instruction names, per-opcode columns {column: {opcode: value}},
# config overrides); opcodes are given by name (first match) or index
CASES = {
    "cost": (HEADS, {"cost": {"h-copy": 2, "IO": 3, "nand": 2,
                              "h-search": 2, "if-label": 3,
                              "mov-head": 2}}, {}),
    "ft_cost_lo": (HEADS, {"ft_cost": {"h-alloc": 4, "h-divide": 3,
                                       "inc": 2, "IO": 2, "pop": 5},
                           "cost": {"push": 2}}, {}),
    "ft_cost_hi": (HEADS + EXTRA, {"ft_cost": {26: 3, 31: 2, 32: 4, 35: 6,
                                               "h-copy": 1},
                                   "cost": {33: 2}}, {}),
    "prob_fail": (HEADS, {"prob_fail": {"h-copy": 0.05, "IO": 0.2,
                                        "nand": 0.3, "if-n-equ": 0.5,
                                        "h-search": 0.1}}, {}),
    "addl_time_cost": (HEADS, {"addl_time_cost": {"h-copy": 1, "IO": 3,
                                                  "h-alloc": 5,
                                                  "h-divide": 2}}, {}),
    "weighted": (HEADS, {"redundancy": {"nop-A": 3, "nop-B": 2,
                                        "h-copy": 5, "IO": 0.5}},
                 {"COPY_MUT_PROB": 0.05}),
    "nops": (REORDERED, {}, {"COPY_MUT_PROB": 0.02}),
    "divide_sex": (["divide-sex" if n == "h-divide" else n for n in HEADS],
                   {}, {}),
    "all": (REORDERED + EXTRA[:4] + ["divide-sex"],
            {"cost": {"h-copy": 2, "IO": 2, 27: 3},
             "ft_cost": {"h-alloc": 3, 29: 2, "nand": 1},
             "prob_fail": {"IO": 0.1, "nand": 0.2, 28: 0.3},
             "addl_time_cost": {"h-divide": 2, "IO": 1},
             "redundancy": {"nop-A": 2, "h-copy": 3}},
            {"COPY_MUT_PROB": 0.05}),
}
COLUMNS = ("redundancy", "cost", "ft_cost", "prob_fail", "addl_time_cost")
DEFAULTS = {"redundancy": 1, "cost": 0, "ft_cost": 0, "prob_fail": 0.0,
            "addl_time_cost": 0}


def _instset_file(path, names, cols):
    per_op = [dict(DEFAULTS) for _ in names]
    for col, entries in cols.items():
        for op, v in entries.items():
            per_op[op if isinstance(op, int) else names.index(op)][col] = v
    lines = ["INSTSET heads_case:hw_type=0"]
    for name, vals in zip(names, per_op):
        lines.append(f"INST {name}:" + ":".join(
            f"{c}={vals[c]!r}" for c in COLUMNS))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _both_params(path, vals):
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.load_instset(path), r_env())
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  load_instset(path), t_env())
    return rp, tp


@pytest.fixture(scope="module")
def evolved():
    """A 6x6 stock-heads world run until divides happen in the next
    launch (tests/test_torch_cycles.py's evolved state)."""
    w = World(cfg=convert.config_from_dict(VALS), data_dir=None,
              device="cpu")
    w.events = []
    w.add_event("u begin InjectAll")
    w.run(max_updates=24)
    return w


def _translated_state(w, names, seed):
    """The evolved state with every opcode mapped by name into `names`
    (h-divide -> divide-sex where the set has it), a third of the
    cells reseeded with random programs over the whole set."""
    old = w.instset.inst_names

    def new_op(name):
        if name == "h-divide" and "divide-sex" in names:
            name = "divide-sex"
        return names.index(name)

    perm = np.asarray([new_op(n) for n in old], np.uint8)
    st = w.state
    rng = np.random.default_rng(seed)
    for c in range(2, w.params.num_cells, 3):
        g = rng.integers(0, len(old), rng.integers(30, 90)).astype(np.int8)
        st = tstate.seed_organism(w.params, st, g, prng.key(c), c)
    a = convert.state_to_arrays(st)
    a["tape"] = (a["tape"] & 0xC0) | perm[a["tape"] & 0x3F]
    a["genome"] = perm[a["genome"].astype(np.uint8)].astype(np.int8)
    a["off_tape"] = perm[a["off_tape"]]
    # the random programs draw over the whole new set (opcodes >= 26 too)
    for c in range(2, w.params.num_cells, 3):
        glen = int(a["genome_len"][c])
        g = rng.integers(0, len(names), glen).astype(np.uint8)
        a["tape"][c, :glen] = g
        a["genome"][c, :glen] = g.astype(np.int8)
    return a


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _launch_both(rp, tp, arrays, granted, key):
    rst = rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})
    st = convert.state_from_arrays(arrays)
    quad_r = rpc.pack_state(rp, rst, jnp.asarray(granted), None, 1)
    quad_t = tpc.pack_state(tp, st, torch.from_numpy(granted))
    for a, b in zip(quad_r, quad_t):
        assert _eq(a, b)
    out_r = rpc.run_packed(rp, quad_r, key, CAP)
    B, n_pad, _ = tpc.dims(tp, tp.num_cells, tp.max_memory)
    seeds = tpc.block_seeds(convert.key_from_data(jax.random.key_data(key)),
                            n_pad, B)
    tpc.cycles(tp, quad_t, seeds, CAP, B)
    return out_r, quad_t


@pytest.mark.parametrize("case", sorted(CASES))
def test_launch_equals_reference(evolved, tmp_path, case):
    """One launch over evolved, task-performing and random programs under
    the case's instruction set: all four planes equal the reference's."""
    names, cols, extra = CASES[case]
    path = _instset_file(tmp_path / "instset.cfg", names, cols)
    rp, tp = _both_params(path, dict(VALS, **extra))
    assert tpc.unsupported_reason(tp) is None
    arrays = _translated_state(evolved, names, seed=len(case))
    granted = np.random.default_rng(1).integers(
        10, 60, tp.num_cells).astype(np.int32)
    key = jax.random.fold_in(jax.random.key(11), len(case))
    out_r, out_t = _launch_both(rp, tp, arrays, granted, key)
    for a, b in zip(out_r, out_t):
        assert _eq(a, b)
    iv = out_t[2]
    flags = iv[tpc.IV_FLAGS]
    assert bool(((flags & tpc.FLAG_NEWDIV) != 0).any())     # divides ran
    if "cost" in cols:
        assert bool((iv[tpc.IV_COST_WAIT] != 0).any())
    if "ft_cost" in cols:
        assert bool((iv[tpc.IV_FT_LO] != 0).any())
        if case == "ft_cost_hi":
            assert bool((iv[tpc.IV_FT_HI] != 0).any())
    if "divide-sex" in names:
        assert bool((iv[tpc.IV_OFF_SEX] != 0).any())


def test_divide_size_limit_follows_the_compiled_reciprocal(evolved,
                                                            tmp_path):
    """OFFSPRING_SIZE_RANGE 1.1 on the kernel route: the reference's
    compiled kernel takes 33 / 1.1 as 33 * f32(1 / 1.1f) = 29.999998 -> 29
    (a true float32 division gives 30.0), so every lane's 29-site child
    of a 33-site genome divides, as its 30-site one does; all four planes
    equal the reference's."""
    path = _instset_file(tmp_path / "instset.cfg", HEADS, {})
    rp, tp = _both_params(path, dict(VALS, OFFSPRING_SIZE_RANGE=1.1))
    a = convert.state_to_arrays(evolved.state)
    op = {n: i for i, n in enumerate(HEADS)}
    n = a["tape"].shape[0]
    for c in range(n):
        a["genome_len"][c] = 33
        a["heads"][c] = [10, 30, 0, 3]
        a["mem_len"][c] = 59 + c % 2
        a["tape"][c] = op["nop-A"]
        a["tape"][c, 10] = op["h-divide"]
        a["tape"][c, :30] |= 0x40
        a["tape"][c, 30:60] |= 0x80
    a["divide_pending"][:] = False
    a["mal_active"][:] = True
    a["alive"][:] = True
    out_r, out_t = _launch_both(rp, tp, a, np.full(n, 2, np.int32),
                                jax.random.key(1))
    for x, y in zip(out_r, out_t):
        assert _eq(x, y)
    flags = out_t[2][tpc.IV_FLAGS]            # n lanes and the padding
    assert int(((flags & tpc.FLAG_NEWDIV) != 0).sum()) == n


def test_float32_draw_thresholds(tmp_path):
    """prob_fail and the cumulative mutation weights are compared in
    float32, as the reference does.  Every lane runs h-copy with copy
    mutations certain; h-copy's prob_fail and nop-A's cumulative weight
    are built to round down, in float32, exactly onto a draw of this
    launch, so a float64 comparison would fail that lane's copy (or draw
    nop-A for it) where the reference does not."""
    names = HEADS
    n = 36
    key = jax.random.fold_in(jax.random.key(4), 2)
    seed = int(tpc.kernel_seed(convert.key_from_data(
        jax.random.key_data(key)))[0])

    def draw(tag, lane):
        """The lane's tag draw at cycle 0."""
        return int(tpc._hash24(torch.tensor(seed + lane), 0, tag))

    # float32 spacing is the draws' 2**-24 grid only in [0.5, 1)
    half = 2**23
    fail_lane = next(i for i in range(n) if draw(2, i) >= half)
    h_fail = draw(2, fail_lane)
    inst_lane = next(i for i in range(n) if i != fail_lane
                     and draw(1, i) >= half and draw(2, i) > h_fail)
    h_inst = draw(1, inst_lane)
    pf = (h_fail + 0.4) / 2**24
    t = (h_inst + 0.4) / 2**24
    a = 25 * t / (1 - t)               # nop-A's weight puts cdf[0] at t
    cols = {"prob_fail": {"h-copy": pf}, "redundancy": {"nop-A": a}}
    path = _instset_file(tmp_path / "instset.cfg", names, cols)
    rp, tp = _both_params(path, dict(VALS, COPY_MUT_PROB=1.0))
    copy = names.index("h-copy")
    for thr, h in ((tp.inst_prob_fail[copy], h_fail),
                   (tp.mut_cdf[0], h_inst)):
        assert float(np.float32(thr)) == h / 2**24 < thr
    genome = np.full(60, copy, np.int8)
    st = tstate.init_population(tp, genome, prng.key(0))
    for c in range(n):
        st = tstate.seed_organism(tp, st, genome, prng.key(c), c)
    arrays = convert.state_to_arrays(st)
    granted = np.full(n, 6, np.int32)
    out_r, out_t = _launch_both(rp, tp, arrays, granted, key)
    for a_, b_ in zip(out_r, out_t):
        assert _eq(a_, b_)


def _gate_params(tmp_path, names, vals=None, **replace):
    path = _instset_file(tmp_path / "gate.cfg", names, {})
    rp, tp = _both_params(path, dict(VALS, **(vals or {})))
    return rp.replace(**replace), tp.replace(**replace)


@pytest.mark.parametrize("variant", [
    "heads", "sex", "costs", "threads", "fork", "mating", "energy",
    "by_products", "math", "resources", "hw3"])
def test_gate_equals_reference(tmp_path, variant):
    """unsupported_reason(p) is None exactly when the reference's kernel
    gate (heads hardware and pallas_cycles.eligible) holds."""
    names = HEADS
    rep = {}
    vals = {}
    if variant == "sex":
        names = CASES["divide_sex"][0]
    elif variant == "costs":
        names = CASES["all"][0]
    elif variant == "threads":
        vals = {"MAX_CPU_THREADS": 2}
    elif variant == "fork":
        names = HEADS + ["fork-th"]
    elif variant == "mating":
        names = HEADS + ["set-mating-type-male"]
    elif variant == "energy":
        rep = {"energy_enabled": True}
    elif variant == "by_products":
        rep = {"proc_product_idx": (0,) + (-1,) * 8}
    elif variant == "math":
        rep = {"task_math_name": ("add",) + ("",) * 8}
    elif variant == "resources":
        rep = {"proc_res_idx": (0,) + (-1,) * 8}
    elif variant == "hw3":
        rep = {"hw_type": 3}
    rp, tp = _gate_params(tmp_path, names, vals, **rep)
    want = rp.hw_type == 0 and rpc.eligible(rp)
    assert (tpc.unsupported_reason(tp) is None) == want
    assert want == (variant in ("heads", "sex", "costs"))
