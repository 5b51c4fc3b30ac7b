"""ops/interpreter.py's micro_step (one lockstep CPU cycle of the
micro-step engine) against the reference's avida_tpu/ops/interpreter.py,
cycle by cycle on random states; and the helpers around it
(barrel_shift_left, fetch_opcode, anomaly_masks, the end-of-update
offspring extraction), on the same inputs and keys.

The random states have N = 64 organisms and a 200-site tape: random
tapes, flag bits, heads, registers (int32 extremes included), stacks,
read labels, pending divides and exec masks, with groups of organisms set
up to divide, allocate, search, do IO and copy, under the default,
cost / first-time-cost, prob-fail, heads-sex, weighted-mutation and
combined instruction sets.

Tolerance: exact -- every state field byte for byte.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.ops import interpreter as rinterp  # noqa: E402
from avida_tpu.ops import update as rupd  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import interpreter as tinterp  # noqa: E402
from avida_tpu_torch.ops import update as tupd  # noqa: E402

from test_torch_cycles_semantics import (CASES, HEADS,  # noqa: E402
                                         _both_params, _instset_file)

N, L = 64, 200
VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=5, TPU_MAX_MEMORY=L,
            TPU_SYSTEMATICS=0)
# instruction set -> (names, per-opcode columns, config overrides)
SETS = {
    "default": (HEADS, {}, {}),
    "cost": CASES["cost"],
    "ft_cost_hi": CASES["ft_cost_hi"],
    "prob_fail": CASES["prob_fail"],
    "divide_sex": CASES["divide_sex"],
    "weighted": CASES["weighted"],
    "all": CASES["all"],
}


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _assert_states_equal(st_r, st_t, where=""):
    got = convert.state_to_arrays(st_t)
    for k in rstate.state_field_names():
        a = getattr(st_r, k)
        assert (a is None and got[k] is None) or _eq(a, got[k]), (where, k)


def _ref_state(arrays):
    return rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})


def _random_arrays(tp, names, seed):
    """A random population state (numpy arrays by field name)."""
    rng = np.random.default_rng(seed)
    ni, R = tp.num_insts, tp.num_reactions
    a = convert.state_to_arrays(tstate.zeros_population(
        N, L, R, num_registers=tp.num_registers))
    op = {n: names.index(n) for n in names}
    divide = op.get("h-divide", op.get("divide-sex"))
    nops = [k for k in range(ni) if tp.is_nop[k]]

    def i32(lo, hi, shape):
        return rng.integers(lo, hi, shape, endpoint=True).astype(np.int32)

    ops = rng.integers(0, ni, (N, L))
    ops = np.where(rng.random((N, L)) < 0.3, rng.choice(nops, (N, L)), ops)
    flags = rng.integers(0, 4, (N, L)) << 6
    a["tape"] = (ops | flags).astype(np.uint8)
    a["mem_len"] = np.where(rng.random(N) < 0.1, rng.integers(1, 4, N),
                            rng.integers(20, L + 1, N)).astype(np.int32)
    a["heads"] = i32(-3, L + 3, (N, 4))
    big = i32(-2**31, 2**31 - 1, (N, 3))
    a["regs"] = np.where(rng.random((N, 3)) < 0.5, big,
                         i32(-20, 20, (N, 3)))
    a["regs"][:4] = [[2**31 - 1, 2**31 - 1, -2**31]] * 4
    a["stacks"] = i32(-100, 100, (N, 2, 10))
    a["sp"] = i32(0, 9, (N, 2))
    a["active_stack"] = i32(0, 1, N)
    a["read_label"] = rng.integers(0, 3, (N, 10)).astype(np.int8)
    a["read_label_len"] = i32(0, 10, N)
    a["mal_active"] = rng.random(N) < 0.3
    a["alive"] = rng.random(N) < 0.95
    a["genome_len"] = i32(8, L // 2, N)
    a["inputs"] = i32(-2**31, 2**31 - 1, (N, 3))
    a["input_ptr"] = i32(0, 20, N)
    a["input_buf"] = i32(-2**31, 2**31 - 1, (N, 3))
    a["input_buf_n"] = i32(0, 3, N)
    a["output_buf"] = i32(-1000, 1000, N)
    a["merit"] = (rng.random(N) * 100).astype(np.float32)
    a["cur_bonus"] = (rng.random(N) * 4 + 0.5).astype(np.float32)
    a["cur_task_count"] = i32(0, 2, (N, R))
    a["cur_reaction_count"] = i32(0, 1, (N, R))
    a["task_exe_total"] = i32(0, 5, (N, R))
    a["time_used"] = i32(0, 400, N)
    a["cpu_cycles"] = a["time_used"].copy()
    a["gestation_start"] = (a["time_used"] * rng.random(N)).astype(np.int32)
    a["max_executed"] = np.where(rng.random(N) < 0.2, a["time_used"] + 1,
                                 2**30).astype(np.int32)
    a["copied_size"] = i32(0, L, N)
    a["executed_size"] = i32(0, L, N)
    a["divide_pending"] = rng.random(N) < 0.1
    a["sterile"] = rng.random(N) < 0.05
    a["cost_wait"] = i32(0, 3, N)
    a["ft_paid_lo"] = i32(-2**31, 2**31 - 1, N)
    a["ft_paid_hi"] = i32(-2**31, 2**31 - 1, N)

    # organisms 8-15 are ready to divide: parent [0, 50) executed, child
    # [50, 100) copied, the divide under IP
    for c in range(8, 16):
        a["mem_len"][c] = 100
        a["genome_len"][c] = 50
        a["heads"][c] = [10 + c, 50, 0, 3]
        a["tape"][c, :50] |= 0x40
        a["tape"][c, 50:100] |= 0x80
        a["tape"][c, 10 + c] = divide | 0x40 * (c % 2)
        a["divide_pending"][c] = c == 15
        a["sterile"][c] = c == 14
        a["cost_wait"][c] = 0
    # 16-23 allocate; 24-31 search for a label they carry; 32-39 do IO
    for c in range(16, 24):
        a["mem_len"][c] = 40 + c
        a["heads"][c, 0] = 5
        a["tape"][c, 5] = op["h-alloc"]
        a["mal_active"][c] = c % 4 == 0
    for c in range(24, 32):
        a["heads"][c, 0] = 4
        a["tape"][c, 4] = op["h-search"]
        lab = rng.choice(nops, c % 4 + 1)
        a["tape"][c, 5:5 + len(lab)] = lab
        # the complement a little further on, or (odd organisms) only at
        # the very end of memory, the last start a search may take
        comp = [nops[(tp.nop_mod[k] + 1) % tp.num_nops] for k in lab]
        at = 30
        if c % 2:
            m = int(a["mem_len"][c])
            body = a["tape"][c, 5 + len(lab):m] & 0x3F
            a["tape"][c, 5 + len(lab):m] = np.where(
                np.isin(body, nops), op["inc"], body)
            at = m - len(comp)
        a["tape"][c, at:at + len(comp)] = comp
    for c in range(32, 40):
        a["heads"][c, 0] = 7
        a["tape"][c, 7] = op["IO"]
        a["input_buf_n"][c] = 3
        a["cost_wait"][c] = 0
    return a


def _ref_step(rp):
    return jax.jit(functools.partial(rinterp.micro_step, rp))


@pytest.mark.parametrize("case", sorted(SETS))
def test_micro_step_equals_reference(tmp_path, case):
    """Six consecutive cycles on a random state, each with its own exec
    mask and key: every field equal after every cycle."""
    names, cols, extra = SETS[case]
    path = _instset_file(tmp_path / "instset.cfg", names, cols)
    rp, tp = _both_params(path, dict(dict(VALS, COPY_MUT_PROB=0.05), **extra))
    arrays = _random_arrays(tp, names, sorted(SETS).index(case))
    st_r, st_t = _ref_state(arrays), convert.state_from_arrays(arrays)
    step = _ref_step(rp)
    rng = np.random.default_rng(1)
    base = jax.random.key(3)
    divided = 0
    for c in range(6):
        mask = rng.random(N) < 0.85
        k = jax.random.fold_in(base, c)
        st_r = step(st_r, k, jnp.asarray(mask))
        st_t = tinterp.micro_step(
            tp, st_t, convert.key_from_data(jax.random.key_data(k)),
            torch.from_numpy(mask))
        _assert_states_equal(st_r, st_t, (case, c))
        divided = int(np.asarray(st_r.num_divides).sum())
    assert divided >= 3


def test_micro_step_masked_is_identity(tmp_path):
    """A cycle with no lane in exec_mask changes nothing (the folded
    batch relies on it)."""
    rp, tp = _both_params(_instset_file(tmp_path / "i.cfg", HEADS, {}),
                          dict(VALS, COPY_MUT_PROB=0.05))
    arrays = _random_arrays(tp, HEADS, 9)
    st = convert.state_from_arrays(arrays)
    out = tinterp.micro_step(tp, st, torch.tensor([0, 7]),
                             torch.zeros(N, dtype=torch.bool))
    a, b = convert.state_to_arrays(st), convert.state_to_arrays(out)
    assert all(_eq(a[k], b[k]) for k in a if a[k] is not None)


def test_barrel_shift_left_equals_reference():
    rng = np.random.default_rng(2)
    for width in (1, 7, 64, 200, 384):
        plane = rng.integers(0, 256, (40, width)).astype(np.uint8)
        shift = rng.integers(0, width + 3, 40).astype(np.int32)
        shift[:3] = [0, width - 1, -5]
        want = jax.jit(rinterp.barrel_shift_left, static_argnums=2)(
            plane, shift, width)
        got = tinterp.barrel_shift_left(torch.from_numpy(plane),
                                        torch.from_numpy(shift), width)
        assert _eq(want, got.numpy()), width


@pytest.mark.parametrize("case", ["default", "all"])
def test_fetch_opcode_and_anomaly_masks_equal_reference(tmp_path, case):
    names, cols, extra = SETS[case]
    path = _instset_file(tmp_path / "instset.cfg", names, cols)
    rp, tp = _both_params(path, dict(VALS, **extra))
    arrays = _random_arrays(tp, names, 4)
    arrays["tape"][:5] = 63          # opcodes past the set clip
    arrays["merit"][:3] = [np.nan, -1.0, np.inf]
    st_r, st_t = _ref_state(arrays), convert.state_from_arrays(arrays)
    want = jax.jit(functools.partial(rinterp.fetch_opcode, rp))(st_r)
    assert _eq(want, tinterp.fetch_opcode(tp, st_t).numpy())
    want = jax.jit(functools.partial(rinterp.anomaly_masks, rp))(st_r)
    got = tinterp.anomaly_masks(tp, st_t)
    for w, g in zip(want, got):
        assert _eq(w, g.numpy())
    assert np.asarray(want[0]).any() and np.asarray(want[1]).any()


def test_materialize_offspring_equals_reference(tmp_path):
    """The end-of-update extraction after cycles in which organisms
    divided: off_tape of the new divides only."""
    path = _instset_file(tmp_path / "instset.cfg", HEADS, {})
    rp, tp = _both_params(path, VALS)
    arrays = _random_arrays(tp, HEADS, 6)
    before = arrays["divide_pending"].copy()
    rng = np.random.default_rng(5)
    arrays["off_tape"] = rng.integers(0, 26, (N, L)).astype(np.uint8)
    arrays["off_start"] = rng.integers(0, L, N).astype(np.int32)
    arrays["off_len"] = rng.integers(0, L, N).astype(np.int32)
    arrays["divide_pending"] = before | (rng.random(N) < 0.4)
    st_r, st_t = _ref_state(arrays), convert.state_from_arrays(arrays)
    want = jax.jit(functools.partial(rupd._materialize_offspring, rp))(
        st_r, jnp.asarray(before))
    got = tupd.materialize_offspring(tp, st_t, torch.from_numpy(before))
    _assert_states_equal(want, got)
    assert (arrays["divide_pending"] & ~before).sum() >= 10


def test_divide_size_limit_follows_the_compiled_reciprocal(tmp_path):
    """OFFSPRING_SIZE_RANGE 1.1: the reference's compiled divide check
    takes 33 / 1.1 as 33 * f32(1 / 1.1f) = 29.999998 -> 29 (a true
    float32 division gives 30.0), so a 29-site child of a 33-site genome
    divides; every field equal after the cycle."""
    path = _instset_file(tmp_path / "instset.cfg", HEADS, {})
    rp, tp = _both_params(path, dict(VALS, OFFSPRING_SIZE_RANGE=1.1))
    a = _random_arrays(tp, HEADS, 0)
    for c in range(8, 16):           # children of 29 and 30 sites
        a["genome_len"][c] = 33
        a["heads"][c] = [10 + c, 30, 0, 3]
        a["mem_len"][c] = 59 + c % 2
        a["tape"][c, :30] |= 0x40
        a["tape"][c, 30:60] |= 0x80
        a["divide_pending"][c] = a["sterile"][c] = False
        a["cost_wait"][c] = 0
        a["alive"][c] = True
    mask = np.ones(N, bool)
    k = jax.random.key(3)
    st_r = _ref_step(rp)(_ref_state(a), k, jnp.asarray(mask))
    st_t = tinterp.micro_step(tp, convert.state_from_arrays(a),
                              convert.key_from_data(jax.random.key_data(k)),
                              torch.from_numpy(mask))
    _assert_states_equal(st_r, st_t)
    assert np.asarray(st_r.divide_pending)[8:16].all()
