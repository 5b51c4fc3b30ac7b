"""ops/tasks.py against the reference's avida_tpu/ops/tasks.py: every
math-family task, the logic-id scan, reaction rewards with fractional
pow / mult / add values, and the float32 exp2 behind the pow bonus
(utils/prng.xla_exp2) against `jnp.exp2`; also the per-row key draws the
micro-step engine uses, against `jax.random`.

Tolerance: exact -- int32 values, bool masks and float32 bit patterns
equal.
"""

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.ops import tasks as rtasks  # noqa: E402

from avida_tpu_torch.ops import tasks as ttasks  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _same(want, got):
    want, got = np.asarray(want), got.numpy()
    return want.dtype == got.dtype and want.shape == got.shape \
        and want.tobytes() == got.tobytes()


def _operands(rng, n):
    """int32 operands: zeros, +-1, small values, the int32 extremes and
    large values whose products overflow."""
    pool = np.array([0, 1, -1, 2, -2, 3, 4, 5, 6, 7, 8, -7, 46341, -46341,
                     65536, I32_MIN, I32_MIN + 1, I32_MAX, 1 << 30,
                     -(1 << 30)], np.int64)
    kind = rng.integers(0, 3, n)
    v = np.where(kind == 0, rng.choice(pool, n),
                 np.where(kind == 1, rng.integers(-300, 300, n),
                          rng.integers(I32_MIN, I32_MAX, n, endpoint=True)))
    return v.astype(np.int32)


@pytest.mark.parametrize("name", sorted(rtasks.MATH_TASKS))
def test_math_performed_equals_reference(name):
    """math_performed on random int32 input buffers: half the outputs are
    the task's own value over some stored inputs (hits), half random."""
    rng = np.random.default_rng(sorted(rtasks.MATH_TASKS).index(name))
    n = 512
    buf = np.stack([_operands(rng, n) for _ in range(3)], axis=1)
    buf_n = rng.integers(0, 4, n).astype(np.int32)
    arity, fn = rtasks.MATH_TASKS[name]
    perm = rng.permuted(np.tile(np.arange(3), (n, 1)), axis=1)
    args = [jnp.asarray(buf[np.arange(n), perm[:, k]]) for k in range(arity)]
    hit_val = np.asarray(jax.jit(fn)(*args)).astype(np.int32)
    out = np.where(rng.random(n) < 0.5, hit_val, _operands(rng, n))
    want = jax.jit(lambda b, bn, o: rtasks.math_performed(name, b, bn, o))(
        buf, buf_n, out)
    got = ttasks.math_performed(name, _t(buf), _t(buf_n), _t(out))
    assert _same(want, got)
    assert np.asarray(want).any()


def test_compute_logic_id_equals_reference():
    rng = np.random.default_rng(3)
    n = 4096
    buf = rng.integers(I32_MIN, I32_MAX, (n, 3), endpoint=True).astype(
        np.int32)
    buf_n = rng.integers(0, 4, n).astype(np.int32)
    # outputs that are logic functions of the inputs, and random ones
    a, b = buf[:, 0], buf[:, 1]
    funcs = [~a, ~(a & b), a & b, a | ~b, a | b, a & ~b, ~(a | b), a ^ b,
             ~(a ^ b)]
    out = np.choose(rng.integers(0, 10, n), funcs + [rng.integers(
        I32_MIN, I32_MAX, n, endpoint=True)]).astype(np.int32)
    want = jax.jit(rtasks.compute_logic_id)(buf, buf_n, out)
    got = ttasks.compute_logic_id(_t(buf), _t(buf_n), _t(out))
    assert _same(want, got)
    assert (np.asarray(want) >= 0).sum() > n // 4


def _env_params(rng, R):
    """A reaction table of R reactions: logic and math tasks, fractional
    pow / mult / add values (half of them mult), requisite windows and
    prior-reaction gates."""
    ptype = np.array([1 if r % 2 else (0, 2)[r // 2 % 2] for r in range(R)])
    value = np.round(rng.uniform(-1.5, 3.5, R), 3)
    value[ptype == 1] = np.abs(value[ptype == 1]) + 0.25
    names = sorted(rtasks.MATH_TASKS)
    math = tuple(names[(7 * r) % len(names)] if r % 4 == 3 else ""
                 for r in range(R))
    mask = rng.random((R, 256)) < 0.5
    req = np.zeros((R, R), bool)
    noreq = np.zeros((R, R), bool)
    req[1, 0] = True
    noreq[4, 3] = True
    return SimpleNamespace(
        task_logic_mask=tuple(tuple(bool(v) for v in m) for m in mask),
        proc_value=tuple(float(v) for v in value),
        proc_type=tuple(int(v) for v in ptype),
        max_task_count=tuple(int(v) for v in rng.integers(2, 5, R)),
        min_task_count=tuple(int(v) for v in (rng.random(R) < 0.2)),
        req_reaction_mask=tuple(tuple(bool(v) for v in r) for r in req),
        noreq_reaction_mask=tuple(tuple(bool(v) for v in r) for r in noreq),
        proc_res_idx=(-1,) * R, proc_res_spatial=(False,) * R,
        proc_max=tuple(float(v) for v in rng.choice([1.0, 0.5, 2.0], R)),
        proc_frac=(1.0,) * R, proc_depletable=(True,) * R,
        proc_product_idx=(-1,) * R, task_math_name=math, num_reactions=R,
        num_deme_res=0, num_global_res=0, num_spatial_res=0)


def _reactions_case(R, seed):
    rng = np.random.default_rng(seed)
    params = _env_params(rng, R)
    n = 8192
    io = rng.random(n) < 0.8
    buf = rng.integers(-50, 50, (n, 3)).astype(np.int32)
    buf_n = rng.integers(0, 4, n).astype(np.int32)
    out = np.where(rng.random(n) < 0.3, buf[:, 0] + buf[:, 1],
                   rng.integers(-100, 100, n)).astype(np.int32)
    lid = rng.integers(-1, 256, n).astype(np.int32)
    bonus = (rng.random(n) * 6 + 0.25).astype(np.float32)
    tc = rng.integers(0, 2, (n, R)).astype(np.int32)
    rc = rng.integers(0, 2, (n, R)).astype(np.int32)
    args = (io, lid, bonus, tc, rc, buf, buf_n, out)

    def ref(io, lid, bonus, tc, rc, buf, buf_n, out):
        r = rtasks.apply_reactions(
            params, rtasks.env_tables_to_device(params), io, lid, bonus, tc,
            rc, jnp.zeros(0), jnp.zeros((0, n)), input_buf=buf,
            input_buf_n=buf_n, output=out)
        return r[0], r[1], r[2], r[6]

    want = jax.jit(ref)(*args)
    got = ttasks.apply_reactions(
        params, ttasks.env_tables_to_device(params, "cpu"),
        *(_t(a) for a in args))
    # fractional rewards per organism and process type
    rew = np.asarray(want[2]) - rc
    per_type = np.stack([rew[:, [r for r in range(R)
                                 if params.proc_type[r] == typ
                                 and params.proc_value[r] != int(
                                     params.proc_value[r])]].sum(axis=1)
                         for typ in (0, 1, 2)], axis=1)
    return params, want, got, per_type


@pytest.mark.parametrize("R", [9, 10, 11])
def test_apply_reactions_fractional_values_equal_reference(R):
    """Rewards with fractional values: the pow bonus through exp2, the
    products and the sum over the reactions in order, the last multiply
    fused with the add; organisms with three or more fractional mult
    rewards (two or more pow or add rewards) in one cycle show the order."""
    params, want, got, per_type = _reactions_case(R, R)
    assert sum(v != int(v) for v in params.proc_value) >= 6
    for w, g in zip(want, got):
        assert _same(w, g)
    assert (per_type[:, 1] >= 3).any()
    assert (per_type[:, [0, 2]] >= 2).any(axis=0).all()


@pytest.mark.parametrize("R", [14, 19])
def test_apply_reactions_vectorized_order_equal_where_order_cannot_show(R):
    """From 12 reactions on, XLA's CPU backend marks the reductions over
    the reactions reassociable and LLVM vectorizes them, in a schedule
    that depends on R and on the surrounding fusion; the port reduces in
    order.  Every organism with at most two fractional rewards of each
    type in the cycle (where no order can show) is equal; the counts and
    the task-count outputs are equal everywhere."""
    params, want, got, per_type = _reactions_case(R, R)
    for w, g in zip(want[1:], got[1:]):
        assert _same(w, g)
    calm = (per_type <= 2).all(axis=1)
    assert calm.sum() > len(calm) // 2
    b_want = np.asarray(want[0])[calm]
    assert b_want.tobytes() == got[0].numpy()[calm].tobytes()


def test_apply_reactions_refuses_resource_pools():
    params = _env_params(np.random.default_rng(0), 9)
    params.proc_res_idx = (0,) + (-1,) * 8
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 12a"):
        ttasks.apply_reactions(params, None, z > 0, z, z.float(),
                               torch.zeros(4, 9, dtype=torch.int32),
                               torch.zeros(4, 9, dtype=torch.int32),
                               torch.zeros(4, 3, dtype=torch.int32), z, z)


@pytest.mark.parametrize("lo,hi,n", [(-3.0, 6.0, 2001), (-30.0, 30.0, 60001),
                                     (-160.0, 140.0, 30001)])
def test_xla_exp2_equals_jnp_exp2(lo, hi, n):
    """Dense grids, the fractional reaction values of stock environments,
    and the ends where XLA clamps, flushes and overflows."""
    x = np.linspace(lo, hi, n, dtype=np.float32)
    want = jax.jit(jnp.exp2)(x)
    assert _same(want, prng.xla_exp2(_t(x)))


def test_row_key_draws_equal_jax():
    """The per-row key derivations and draws of the micro-step engine."""
    keys = [jax.random.fold_in(jax.random.key(11), w) for w in range(3)]
    raw = np.stack([np.asarray(jax.random.key_data(k)) for k in keys])
    kt = torch.from_numpy(raw.astype(np.int64))
    got = prng.split_rows(kt, 2)
    for w, k in enumerate(keys):
        want = np.stack([np.asarray(jax.random.key_data(s))
                         for s in jax.random.split(k, 2)])
        assert (got[w].numpy() == want).all()
        fw = np.asarray(jax.random.key_data(jax.random.fold_in(k, 0xFA11)))
        assert (prng.fold_in_rows(kt, 0xFA11)[w].numpy() == fw).all()
        fs = prng.fold_in_rows(kt, torch.arange(5))
        for s in range(5):
            want_s = np.asarray(jax.random.key_data(jax.random.fold_in(k, s)))
            assert (fs[w, s].numpy() == want_s).all()
        u = np.asarray(jax.random.uniform(k, (100,)))
        assert _same(u, prng.bits_to_unit(prng.bits_rows(kt, 100)[w]))
        r = np.asarray(jax.random.randint(k, (100,), 0, 26))
        ks = prng.split_rows(kt)[w]
        got_r = prng.randint_from_bits(prng.bits_rows(ks[:1], 100)[0],
                                       prng.bits_rows(ks[1:], 100)[0], 0, 26)
        assert _same(r, got_r)
