"""ops/tasks.py against the reference's avida_tpu/ops/tasks.py: every
math-family task, the logic-id scan, reaction rewards with fractional
pow / mult / add values, and the float32 exp2 behind the pow bonus
(utils/prng.xla_exp2) against `jnp.exp2`; also the per-row key draws the
micro-step engine uses, against `jax.random`.

Tolerance: exact -- int32 values, bool masks and float32 bit patterns
equal.
"""

from types import SimpleNamespace

import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.ops import tasks as rtasks  # noqa: E402

from avida_tpu_torch.ops import tasks as ttasks  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the engine's many tiny operations run
    faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_apply_reactions_draws_resource_pools():
    """A reaction bound to a global pool (ROADMAP.md item 12a, ported):
    apply_reactions draws the pool down and rewards value x the amount
    consumed, as the reference's does, on the _reactions_case inputs."""
    rng = np.random.default_rng(0)
    params = _env_params(rng, 9)
    params.proc_res_idx = (0,) + (-1,) * 8
    params.proc_frac = (0.01,) + (1.0,) * 8
    params.num_global_res = 1
    params.min_task_count = (0,) + params.min_task_count[1:]
    params.proc_res_deme = (False,) * 9
    params.proc_product_spatial = (False,) * 9
    params.proc_conversion = (1.0,) * 9
    n = 512
    io = rng.random(n) < 0.8
    buf = rng.integers(-50, 50, (n, 3)).astype(np.int32)
    buf_n = rng.integers(0, 4, n).astype(np.int32)
    out = rng.integers(-100, 100, n).astype(np.int32)
    lid = rng.integers(-1, 256, n).astype(np.int32)
    bonus = (rng.random(n) * 6 + 0.25).astype(np.float32)
    tc = np.zeros((n, 9), np.int32)
    rc = np.zeros((n, 9), np.int32)
    pool = np.asarray([37.5], np.float32)
    args = (io, lid, bonus, tc, rc, buf, buf_n, out)

    def ref(io, lid, bonus, tc, rc, buf, buf_n, out, pool):
        r = rtasks.apply_reactions(
            params, rtasks.env_tables_to_device(params), io, lid, bonus, tc,
            rc, pool, jnp.zeros((0, n)), input_buf=buf, input_buf_n=buf_n,
            output=out)
        return r[0], r[1], r[2], r[6], r[3]

    want = jax.jit(ref)(*args, pool)
    got = ttasks.apply_reactions(
        params, ttasks.env_tables_to_device(params, "cpu"),
        *(_t(a) for a in args), torch.from_numpy(pool),
        torch.zeros((0, n)))
    for w, g in zip(want, got[:5]):
        assert _same(w, g)
    assert float(got[4][0]) < 37.5 and int(got[2][:, 0].sum()) > 5


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


# ---- the reaction reductions' order inside the micro-step engine ----

def cpu_flags() -> str:
    """This CPU's model and whether it has AVX-512, for the order tests'
    failure messages: the compiled orders were read on an x86-64 CPU
    with AVX-512, and another ISA compiles another order."""
    model, flags = "?", set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name") and model == "?":
                    model = line.split(":", 1)[1].strip()
                elif line.startswith("flags"):
                    flags = set(line.split(":", 1)[1].split())
                    break
    except OSError:
        pass
    avx = sorted(x for x in flags if x.startswith("avx"))
    return f"cpu {model!r}, {' '.join(avx) or 'no avx'}"


_LOGIC3 = ("not", "nand", "and")


def _order_env(R, rng):
    """R reactions: the first three logic tasks (integer pow values and
    logic-9's requisite max_count=1) from R = 4 on, the rest math_1AJ (|x|) rewards with
    fractional values, process types cycling mult / pow / add.  An
    organism that outputs a copy of a positive input collects every
    math reward it is inside the window of at once."""
    lines, ptypes = [], []
    n_logic = 3 if R >= 4 else 0
    for r in range(R):
        if r < n_logic:
            lines.append(f"REACTION L{r} {_LOGIC3[r]} "
                         f"process:value={(1, 1, 2)[r]}.0:type=pow "
                         f"requisite:max_count=1")
            ptypes.append("ipow")
            continue
        t = ("mult", "pow", "add")[r % 3]
        v = {"mult": 1 + rng.uniform(0.001, 0.9),
             "pow": rng.uniform(0.05, 0.95),
             "add": rng.uniform(0.5, 3.0)}[t]
        lines.append(f"REACTION R{r} math_1AJ "
                     f"process:value={float(np.float32(v))!r}:type={t}")
        ptypes.append(t)
    return "\n".join(lines) + "\n", ptypes


def _order_case(tmp_path, R, in_order=False):
    """One cycle of each package's micro-step engine (TPU_USE_PALLAS=2) on
    the same populated 8x8 state: every organism's first instruction is
    IO, outputting a copy of its positive input, and it is inside the
    requisite window of a random 70% of the reactions.  Returns both
    states, the reward counts per organism and type, and the port world's
    params.  in_order=True runs the port with every reduction in order
    (the order before vector_chunks)."""
    from avida_tpu.core.state import PopulationState as RefState
    from avida_tpu.ops import update as rupd
    from avida_tpu.world import World as RefWorld

    from avida_tpu_torch import convert
    from avida_tpu_torch.ops import update as tupd
    from avida_tpu_torch.world import World

    rng = np.random.default_rng(R)
    env, ptypes = _order_env(R, rng)
    (tmp_path / "environment.cfg").write_text(env)
    (tmp_path / "avida.cfg").write_text("")
    ov = [("WORLD_X", 8), ("WORLD_Y", 8), ("TPU_USE_PALLAS", 2),
          ("TPU_SYSTEMATICS", 0), ("TPU_KERNEL_SHARDS", 1),
          ("TPU_COMPILE_CACHE", 0), ("RANDOM_SEED", R)]
    ref = RefWorld(config_dir=str(tmp_path), overrides=ov,
                   data_dir=str(tmp_path / "r"))
    port = World(config_dir=str(tmp_path), overrides=ov,
                 data_dir=str(tmp_path / "p"), device="cpu")
    port.process_events()          # the ancestor, InjectAll-free
    port._action_InjectAll([])
    st = {k: (None if v is None else v.copy())
          for k, v in convert.state_to_arrays(port.state).items()}
    n = st["tape"].shape[0]
    io = port.instset.inst_names.index("IO")
    a = rng.integers(1 << 20, 1 << 30, n).astype(np.int32)
    st["tape"][:, 0] = io
    st["heads"][:] = 0
    st["regs"][:] = a[:, None]
    st["input_buf"][:] = 0
    st["input_buf"][:, 0] = a
    st["input_buf_n"][:] = 1
    window = rng.random((n, R)) < 0.7
    st["cur_task_count"][:] = np.where(window, 0, 2**30)
    st["cur_bonus"][:] = rng.uniform(0.5, 4.0, n).astype(np.float32)
    granted = np.ones(n, np.int32)
    key = jax.random.key(5)
    r_in = RefState(**{k: (None if v is None else jnp.asarray(v))
                       for k, v in st.items()})
    r_out = jax.jit(lambda s, g: rupd.interpret_phase(
        ref.params, s, key, g, jnp.int32(1), 0)[0])(r_in, granted)
    tables = ttasks.env_tables_to_device(port.params, torch.device("cpu"))
    chunks = tables["chunks"]
    if in_order:
        tables["chunks"] = {k: 0 for k in chunks}
    try:
        t_out = tupd.interpret_phase(
            port.params, convert.state_from_arrays(st),
            convert.key_from_data(jax.random.key_data(key)),
            torch.from_numpy(granted), 0, max_k=1)
    finally:
        tables["chunks"] = chunks
    rew = np.asarray(r_out.cur_reaction_count)
    per_type = {t: rew[:, [r for r in range(R) if ptypes[r] == t]].sum(1)
                for t in ("pow", "mult", "add")}
    return r_out, t_out, per_type, port.params


def _assert_order_holds(tmp_path, R):
    from avida_tpu.core.state import state_field_names

    from avida_tpu_torch import convert
    r_out, t_out, per_type, params = _order_case(tmp_path, R)
    got = convert.state_to_arrays(t_out)
    for k in state_field_names():
        if getattr(r_out, k) is None:
            continue
        assert np.asarray(getattr(r_out, k)).tobytes() == got[k].tobytes(), \
            (k, cpu_flags())
    if R >= 12:
        assert all((v >= 3).sum() > 10 for v in per_type.values())
    return params


_ORDER_TIER1 = (12, 16, 17, 19, 24, 32)


@pytest.mark.parametrize("R", _ORDER_TIER1)
def test_engine_reaction_order_equals_reference(tmp_path, R):
    """cur_bonus (and every other field) exact after one engine cycle in
    which organisms collect three or more fractional rewards of each
    process type: the products and the sum over the reactions combine in
    the compiled engine's order (ops/tasks.vector_chunks / vector_fold):
    in order up to 16 reactions (18 for the sum), else 8-lane chunks into
    two accumulators, a lane tree and the rest in order."""
    params = _assert_order_holds(tmp_path, R)
    want = {k: (R // 8 if R >= v else 0)
            for k, v in (("pow", 17), ("mult", 17), ("add", 19))}
    assert ttasks.vector_chunks(params) == want


@pytest.mark.slow
@pytest.mark.parametrize("R", [r for r in range(1, 33)
                               if r not in _ORDER_TIER1])
def test_engine_reaction_order_equals_reference_every_r(tmp_path, R):
    _assert_order_holds(tmp_path, R)


@pytest.mark.parametrize("R", [17, 24, 32])
def test_in_order_reduction_differs_from_engine(tmp_path, R):
    """The fault this order repairs: the same engine cycle with every
    reduction over the reactions in order (the port's previous _fold)
    gives another cur_bonus than the reference's engine for some
    organisms from 17 reactions on."""
    r_out, t_out, _, _ = _order_case(tmp_path, R, in_order=True)
    want = np.asarray(r_out.cur_bonus)
    got = t_out.cur_bonus.numpy()
    assert (want != got).sum() > 0
    assert np.array_equal(np.asarray(r_out.cur_reaction_count),
                          t_out.cur_reaction_count.numpy())


# ---- the same reductions inside micro_step_smt's IO block ----

def _smt_order_case(tmp_path, R):
    """_order_case's cycle on TransSMT hardware: every host's first
    instruction is IO with no modifier after it, outputting the top of
    its BX stack, a copy of its positive input; it is inside the
    requisite window of a random 70% of the reactions.  The reference's
    IO block runs inside micro_step_smt's lax.cond.  Returns both
    states, the reward counts per organism and type, and the port
    world's params."""
    from avida_tpu.core.state import PopulationState as RefState
    from avida_tpu.ops import update as rupd
    from avida_tpu.world import World as RefWorld

    from avida_tpu_torch import convert
    from avida_tpu_torch.config import transsmt_instset
    from avida_tpu_torch.ops import update as tupd
    from avida_tpu_torch.world import World

    rng = np.random.default_rng(R)
    env, ptypes = _order_env(R, rng)
    names = transsmt_instset().inst_names
    (tmp_path / "environment.cfg").write_text(env)
    (tmp_path / "instset-transsmt.cfg").write_text(
        "INSTSET transsmt:hw_type=2\n"
        + "".join(f"INST {nm}\n" for nm in names))
    (tmp_path / "avida.cfg").write_text("INST_SET instset-transsmt.cfg\n")
    ov = [("WORLD_X", 8), ("WORLD_Y", 8), ("TPU_MAX_MEMORY", 160),
          ("TPU_SYSTEMATICS", 0), ("TPU_KERNEL_SHARDS", 1),
          ("TPU_COMPILE_CACHE", 0), ("RANDOM_SEED", R)]
    ref = RefWorld(config_dir=str(tmp_path), overrides=ov,
                   data_dir=str(tmp_path / "r"))
    port = World(config_dir=str(tmp_path), overrides=ov,
                 data_dir=str(tmp_path / "p"), device="cpu")
    assert ref.params.hw_type == port.params.hw_type == 2
    port._action_InjectAll([])
    st = {k: (None if v is None else v.copy())
          for k, v in convert.state_to_arrays(port.state).items()}
    n = st["tape"].shape[0]
    a = rng.integers(1 << 20, 1 << 30, n).astype(np.int32)
    st["tape"][:, 0] = names.index("IO")
    st["tape"][:, 1] = names.index("Val-Inc")
    st["smt_head_pos"][:] = 0
    st["smt_stacks"][:, 0, 1, :] = a[:, None]
    st["input_buf"][:] = 0
    st["input_buf"][:, 0] = a
    st["input_buf_n"][:] = 1
    window = rng.random((n, R)) < 0.7
    st["cur_task_count"][:] = np.where(window, 0, 2**30)
    st["cur_bonus"][:] = rng.uniform(0.5, 4.0, n).astype(np.float32)
    granted = np.ones(n, np.int32)
    key = jax.random.key(5)
    r_in = RefState(**{k: (None if v is None else jnp.asarray(v))
                       for k, v in st.items()})
    r_out = jax.jit(lambda s, g: rupd.interpret_phase(
        ref.params, s, key, g, jnp.int32(1), 0)[0])(r_in, granted)
    def port_cycle():
        return tupd.interpret_phase(
            port.params, convert.state_from_arrays(st),
            convert.key_from_data(jax.random.key_data(key)),
            torch.from_numpy(granted), 0, max_k=1)

    t_out = port_cycle()
    tables = ttasks.env_tables_to_device(port.params, torch.device("cpu"))
    chunks = tables["chunks"]
    tables["chunks"] = {k: 0 for k in chunks}
    try:
        t_in_order = port_cycle()
    finally:
        tables["chunks"] = chunks
    rew = np.asarray(r_out.cur_reaction_count)
    per_type = {t: rew[:, [r for r in range(R) if ptypes[r] == t]].sum(1)
                for t in ("pow", "mult", "add")}
    return r_out, t_out, t_in_order, per_type, port.params


@pytest.mark.parametrize("R", [9, 17, 24, 32])
def test_smt_engine_reaction_order_equals_reference(tmp_path, R):
    """cur_bonus (and every other field) exact after one TransSMT cycle
    in which hosts collect several fractional rewards of each process
    type: the IO block under micro_step_smt's lax.cond combines the
    products and the sum in the order of micro_step's
    (ops/tasks.vector_chunks); from 17 reactions on, a fold in order
    gives another cur_bonus for some hosts."""
    from avida_tpu.core.state import state_field_names

    from avida_tpu_torch import convert
    r_out, t_out, t_in_order, per_type, params = _smt_order_case(tmp_path,
                                                                 R)
    got = convert.state_to_arrays(t_out)
    for k in state_field_names():
        if getattr(r_out, k) is None:
            continue
        assert np.asarray(getattr(r_out, k)).tobytes() == got[k].tobytes(), k
    assert all((v >= 2).sum() > 10 for v in per_type.values())
    want = {k: (R // 8 if R >= v else 0)
            for k, v in (("pow", 17), ("mult", 17), ("add", 19))}
    assert ttasks.vector_chunks(params) == want
    differs = (np.asarray(r_out.cur_bonus) != t_in_order.cur_bonus.numpy())
    assert differs.any() == (R >= 17)


# ---- ROADMAP Queue 3: the order outside the probed families ----

_order_env_windows = _order_env


def _order_env_no_windows(R, rng):
    """_order_env without logic-9's requisite max_count=1 on the three
    logic reactions."""
    env, ptypes = _order_env_windows(R, rng)
    return env.replace(" requisite:max_count=1", ""), ptypes


@pytest.mark.parametrize("R", [17, 19, 22, 23])
def test_engine_reaction_order_without_requisite_windows(tmp_path,
                                                         monkeypatch, R):
    """The first Queue 3 fault (fixed): _order_case's cycle with the logic
    reactions' requisite windows removed.  The compiled engine then keeps
    the products in order to 19 reactions and the sum to 22 (read by
    probing, as the other orders were); every field, cur_bonus included,
    equal to the reference's engine."""
    monkeypatch.setattr(sys.modules[__name__], "_order_env",
                        _order_env_no_windows)
    from avida_tpu_torch import convert
    r_out, t_out, _, params = _order_case(tmp_path, R)
    got = convert.state_to_arrays(t_out)
    for k, v in got.items():
        if v is not None:
            assert np.asarray(getattr(r_out, k)).tobytes() == v.tobytes(), \
                (k, cpu_flags())
    want = {k: (R // 8 if R >= v else 0)
            for k, v in (("pow", 20), ("mult", 20), ("add", 23))}
    assert ttasks.vector_chunks(params) == want
